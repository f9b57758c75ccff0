// One side of a hub batch of the condensed build (Algorithm 2 as hub-batched
// masked products), on bit-packed entry stacks, for Hopper; and, after the
// hub loop, the per-(vertex, hub) MR masks of a stack (entry_masks, below).
//
// Replaces no Pallas kernel: the JAX package leaves the condensed build's
// coverage products to XLA (repro/core/dense.py::_hub_batch_step, two
// batched einsums a hub batch). Here one launch does one side of a batch,
// products, masks and the new bits together:
//
//   rows, other: (C, n, W) int32 words, bit j of word w = column 32 w + j
//   reach:       (C, n, n) bytes, read at [c, h, y]
//   for every row (c, y) and hub h = hubs[b], b < B:
//     cov1 = OR_x rows[c, y, x] & other[c, h, x]     (Case-1 coverage, PR1)
//     cov2 = rows[c, y] has bit h                     (direct entry there)
//     cov3 = other[c, h] has bit y                    (the reverse entry)
//     add  = reach[c, h, y] & aid[h] <= aid[y] & !(cov1 | cov2 | cov3)
//   then rows[c, y] gets bit h wherever add holds.
//
// The backward side is (rows, other, reach) = (OUT, IN, R transposed), the
// forward side (IN, OUT, R); the forward launch follows the backward one on
// the stream, so it reads OUT's updated hub rows, as the reference does.
//
// What bounds it: bytes. A launch reads the whole rows stack once (C n W
// words) and does one AND-OR a word and hub: at 8 hubs a batch that is
// below the card's integer rate, so the design keeps the stream at 16-byte
// loads and the ALU and shared-memory work per loaded word small:
//
// * A block owns rows_per_block rows of one c (blockIdx.y) and stages the
//   words of 8 hubs of `other` (a pass) in shared memory; a batch of more
//   than 8 hubs takes several passes over the block's rows.
// * A warp holds 4 rows at once, lane l loading 16-byte chunks l, l + 32,
//   ...; each chunk of a hub row read from shared memory serves the 4 rows,
//   and each (row, hub) pair keeps a 32-bit OR in a register. One vote a
//   pair ends the product, and lane 8 r + b then tests the masks of row r
//   and hub b (its own bit, the hub row's bit, the reach byte, the access
//   ids).
// * A row's new bits wait in shared memory until every pass is done, so
//   each pass reads the row as it was before the batch; only then does the
//   block OR them into its rows (atomicOr: two hubs may share a word). No
//   other block reads or writes those rows during the launch, so the launch
//   has no race. Every word of the stack is read on every launch, whatever
//   it holds.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kHubs = 8;    // hubs a pass
constexpr int kRows = 4;    // rows a warp holds at once: kRows * kHubs = 32
constexpr int kGroup = kWarps * kRows;  // rows a block holds at once
constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxSmem = 232448;
static_assert(kRows * kHubs == 32, "lane 8 r + b tests row r, hub b");

__host__ __device__ inline int cand_words(int B) { return (B + 31) / 32; }

// hub rows [kHubs][W] words, their ids and access ids, then the new bits
// of the block's rows [rows_per_block][cand_words(B)]
__host__ __device__ inline size_t smem_bytes(int B, int W,
                                             int rows_per_block) {
  return (size_t)kHubs * W * 4 + kHubs * 8 + kHubs * 4 +
         (size_t)rows_per_block * cand_words(B) * 4;
}

// three blocks an SM (at most 85 registers a thread): timed on the H100
// against one and two, and against variants that load more of a row at
// once or balance rows over a persistent grid, none faster by over 2 %
__global__ void __launch_bounds__(kThreads, 3)
hub_cover_kernel(uint32_t* __restrict__ rows,
                 const uint32_t* __restrict__ other,
                 const uint8_t* __restrict__ reach,
                 const int64_t* __restrict__ aid,
                 const int64_t* __restrict__ hubs, int B, int n, int W,
                 int rows_per_block) {
  extern __shared__ uint4 smem[];
  const int Q = W / 4;  // 16-byte chunks a row
  uint4* hub_rows = smem;
  long long* hub_aid = reinterpret_cast<long long*>(hub_rows + kHubs * Q);
  int* hub_id = reinterpret_cast<int*>(hub_aid + kHubs);
  uint32_t* cand = reinterpret_cast<uint32_t*>(hub_id + kHubs);
  const int CW = cand_words(B);

  const int64_t plane = (int64_t)blockIdx.y * n;  // row (c, 0)
  uint32_t* rows_c = rows + plane * W;
  const uint32_t* other_c = other + plane * W;
  const uint8_t* reach_c = reach + plane * n;
  const int y0 = blockIdx.x * rows_per_block;
  const int n_rows = min(rows_per_block, n - y0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < rows_per_block * CW; i += kThreads)
    cand[i] = 0;

  for (int p0 = 0; p0 < B; p0 += kHubs) {
    const int nh = min(kHubs, B - p0);
    __syncthreads();  // the previous pass is done with the hub rows
    if (threadIdx.x < kHubs) {
      const int b = threadIdx.x;
      const int h = b < nh ? (int)hubs[p0 + b] : 0;
      hub_id[b] = h;
      hub_aid[b] = aid[h];
    }
    for (int i = threadIdx.x; i < kHubs * Q; i += kThreads) {
      const int b = i / Q;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (b < nh)
        v = __ldg(reinterpret_cast<const uint4*>(
                      other_c + hubs[p0 + b] * W) + (i - b * Q));
      hub_rows[i] = v;
    }
    __syncthreads();

    for (int g = warp * kRows; g < n_rows; g += kGroup) {
      const uint4* rp[kRows];
      bool live[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        live[r] = g + r < n_rows;
        rp[r] = reinterpret_cast<const uint4*>(
            rows_c + (int64_t)(y0 + (live[r] ? g + r : 0)) * W);
      }
      uint32_t acc[kRows][kHubs];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int b = 0; b < kHubs; ++b) acc[r][b] = 0;
      for (int q = lane; q < Q; q += 32) {
        uint4 v[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          v[r] = live[r] ? rp[r][q] : make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int b = 0; b < kHubs; ++b) {
          const uint4 h = hub_rows[b * Q + q];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc[r][b] |= (v[r].x & h.x) | (v[r].y & h.y) | (v[r].z & h.z) |
                         (v[r].w & h.w);
        }
      }
      unsigned cov1 = 0;  // bit 8 r + b: Case-1 coverage of row r by hub b
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int b = 0; b < kHubs; ++b)
          cov1 |= (unsigned)__any_sync(kAll, acc[r][b] != 0)
                  << (r * kHubs + b);

      const int r = lane / kHubs, b = lane % kHubs;
      const int yl = g + r;
      bool add = false;
      if (yl < n_rows && b < nh && !((cov1 >> lane) & 1u)) {
        const int y = y0 + yl, h = hub_id[b];
        const uint32_t* hw = reinterpret_cast<const uint32_t*>(
            hub_rows + b * Q);
        const bool cov2 =
            (rows_c[(int64_t)y * W + (h >> 5)] >> (h & 31)) & 1u;
        const bool cov3 = (hw[y >> 5] >> (y & 31)) & 1u;
        add = !cov2 && !cov3 && hub_aid[b] <= aid[y] &&
              reach_c[(int64_t)h * n + y] != 0;
      }
      const unsigned added = __ballot_sync(kAll, add);
      if (b == 0 && yl < n_rows)
        cand[yl * CW + (p0 >> 5)] |= ((added >> (r * kHubs)) & 0xffu)
                                     << (p0 & 31);
    }
  }
  __syncthreads();  // every pass has read the rows as they were

  for (int i = threadIdx.x; i < n_rows * CW; i += kThreads) {
    unsigned m = cand[i];
    if (!m) continue;
    uint32_t* row = rows_c + (int64_t)(y0 + i / CW) * W;
    const int base = (i % CW) * 32;
    while (m) {
      const int h = (int)hubs[base + __ffs(m) - 1];
      m &= m - 1;
      atomicOr(row + (h >> 5), 1u << (h & 31));
    }
  }
}

// ---------------------------------------------------------------------------
// entry_masks: a packed entry stack's (vertex, hub) pairs, each with its MRs
// as one bit mask, for the download of the build's index.
//
//   words: (C, n, W) int32 words (bit j of word w = column 32 w + j)
//   masks: (n, 32 W, M) int64, M = ceil(C / 64): bit c % 64 of word c / 64
//          of masks[y, x] is bit x of words[c, y]
//
// One torch.nonzero over the masks' non-zero (n, 32 W) plane then yields
// the pairs row by row, hubs ascending, and the host fills each vertex's
// row of the index in one step. Replaces no Pallas kernel: the JAX package
// downloads its float stacks whole and extracts the entries on the host.
//
// What bounds it: bytes, the stack read once (4 C n W) and the masks
// written once (8 M n 32 W), against five shuffle stages a loaded word. A
// block owns one row y and 32 words (1,024 columns) of it. For each chunk
// of 64 MRs it stages the chunk's 64 x 32 words in shared memory (each warp
// load one 128-byte run of one MR's row; a padded row keeps the column
// reads below free of bank conflicts). A warp then takes one word w at a
// time: lane l holds the word of MR l (and of MR 32 + l), and a 32 x 32
// bit transpose across the warp leaves lane j with the MR bits of column
// 32 w + j, which the warp writes as one run of 32 masks.
constexpr int kMaskCols = 32;  // words of a row a block owns

// 32 x 32 bits across a warp: lane i holds row i on entry and column i on
// return (bit j of lane i's word becomes bit i of lane j's).
__device__ inline uint32_t transpose32(uint32_t x, int lane) {
  const uint32_t keep[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu,
                            0x33333333u, 0x55555555u};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int s = 16 >> i;
    const uint32_t m = keep[i];
    const uint32_t o = __shfl_xor_sync(kAll, x, s);
    x = (lane & s) ? (x & ~m) | ((o >> s) & m) : (x & m) | ((o << s) & ~m);
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
entry_masks_kernel(const uint32_t* __restrict__ words,
                   unsigned long long* __restrict__ masks, int C, int n,
                   int W) {
  __shared__ uint32_t tile[64][kMaskCols + 1];
  const int y = blockIdx.x;
  const int w0 = blockIdx.y * kMaskCols;
  const int nw = min(kMaskCols, W - w0);
  const int M = (C + 63) / 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t plane = (int64_t)n * W;  // words of one MR's stack
  const uint32_t* row = words + (int64_t)y * W + w0;
  unsigned long long* out = masks + ((int64_t)y * W + w0) * 32 * M;

  for (int m = 0; m < M; ++m) {
    const int c0 = 64 * m, nc = min(64, C - c0);
    if (m) __syncthreads();  // every warp is done with the last chunk
    for (int i = threadIdx.x; i < 64 * kMaskCols; i += kThreads) {
      const int c = i / kMaskCols, w = i % kMaskCols;
      tile[c][w] = c < nc && w < nw ? row[(c0 + c) * plane + w] : 0u;
    }
    __syncthreads();
    for (int w = warp; w < nw; w += kWarps) {
      const uint32_t lo = transpose32(tile[lane][w], lane);
      const uint32_t hi = nc > 32 ? transpose32(tile[32 + lane][w], lane)
                                  : 0u;
      out[((int64_t)32 * w + lane) * M + m] =
          (unsigned long long)hi << 32 | lo;
    }
  }
}

}  // namespace

// The MR masks of a (C, n, W) int32 entry stack into (n, 32 W, ceil(C / 64))
// int64 masks (see entry_masks_kernel); every mask is written.
extern "C" int rlc_entry_masks(const void* words, void* masks, int C, int n,
                               int W, void* stream) {
  const int tiles = (W + kMaskCols - 1) / kMaskCols;
  if (C < 1 || n < 1 || W < 1 || tiles > 65535)
    return (int)cudaErrorInvalidValue;
  entry_masks_kernel<<<dim3(n, tiles), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(words),
      static_cast<unsigned long long*>(masks), C, n, W);
  return (int)cudaGetLastError();
}

// Dynamic shared memory a block of one launch needs.
extern "C" int rlc_hub_cover_smem_bytes(int B, int W, int rows_per_block) {
  return (int)smem_bytes(B, W, rows_per_block);
}

// One side of hub batch [offset, offset + B) of `order`: rows and other are
// (C, n, W) int32 words (W a multiple of 4, 16-byte aligned), reach (C, n, n)
// bytes read at [c, hub, y], aid (n,) and order (n,) int64. rows_per_block is
// a multiple of 32.
extern "C" int rlc_hub_cover(void* rows, const void* other, const void* reach,
                             const void* aid, const void* order, int offset,
                             int B, int C, int n, int W, int rows_per_block,
                             void* stream) {
  if (B < 1 || C < 1 || n < 1 || W < 1 || W % 4 || 32 * W < n ||
      rows_per_block < kGroup || rows_per_block % kGroup)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(B, W, rows_per_block);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hub_cover_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n + rows_per_block - 1) / rows_per_block, C);
  hub_cover_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<uint32_t*>(rows), static_cast<const uint32_t*>(other),
      static_cast<const uint8_t*>(reach), static_cast<const int64_t*>(aid),
      static_cast<const int64_t*>(order) + offset, B, n, W, rows_per_block);
  return (int)cudaGetLastError();
}
