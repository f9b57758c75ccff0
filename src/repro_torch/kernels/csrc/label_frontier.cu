// One label-guided frontier wave with the bit-packing fused in, for Hopper.
//
// Replaces the Pallas kernel repro/kernels/label_frontier.py::
// frontier_step_many (_frontier_kernel) together with the pack_bits hand-off
// that follows it in the build (repro/build/pallas_backend.py):
//
//   out[r, w] = OR over u with F[r, u] != 0 of A[labels[r], u, w]
//
// F is (R, Vp) float32 0/1. A is the label-sliced adjacency with its rows
// bit-packed, (|L|, Vp, W) int32 words with W = Vp / 32: bit j of word w of
// row u is the edge u -> 32 w + j. The output is (R, W) int32 words in the
// same layout, i.e. pack_bits((F @ A_dense[labels]) > 0).
//
// What bounds it: bytes. The TPU kernel streams the dense f32 slice
// (Vp x Vp x 4 B per row of F) through the MXU; here a wave reads F once
// and then only the packed adjacency rows of the frontier's vertices
// (W x 4 B each), and an OR of words replaces the multiply-add. The reads
// are short and dependent (a row's non-zeros decide which adjacency rows
// to read), so the design is about keeping loads in flight and the card
// full:
//
// * Compaction. Each thread issues its eight 16-byte loads of F at once
//   (8192 columns a pass for 256 threads), turns them into a 32-bit mask,
//   and one block-wide prefix sum of the masks' popcounts gives every
//   thread the place of its column ids in a shared list (their order is
//   free, since OR is commutative). No atomics, one barrier pair a pass.
// * Splitting. A block owns one frontier row and a range of its output
//   words; when R is small the words of a row are split over several
//   blocks (a 2-D grid), so even R = 1 fills the SMs. Each such block
//   compacts the row itself (the row is read again from L2).
// * OR phase. Threads take 16-byte units (4 words) of the block's range
//   and a share of the list, so all 256 threads keep loads in flight
//   whatever the width; the shares are ORed together through shared
//   memory at the end. The accumulator stays in registers across passes.
//
// More entry points share the kernel:
//
// rlc_bitpack_matmul replaces repro/kernels/bitpack.py::bitpack_matmul
// (_bitpack_kernel): out[m, w] = OR over k with a[m, k] > 0 of b[k, w], for
// a (M, K) float32 and b (K, W) int32 words, K and W independent: the wave
// above with a single adjacency, a general K and the reference's > 0 test.
// Bound by bytes as well: a, the output, and the rows of b that a selects.
//
// rlc_frontier_wave_dst is one wave of repro/kernels/label_frontier.py::
// frontier_steps (T chained frontier_step_many waves under lax.scan, row r's
// result landing in row dst[r]). Its input is float32 rows or packed words,
// and it stores row r's words at row dst[r], packed (for the next wave,
// which compacts them with __ffs over their set bits) or unpacked into a
// float32 0/1 row with 16-byte stores (the last wave). So frontiers stay
// packed between waves, and only the call's input and output are float32.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;                     // loads in flight a thread
constexpr int kList = kThreads * 4 * kRounds;  // columns a pass: 8192

enum In { kFloats, kWords };
enum Store { kPacked, kPackedAtDst, kDenseAtDst };

__device__ __forceinline__ int4 bor(int4 a, int4 b) {
  return make_int4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}
__device__ __forceinline__ int bor(int a, int b) { return a | b; }
__device__ __forceinline__ int4 zero(int4) { return make_int4(0, 0, 0, 0); }
__device__ __forceinline__ int zero(int) { return 0; }

template <bool kPositive>
__device__ __forceinline__ unsigned nz(float x) {
  return kPositive ? x > 0.0f : x != 0.0f;
}

// Exclusive block-wide prefix sum of x; *total gets the block's sum. All
// threads call it; sums (kWarps ints of shared memory) may be reused after
// the next __syncthreads.
__device__ __forceinline__ int block_scan(int x, int* sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < kWarps ? sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += y;
    }
    if (lane < kWarps) sums[lane] = v;
  }
  __syncthreads();
  *total = sums[kWarps - 1];
  return (warp ? sums[warp - 1] : 0) + incl - x;
}

// Compacts the selected columns of [c0, c0 + kList) of frontier row r into
// list; returns their number. Float rows: thread t's load k covers columns
// c0 + 4 (k kThreads + t) + [0, 4) (16-byte loads when kVec). Word rows:
// thread t < kList / 128 covers the 4 words at c0 / 32 + 4 t.
template <In kIn, bool kVec, bool kPositive>
__device__ __forceinline__ int compact(const void* F, int r, int K, int W,
                                       int c0, int* list, int* sums) {
  const int tid = threadIdx.x;
  int total;
  if constexpr (kIn == kFloats) {
    const float* f = static_cast<const float*>(F) + (int64_t)r * K;
    float x[4 * kRounds];
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      const int col = c0 + 4 * (k * kThreads + tid);
      if constexpr (kVec) {
        const float4 v = col < K ? __ldg(reinterpret_cast<const float4*>(
                                       f + col))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        x[4 * k] = v.x; x[4 * k + 1] = v.y;
        x[4 * k + 2] = v.z; x[4 * k + 3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          x[4 * k + j] = col + j < K ? __ldg(f + col + j) : 0.0f;
      }
    }
    unsigned bits = 0;
#pragma unroll
    for (int b = 0; b < 4 * kRounds; ++b) bits |= nz<kPositive>(x[b]) << b;
    int off = block_scan(__popc(bits), sums, &total);
    while (bits) {
      const int b = __ffs(bits) - 1;
      bits &= bits - 1;
      list[off++] = c0 + 4 * ((b >> 2) * kThreads + tid) + (b & 3);
    }
  } else {
    const int32_t* f = static_cast<const int32_t*>(F) + (int64_t)r * W;
    const int w0 = c0 / 32 + 4 * tid;
    int4 v = make_int4(0, 0, 0, 0);
    if (tid < kList / 128 && w0 < W)
      v = __ldg(reinterpret_cast<const int4*>(f + w0));
    const unsigned words[4] = {(unsigned)v.x, (unsigned)v.y, (unsigned)v.z,
                               (unsigned)v.w};
    int off = block_scan(__popc(words[0]) + __popc(words[1]) +
                             __popc(words[2]) + __popc(words[3]),
                         sums, &total);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      unsigned bits = words[j];
      while (bits) {
        const int b = __ffs(bits) - 1;
        bits &= bits - 1;
        list[off++] = 32 * (w0 + j) + b;
      }
    }
  }
  __syncthreads();  // the list is complete
  return total;
}

// Block (r, y) writes the output units [y per, (y + 1) per) of row r (a
// unit is 4 words when kVec, else 1). A column u is selected when F[r, u]
// is non-zero, or, with kPositive, greater than zero; it ORs in row u of
// A + labels[r] * label_stride (label_stride = 0 and labels = nullptr: one
// adjacency).
template <In kIn, bool kVec, bool kPositive, Store kStore>
__global__ void __launch_bounds__(kThreads)
frontier_kernel(const void* __restrict__ F, int K,
                const int32_t* __restrict__ A, int64_t label_stride,
                const int32_t* __restrict__ labels,
                const int32_t* __restrict__ dst, void* __restrict__ out,
                int W, int per) {
  using V = typename std::conditional<kVec, int4, int>::type;
  constexpr int kU = kVec ? 4 : 1;  // words a unit
  __shared__ int list[kList];
  __shared__ V part[kThreads];
  __shared__ int sums[kWarps];
  const int tid = threadIdx.x;
  const int r = blockIdx.x;
  const int u0 = blockIdx.y * per;
  const int nu = min(per, W / kU - u0);  // units of this block (<= kThreads)
  const int P = kThreads / nu;           // list shares
  const int p = tid / nu;
  const int unit = u0 + tid % nu;
  const V* a = reinterpret_cast<const V*>(
      A + (labels ? (int64_t)__ldg(labels + r) * label_stride : 0));
  const int UW = W / kU;  // units a row of A

  V acc = zero(V());
  for (int c0 = 0; c0 < K; c0 += kList) {
    const int n = compact<kIn, kVec, kPositive>(F, r, K, W, c0, list, sums);
    if (p < P) {
      // four independent OR chains keep four row loads in flight
      V x0 = zero(V()), x1 = x0, x2 = x0, x3 = x0;
      int i = p;
      for (; i + 3 * P < n; i += 4 * P) {
        x0 = bor(x0, __ldg(a + (int64_t)list[i] * UW + unit));
        x1 = bor(x1, __ldg(a + (int64_t)list[i + P] * UW + unit));
        x2 = bor(x2, __ldg(a + (int64_t)list[i + 2 * P] * UW + unit));
        x3 = bor(x3, __ldg(a + (int64_t)list[i + 3 * P] * UW + unit));
      }
      for (; i < n; i += P) x0 = bor(x0, __ldg(a + (int64_t)list[i] * UW + unit));
      acc = bor(acc, bor(bor(x0, x1), bor(x2, x3)));
    }
    __syncthreads();  // the next pass rewrites the list
  }
  part[tid] = acc;
  __syncthreads();
  if (tid < nu) {  // fold the shares; reads only part[nu:], writes part[tid]
    V v = part[tid];
    for (int q = 1; q < P; ++q) v = bor(v, part[q * nu + tid]);
    if constexpr (kStore == kDenseAtDst) {
      part[tid] = v;
    } else {
      const int row = kStore == kPacked ? r : __ldg(dst + r);
      reinterpret_cast<V*>(static_cast<int32_t*>(out) + (int64_t)row * W)
          [unit] = v;
    }
  }
  if constexpr (kStore == kDenseAtDst) {  // kVec only: a unit is 128 columns
    __syncthreads();
    const int32_t* words = reinterpret_cast<const int32_t*>(part);
    float4* o = reinterpret_cast<float4*>(static_cast<float*>(out) +
                                          (int64_t)__ldg(dst + r) * 32 * W +
                                          128 * u0);
    for (int f = tid; f < 32 * nu; f += kThreads) {
      const unsigned w = words[f >> 3];  // 8 float4 a word
      const int b = 4 * (f & 7);
      o[f] = make_float4((float)((w >> b) & 1), (float)((w >> (b + 1)) & 1),
                         (float)((w >> (b + 2)) & 1),
                         (float)((w >> (b + 3)) & 1));
    }
  }
}

bool aligned(const void* p) { return ((uintptr_t)p & 15) == 0; }

// SMs of the current device, read once per device (a launch may be
// captured into a CUDA graph, where only stream work belongs)
int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 132;
  }
  return counts[dev];
}

// The grid: R rows, each split into S blocks of `per` units. A row is split
// until the grid has two blocks an SM (keeping 4 units or more a block),
// and always so that a block has at most kThreads units.
template <In kIn, bool kVec, bool kPositive, Store kStore>
int launch(const void* F, int R, int K, const void* A, int64_t label_stride,
           const void* labels, const void* dst, void* out, int W,
           void* stream) {
  const int sms = sm_count();
  const int U = W / (kVec ? 4 : 1);
  if (R == 0 || U == 0) return (int)cudaSuccess;
  int S = min((2 * sms + R - 1) / R, (U + 3) / 4);
  S = max(max(S, (U + kThreads - 1) / kThreads), 1);
  const int per = (U + S - 1) / S;
  S = (U + per - 1) / per;
  frontier_kernel<kIn, kVec, kPositive, kStore>
      <<<dim3(R, S), kThreads, 0, (cudaStream_t)stream>>>(
          F, K, (const int32_t*)A, label_stride, (const int32_t*)labels,
          (const int32_t*)dst, out, W, per);
  return (int)cudaGetLastError();
}

}  // namespace

// out (R, W) int32 words: one frontier wave, per-row labels, F (R, Vp).
extern "C" int rlc_frontier_step_many(const void* F, const void* A,
                                      const void* labels, void* out, int R,
                                      int Vp, int W, void* stream) {
  if (W % 4 == 0 && aligned(F) && aligned(A) && aligned(out))
    return launch<kFloats, true, false, kPacked>(
        F, R, Vp, A, (int64_t)Vp * W, labels, nullptr, out, W, stream);
  return launch<kFloats, false, false, kPacked>(
      F, R, Vp, A, (int64_t)Vp * W, labels, nullptr, out, W, stream);
}

// out (M, W) int32 words = OR over k with a[m, k] > 0 of b[k, :].
extern "C" int rlc_bitpack_matmul(const void* a, const void* b, void* out,
                                  int M, int K, int W, void* stream) {
  if (K % 4 == 0 && W % 4 == 0 && aligned(a) && aligned(b) && aligned(out))
    return launch<kFloats, true, true, kPacked>(a, M, K, b, 0, nullptr,
                                                nullptr, out, W, stream);
  return launch<kFloats, false, true, kPacked>(a, M, K, b, 0, nullptr,
                                               nullptr, out, W, stream);
}

// One wave of frontier_steps with row r's result stored at row dst[r]
// (dst a permutation of the R rows). in: (R, Vp) float32 0/1, or (R, W)
// int32 words when in_words; out: (R, W) int32 words, or (R, Vp) float32
// 0/1 when out_dense. W must be a multiple of 4 and the pointers 16-byte
// aligned (cudaErrorInvalidValue otherwise).
extern "C" int rlc_frontier_wave_dst(const void* in, const void* A,
                                     const void* labels, const void* dst,
                                     void* out, int R, int Vp, int W,
                                     int in_words, int out_dense,
                                     void* stream) {
  if (W % 4 || !aligned(in) || !aligned(A) || !aligned(out))
    return (int)cudaErrorInvalidValue;
  const int64_t ls = (int64_t)Vp * W;
  if (in_words) {
    return out_dense ? launch<kWords, true, false, kDenseAtDst>(
                           in, R, Vp, A, ls, labels, dst, out, W, stream)
                     : launch<kWords, true, false, kPackedAtDst>(
                           in, R, Vp, A, ls, labels, dst, out, W, stream);
  }
  return out_dense ? launch<kFloats, true, false, kDenseAtDst>(
                         in, R, Vp, A, ls, labels, dst, out, W, stream)
                   : launch<kFloats, true, false, kPackedAtDst>(
                         in, R, Vp, A, ls, labels, dst, out, W, stream);
}
