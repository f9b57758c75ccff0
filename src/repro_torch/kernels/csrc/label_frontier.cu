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
// (W x 4 B each), and an OR of words replaces the multiply-add. One block
// per frontier row: it compacts the row's non-zero columns into shared
// memory (a warp ballot per 32 columns; the list's order is free, since OR
// is commutative), then each thread
// ORs whole words of the selected adjacency rows into an accumulator held in
// shared memory, so the result needs no cross-block reduction.
//
// Two more entry points share the kernel:
//
// rlc_bitpack_matmul replaces repro/kernels/bitpack.py::bitpack_matmul
// (_bitpack_kernel): out[m, w] = OR over k with a[m, k] > 0 of b[k, w], for
// a (M, K) float32 and b (K, W) int32 words, K and W independent: the wave
// above with a single adjacency, a general K and the reference's > 0 test.
// Bound by bytes as well: a, the output, and the rows of b that a selects.
//
// rlc_frontier_step_many_dst is one wave of repro/kernels/label_frontier.py::
// frontier_steps (T chained frontier_step_many waves under lax.scan, row r's
// result landing in row dst[r]): the same wave, its store unpacking the words
// into a float32 0/1 row at row dst[r] of the next frontier, so the waves
// chain with no pack or scatter pass between them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;  // frontier columns compacted per pass

enum Store { kPacked, kDenseAtDst };

// out row r = OR over the selected columns u of F row r of the words of row
// u of the adjacency A + labels[r] * label_stride (label_stride = 0 and
// labels = nullptr: one adjacency). A column u is selected when F[r, u] is
// non-zero, or, with kPositive, greater than zero.
template <bool kPositive, Store kStore>
__global__ void frontier_kernel(const float* __restrict__ F, int K,
                                const int32_t* __restrict__ A,
                                int64_t label_stride,
                                const int32_t* __restrict__ labels,
                                const int32_t* __restrict__ dst,
                                void* __restrict__ out, int W) {
  extern __shared__ int32_t smem[];
  int32_t* acc = smem;       // W words
  int32_t* list = smem + W;  // up to kChunk column ids
  __shared__ int count;
  const int r = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const float* f = F + (int64_t)r * K;
  const int32_t* a = A + (labels ? labels[r] * label_stride : 0);

  for (int w = threadIdx.x; w < W; w += kThreads) acc[w] = 0;
  for (int c0 = 0; c0 < K; c0 += kChunk) {
    const int c1 = min(c0 + kChunk, K);
    if (threadIdx.x == 0) count = 0;
    __syncthreads();
    // compaction: every thread takes the same number of turns, so each
    // ballot sees a full warp whatever K is
    for (int u0 = c0; u0 < c1; u0 += kThreads) {
      const int u = u0 + threadIdx.x;
      const float x = u < c1 ? f[u] : 0.0f;
      const bool nz = kPositive ? x > 0.0f : x != 0.0f;
      const unsigned mask = __ballot_sync(0xffffffffu, nz);
      int base = 0;
      if (lane == 0 && mask) base = atomicAdd(&count, __popc(mask));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (nz) list[base + __popc(mask & ((1u << lane) - 1u))] = u;
    }
    __syncthreads();
    const int n = count;
    for (int w = threadIdx.x; w < W; w += kThreads) {
      // eight independent OR chains keep eight row loads in flight
      int32_t x[8] = {acc[w], 0, 0, 0, 0, 0, 0, 0};
      int i = 0;
      for (; i + 8 <= n; i += 8) {
#pragma unroll
        for (int j = 0; j < 8; ++j) x[j] |= a[(int64_t)list[i + j] * W + w];
      }
      for (; i < n; ++i) x[0] |= a[(int64_t)list[i] * W + w];
      acc[w] = x[0] | x[1] | x[2] | x[3] | x[4] | x[5] | x[6] | x[7];
    }
    __syncthreads();
  }
  if (kStore == kPacked) {
    int32_t* o = static_cast<int32_t*>(out) + (int64_t)r * W;
    for (int w = threadIdx.x; w < W; w += kThreads) o[w] = acc[w];
  } else {
    __syncthreads();  // each thread reads words that others wrote
    float* o = static_cast<float*>(out) + (int64_t)dst[r] * 32 * W;
    for (int v = threadIdx.x; v < 32 * W; v += kThreads)
      o[v] = (float)((acc[v >> 5] >> (v & 31)) & 1);
  }
}

template <bool kPositive, Store kStore>
int launch(const void* F, int R, int K, const void* A, int64_t label_stride,
           const void* labels, const void* dst, void* out, int W,
           void* stream) {
  const size_t smem = sizeof(int32_t) * ((size_t)W + kChunk);
  frontier_kernel<kPositive, kStore>
      <<<R, kThreads, smem, (cudaStream_t)stream>>>(
          (const float*)F, K, (const int32_t*)A, label_stride,
          (const int32_t*)labels, (const int32_t*)dst, out, W);
  return (int)cudaGetLastError();
}

}  // namespace

// out (R, W) int32 words: one frontier wave, per-row labels, F (R, Vp).
extern "C" int rlc_frontier_step_many(const void* F, const void* A,
                                      const void* labels, void* out, int R,
                                      int Vp, int W, void* stream) {
  return launch<false, kPacked>(F, R, Vp, A, (int64_t)Vp * W, labels,
                                nullptr, out, W, stream);
}

// out (M, W) int32 words = OR over k with a[m, k] > 0 of b[k, :].
extern "C" int rlc_bitpack_matmul(const void* a, const void* b, void* out,
                                  int M, int K, int W, void* stream) {
  return launch<true, kPacked>(a, M, K, b, 0, nullptr, nullptr, out, W,
                               stream);
}

// out (R, Vp) float32 0/1: one wave of F (R, Vp) with row r's result
// unpacked into row dst[r]; dst is a permutation of the R rows.
extern "C" int rlc_frontier_step_many_dst(const void* F, const void* A,
                                          const void* labels, const void* dst,
                                          void* out, int R, int Vp, int W,
                                          void* stream) {
  return launch<false, kDenseAtDst>(F, R, Vp, A, (int64_t)Vp * W, labels,
                                    dst, out, W, stream);
}
