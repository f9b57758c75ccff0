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
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;  // frontier columns compacted per pass

__global__ void frontier_kernel(const float* __restrict__ F,
                                const int32_t* __restrict__ A,
                                const int32_t* __restrict__ labels,
                                int32_t* __restrict__ out, int Vp, int W) {
  extern __shared__ int32_t smem[];
  int32_t* acc = smem;       // W words
  int32_t* list = smem + W;  // up to kChunk column ids
  __shared__ int count;
  const int r = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const float* f = F + (int64_t)r * Vp;
  const int32_t* a = A + (int64_t)labels[r] * Vp * W;

  for (int w = threadIdx.x; w < W; w += kThreads) acc[w] = 0;
  for (int c0 = 0; c0 < Vp; c0 += kChunk) {
    const int c1 = min(c0 + kChunk, Vp);
    if (threadIdx.x == 0) count = 0;
    __syncthreads();
    // compaction: Vp is a multiple of 32, so every warp sees full words
    for (int u = c0 + threadIdx.x; u < c1; u += kThreads) {
      const bool nz = f[u] != 0.0f;
      const unsigned mask = __ballot_sync(0xffffffffu, nz);
      int base = 0;
      if (lane == 0 && mask) base = atomicAdd(&count, __popc(mask));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (nz) list[base + __popc(mask & ((1u << lane) - 1u))] = u;
    }
    __syncthreads();
    const int n = count;
    for (int w = threadIdx.x; w < W; w += kThreads) {
      int32_t x = acc[w];
      for (int i = 0; i < n; ++i) x |= a[(int64_t)list[i] * W + w];
      acc[w] = x;
    }
    __syncthreads();
  }
  for (int w = threadIdx.x; w < W; w += kThreads)
    out[(int64_t)r * W + w] = acc[w];
}

}  // namespace

extern "C" int rlc_frontier_step_many(const void* F, const void* A,
                                      const void* labels, void* out, int R,
                                      int Vp, int W, void* stream) {
  const size_t smem = sizeof(int32_t) * ((size_t)W + kChunk);
  frontier_kernel<<<R, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)F, (const int32_t*)A, (const int32_t*)labels,
      (int32_t*)out, Vp, W);
  return (int)cudaGetLastError();
}
