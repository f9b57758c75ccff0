// Batched Algorithm 1 (the RLC query join) for Hopper, one warp per query.
//
// Replaces the Pallas kernel repro/kernels/mergejoin.py::query_batch
// (_mergejoin_kernel). Query q = (s, t, mr) reads the padded rows
// L_out(s) and L_in(t) at storage rows s - row_base_out and
// t - row_base_in; the caller has range-checked those rows.
//
//   Case 2: any(oh == t & om == mr) | any(ih == s & im == mr)
//   Case 1: any i, j with oh[i] == ih[j], om[i] == mr == im[j], oh[i] != PAD
//
// What bounds it: bytes. Each query gathers four rows of E int32 (640 B at
// E = 40) from random storage rows and does at most E * E integer compares,
// so the gather latency, not the compares, sets the time. The design keeps
// the in-row in shared memory (each warp its own slice), lets the 32 lanes
// stride over the out-row with coalesced loads, and reduces with one
// __any_sync; queries of a block share nothing, so blocks need no barrier.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = -1;
constexpr int kWarps = 8;  // queries per block

__global__ void mergejoin_kernel(const int32_t* __restrict__ out_hub,
                                 const int32_t* __restrict__ out_mr,
                                 const int32_t* __restrict__ in_hub,
                                 const int32_t* __restrict__ in_mr,
                                 const int32_t* __restrict__ s,
                                 const int32_t* __restrict__ t,
                                 const int32_t* __restrict__ mr,
                                 uint8_t* __restrict__ out, int Q, int E,
                                 int row_base_out, int row_base_in) {
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + warp;
  if (q >= Q) return;  // the whole warp leaves together
  int32_t* sh = smem + warp * 2 * E;
  int32_t* sm = sh + E;
  const int32_t sq = s[q], tq = t[q], m = mr[q];
  const int32_t* oh = out_hub + (int64_t)(sq - row_base_out) * E;
  const int32_t* om = out_mr + (int64_t)(sq - row_base_out) * E;
  const int32_t* ih = in_hub + (int64_t)(tq - row_base_in) * E;
  const int32_t* im = in_mr + (int64_t)(tq - row_base_in) * E;

  bool hit = false;
  for (int j = lane; j < E; j += 32) {
    const int32_t h = ih[j], x = im[j];
    sh[j] = h;
    sm[j] = x;
    hit |= (h == sq) & (x == m);  // Case 2: (s, mr) in L_in(t)
  }
  __syncwarp();
  for (int i = lane; i < E; i += 32) {
    const int32_t h = om[i] == m ? oh[i] : kPad;
    hit |= h == tq;  // Case 2: (t, mr) in L_out(s)
    if (h != kPad) {  // Case 1: a hub of L_out(s) with mr, also in L_in(t)
      for (int j = 0; j < E && !hit; ++j) hit = (sh[j] == h) & (sm[j] == m);
    }
  }
  hit = __any_sync(0xffffffffu, hit);
  if (lane == 0) out[q] = hit ? 1 : 0;
}

}  // namespace

extern "C" int rlc_mergejoin(const void* out_hub, const void* out_mr,
                             const void* in_hub, const void* in_mr,
                             const void* s, const void* t, const void* mr,
                             void* out, int Q, int E, int row_base_out,
                             int row_base_in, void* stream) {
  const int blocks = (Q + kWarps - 1) / kWarps;
  const size_t smem = sizeof(int32_t) * 2 * E * kWarps;
  mergejoin_kernel<<<blocks, 32 * kWarps, smem, (cudaStream_t)stream>>>(
      (const int32_t*)out_hub, (const int32_t*)out_mr,
      (const int32_t*)in_hub, (const int32_t*)in_mr, (const int32_t*)s,
      (const int32_t*)t, (const int32_t*)mr, (uint8_t*)out, Q, E,
      row_base_out, row_base_in);
  return (int)cudaGetLastError();
}
