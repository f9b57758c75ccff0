// Batched Algorithm 1 (the RLC query join) for Hopper: several queries a
// warp, each on a group of lanes, rows held in registers.
//
// Replaces the Pallas kernel repro/kernels/mergejoin.py::query_batch
// (_mergejoin_kernel). Query q = (s, t, mr) reads the padded rows
// L_out(s) and L_in(t) at storage rows s - row_base_out and
// t - row_base_in; the caller has range-checked those rows.
//
//   Case 2: any(oh == t & om == mr) | any(ih == s & im == mr)
//   Case 1: any i, j with oh[i] == ih[j], om[i] == mr == im[j],
//           oh[i] != PAD, ih[j] != PAD
//
// Rows are unsorted as far as the kernel knows (the frozen rows are sorted
// by (aid(hub), mr), not by hub), so nothing here relies on an order.
//
// What bounds it: bytes, and the latency of gathering them. Each query
// gathers four rows of E int32 (640 B at E = 40) from random storage rows
// and does few compares, so the design keeps every load in flight at once
// and spends as few lanes and instructions as it can on each query:
//
// * A query gets a group of G lanes (8 up to E = 64, else 32, chosen on
//   the host from E), so one warp answers 32 / G queries.
// * Each lane loads C chunks of 4 entries of each row (C = 2 for
//   32 < E <= 64, else 1), with 16-byte loads when rows are 16-byte
//   aligned (E % 4 == 0), into registers; a row longer than 4 G C entries
//   is covered in turns.
// * The MR test is applied at load: an entry whose MR differs from the
//   query's becomes PAD. Case 2 is one compare per register.
// * Case 1 broadcasts, with __shfl_sync, the surviving out hubs of one lane
//   at a time to the group, which compares each against the in hubs it
//   holds: as many rounds as lanes holding an entry with the queried MR
//   (about E / C of the E entries carry it, C MRs), not E.
// * The group reduces with __ballot_sync; its first lane writes the byte.
//
// All lanes of a warp take part in every shuffle and ballot (lanes past Q
// carry PAD), so the loops stay warp-uniform.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = -1;
constexpr int kThreads = 128;
constexpr unsigned kAll = 0xffffffffu;

struct Four {
  int32_t v[4];
};

// entries [e, e + 4) of a row; past E they read as PAD
template <bool kVec>
__device__ __forceinline__ Four load4(const int32_t* row, int e, int E,
                                      bool live) {
  Four f;
  if constexpr (kVec) {
    if (live && e < E) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(row + e));
      f.v[0] = x.x; f.v[1] = x.y; f.v[2] = x.z; f.v[3] = x.w;
    } else {
      f.v[0] = f.v[1] = f.v[2] = f.v[3] = kPad;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f.v[j] = live && e + j < E ? __ldg(row + e + j) : kPad;
  }
  return f;
}

template <int G, int C, bool kVec>
__global__ void __launch_bounds__(kThreads)
mergejoin_kernel(const int32_t* __restrict__ out_hub,
                 const int32_t* __restrict__ out_mr,
                 const int32_t* __restrict__ in_hub,
                 const int32_t* __restrict__ in_mr,
                 const int32_t* __restrict__ s,
                 const int32_t* __restrict__ t,
                 const int32_t* __restrict__ mr, uint8_t* __restrict__ out,
                 int Q, int E, int row_base_out, int row_base_in) {
  constexpr int kTurn = 4 * G * C;  // entries of a row a group holds
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);  // lane within the group
  const unsigned group =
      G == 32 ? kAll : ((1u << G) - 1u) << (lane & ~(G - 1));
  const int64_t q = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / G;
  const bool live = q < Q;
  int32_t sq = 0, tq = 0, m = 0;
  if (live) {
    sq = __ldg(s + q);
    tq = __ldg(t + q);
    m = __ldg(mr + q);
  }
  const int64_t ro = live ? (int64_t)(sq - row_base_out) * E : 0;
  const int64_t ri = live ? (int64_t)(tq - row_base_in) * E : 0;
  const int32_t* oh = out_hub + ro;
  const int32_t* om = out_mr + ro;
  const int32_t* ih = in_hub + ri;
  const int32_t* im = in_mr + ri;

  bool hit = false;
  for (int ib = 0; ib < E; ib += kTurn) {  // turns over L_in(t)
    // chunk c of the group covers entries ib + 4 G c + [0, 4 G)
    Four h[C], x[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int e = ib + 4 * (sub + G * c);
      h[c] = load4<kVec>(ih, e, E, live);
      x[c] = load4<kVec>(im, e, E, live);
    }
    int32_t in_h[4 * C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // Case 2: (s, mr) in L_in(t)
        hit |= (h[c].v[j] == sq) & (x[c].v[j] == m);
        in_h[4 * c + j] = x[c].v[j] == m ? h[c].v[j] : kPad;
      }
    }
    for (int ob = 0; ob < E; ob += kTurn) {  // turns over L_out(s)
      Four oh4[C], om4[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int f = ob + 4 * (sub + G * c);
        oh4[c] = load4<kVec>(oh, f, E, live);
        om4[c] = load4<kVec>(om, f, E, live);
      }
      int32_t out_h[4 * C];
      bool any = false;
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (ib == 0)  // Case 2: (t, mr) in L_out(s)
            hit |= (oh4[c].v[j] == tq) & (om4[c].v[j] == m);
          out_h[4 * c + j] = om4[c].v[j] == m ? oh4[c].v[j] : kPad;
          any |= out_h[4 * c + j] != kPad;
        }
      }
      // lanes of this group that hold an out hub with the queried MR; a
      // group that already has its answer skips Case 1
      const bool done = (__ballot_sync(kAll, hit) & group) != 0;
      unsigned todo = __ballot_sync(kAll, any && !done) & group;
      // a group with nothing left to broadcast reads its own lane's hubs
      // (src = lane): every compare pairs an out hub and an in hub of one
      // query, so it can only find a true Case-1 hit
      while (__any_sync(kAll, todo != 0)) {
        const int src = todo ? __ffs(todo) - 1 : lane;
        todo &= todo - 1;
#pragma unroll
        for (int k = 0; k < 4 * C; ++k) {
          const int32_t hub = __shfl_sync(kAll, out_h[k], src);
          if (hub != kPad) {
#pragma unroll
            for (int j = 0; j < 4 * C; ++j) hit |= in_h[j] == hub;
          }
        }
      }
    }
  }
  const bool answer = (__ballot_sync(kAll, hit) & group) != 0;
  if (live && sub == 0) out[q] = answer ? 1 : 0;
}

template <int G, int C>
int launch(bool vec, const void* oh, const void* om, const void* ih,
           const void* im, const void* s, const void* t, const void* mr,
           void* out, int Q, int E, int rbo, int rbi, cudaStream_t stream) {
  const int64_t threads = (int64_t)Q * G;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  auto* kernel =
      vec ? mergejoin_kernel<G, C, true> : mergejoin_kernel<G, C, false>;
  kernel<<<blocks, kThreads, 0, stream>>>(
      (const int32_t*)oh, (const int32_t*)om, (const int32_t*)ih,
      (const int32_t*)im, (const int32_t*)s, (const int32_t*)t,
      (const int32_t*)mr, (uint8_t*)out, Q, E, rbo, rbi);
  return (int)cudaGetLastError();
}

}  // namespace

// (group, chunks): lanes a query and 16-byte chunks of each row a lane
// holds, one of (8, 1), (8, 2), (32, 1); a group holds 4 * group * chunks
// entries of a row at once, longer rows take turns. vec: rows are read
// with 16-byte loads (E % 4 == 0 and the four row arrays 16-byte aligned).
extern "C" int rlc_mergejoin(const void* out_hub, const void* out_mr,
                             const void* in_hub, const void* in_mr,
                             const void* s, const void* t, const void* mr,
                             void* out, int Q, int E, int row_base_out,
                             int row_base_in, int group, int chunks, int vec,
                             void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (group == 8 && chunks == 1)
    return launch<8, 1>(vec, out_hub, out_mr, in_hub, in_mr, s, t, mr, out,
                        Q, E, row_base_out, row_base_in, st);
  if (group == 8 && chunks == 2)
    return launch<8, 2>(vec, out_hub, out_mr, in_hub, in_mr, s, t, mr, out,
                        Q, E, row_base_out, row_base_in, st);
  if (group == 32 && chunks == 1)
    return launch<32, 1>(vec, out_hub, out_mr, in_hub, in_mr, s, t, mr, out,
                         Q, E, row_base_out, row_base_in, st);
  return (int)cudaErrorInvalidValue;
}
