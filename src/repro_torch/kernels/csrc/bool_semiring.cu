// OR-AND (boolean semiring) matrix products for Hopper, on bf16 tensor cores.
//
// Replaces the Pallas kernels repro/kernels/bool_semiring.py::bool_matmul
// (_bool_mm_kernel) and ::closure_step (_fused_closure_kernel):
//
//   bool_matmul:  out[i, j] = (sum_k a[i, k] * b[k, j]) > 0
//   closure_step: out[i, j] = max(r[i, j], (sum_k r[i, k] * r[k, j]) > 0)
//
// Operands are 0/1 values in float32 or bf16 and the output has their type.
// 0 and 1 are exact in bf16, and the float32 sums of products stay below
// K < 2^24, so the threshold on the tensor cores' float32 accumulator gives
// the exact OR-AND result for either input type.
//
// What bounds it: operations. At the dense engine's n = 6656 one product is
// 2 n^3 = 5.9e11 multiply-adds against 3 n^2 float32 values (0.53 GB), some
// 1,100 operations a byte, far above the card's ~295 for bf16. The design
// feeds the tensor cores: a 128 x 128 output tile per block of 8 warps, each
// warp 64 x 32 (4 x 2 WMMA m16n16k16 bf16 fragments, float32 accumulators in
// registers), K walked in steps of 32 through one shared-memory tile pair.
// The next K step is loaded from device memory into registers while the
// tensor cores work on the current one. float32 inputs are converted to
// bf16 on their way into shared memory, so both input types share the
// inner loop. The kernel masks the ragged edge itself (zero fill on load,
// bounds-checked store), so callers never pad and slice per call; rows whose
// stride is a multiple of 16 bytes load in 16-byte vectors.
//
// closure_step reads r as both operands and as the epilogue's (i, j) tile;
// its output is a separate buffer (every block still reads r).
//
// wgmma and TMA, the way to the card's full tensor-core rate, are left for
// a later change; this kernel is the simple tiled form.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kThreads = 256;  // 8 warps: 2 along M x 4 along N
constexpr int kLdA = kBK + 8;  // shared-memory row pitches (bf16), padded
constexpr int kLdB = kBN + 8;  // against bank conflicts, multiples of 8

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

// One thread's share of a (rows x cols) tile: kPer chunks of kVec elements
// (16 bytes of input), held as packed bf16 pairs between the device-memory
// load and the shared-memory store.
template <typename T, int kRows, int kCols>
struct TileLoader {
  static constexpr int kVec = 16 / sizeof(T);  // elements a chunk
  static constexpr int kWords = kVec / 2;      // bf16 pairs a chunk
  static constexpr int kChunksPerRow = kCols / kVec;
  static constexpr int kPer = kRows * kChunksPerRow / kThreads;
  uint32_t w[kPer][kWords];

  // Tile origin (r0, c0) of a (R x C) matrix with row pitch ld.
  __device__ __forceinline__ void load(const T* __restrict__ p, int64_t ld,
                                       int R, int C, int r0, int c0,
                                       bool vec_ok) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int chunk = threadIdx.x + i * kThreads;
      const int r = r0 + chunk / kChunksPerRow;
      const int c = c0 + (chunk % kChunksPerRow) * kVec;
      const T* src = p + r * ld + c;
      if (vec_ok && r < R && c + kVec <= C) {
        const uint4 u = *reinterpret_cast<const uint4*>(src);
        if constexpr (sizeof(T) == 2) {
          w[i][0] = u.x, w[i][1] = u.y, w[i][2] = u.z, w[i][3] = u.w;
        } else {
          w[i][0] = pack2(__uint_as_float(u.x), __uint_as_float(u.y));
          w[i][1] = pack2(__uint_as_float(u.z), __uint_as_float(u.w));
        }
      } else {
#pragma unroll
        for (int e = 0; e < kWords; ++e) {
          const int c2 = c + 2 * e;
          const float lo = (r < R && c2 < C) ? to_f32(src[2 * e]) : 0.0f;
          const float hi =
              (r < R && c2 + 1 < C) ? to_f32(src[2 * e + 1]) : 0.0f;
          w[i][e] = pack2(lo, hi);
        }
      }
    }
  }

  __device__ __forceinline__ void store(__nv_bfloat16* s, int lds) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int chunk = threadIdx.x + i * kThreads;
      __nv_bfloat16* dst =
          s + (chunk / kChunksPerRow) * lds + (chunk % kChunksPerRow) * kVec;
      if constexpr (kWords == 4)
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(w[i][0], w[i][1], w[i][2], w[i][3]);
      else
        *reinterpret_cast<uint2*>(dst) = make_uint2(w[i][0], w[i][1]);
    }
  }
};

// out = (a @ b) > 0, or, with r != nullptr, max(r, (a @ b) > 0).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bool_mm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   const T* __restrict__ r, T* __restrict__ out, int M, int N,
                   int K, int64_t lda, int64_t ldb, int64_t ldc, int64_t ldr,
                   bool vec_a, bool vec_b) {
  __shared__ __align__(128) __nv_bfloat16 As[kBM * kLdA];
  __shared__ __align__(128) __nv_bfloat16 Bs[kBK * kLdB];
  __shared__ __align__(128) float stage[kThreads / 32][16 * 16];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64;  // warp's rows within the block tile
  const int wn = (warp & 3) * 32;   // warp's columns
  const int i0 = blockIdx.y * kBM;
  const int j0 = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  TileLoader<T, kBM, kBK> la;
  TileLoader<T, kBK, kBN> lb;
  const int nk = (K + kBK - 1) / kBK;
  if (nk > 0) {
    la.load(a, lda, M, K, i0, 0, vec_a);
    lb.load(b, ldb, K, N, 0, j0, vec_b);
    la.store(As, kLdA);
    lb.store(Bs, kLdB);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const bool more = kt + 1 < nk;
    if (more) {  // next K step into registers while this one computes
      la.load(a, lda, M, K, i0, (kt + 1) * kBK, vec_a);
      lb.load(b, ldb, K, N, (kt + 1) * kBK, j0, vec_b);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm + 16 * i) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * kLdB + wn + 16 * j, kLdB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      la.store(As, kLdA);
      lb.store(Bs, kLdB);
      __syncthreads();
    }
  }

  // Epilogue: each warp stages one 16 x 16 accumulator at a time in shared
  // memory (the fragment layout is opaque), thresholds it, ORs in r's tile
  // for closure_step, and stores the in-bounds part.
  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int fi = i0 + wm + 16 * i;
      const int fj = j0 + wn + 16 * j;
      for (int e = lane; e < 256; e += 32) {
        const int gi = fi + (e >> 4);
        const int gj = fj + (e & 15);
        if (gi < M && gj < N) {
          float x = st[e] > 0.0f ? 1.0f : 0.0f;
          if (r != nullptr) x = fmaxf(x, to_f32(r[gi * ldr + gj]));
          out[gi * ldc + gj] = from_f32<T>(x);
        }
      }
      __syncwarp();
    }
  }
}

bool aligned16(const void* p, int64_t ld, int elem) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (ld * elem) % 16 == 0;
}

template <typename T>
int launch(const void* a, const void* b, const void* r, void* out, int M,
           int N, int K, int64_t lda, int64_t ldb, int64_t ldc, int64_t ldr,
           cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  bool_mm_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)a, (const T*)b, (const T*)r, (T*)out, M, N, K, lda, ldb, ldc,
      ldr, aligned16(a, lda, sizeof(T)), aligned16(b, ldb, sizeof(T)));
  return (int)cudaGetLastError();
}

int dispatch(const void* a, const void* b, const void* r, void* out, int M,
             int N, int K, int64_t lda, int64_t ldb, int64_t ldc, int64_t ldr,
             int bf16, void* stream) {
  if (bf16)
    return launch<__nv_bfloat16>(a, b, r, out, M, N, K, lda, ldb, ldc, ldr,
                                 (cudaStream_t)stream);
  return launch<float>(a, b, r, out, M, N, K, lda, ldb, ldc, ldr,
                       (cudaStream_t)stream);
}

}  // namespace

// out (M, N) = (a (M, K) @ b (K, N)) > 0; row pitches in elements;
// bf16 = 1 for bfloat16 operands and output, 0 for float32.
extern "C" int rlc_bool_matmul(const void* a, const void* b, void* out, int M,
                               int N, int K, int64_t lda, int64_t ldb,
                               int64_t ldc, int bf16, void* stream) {
  return dispatch(a, b, nullptr, out, M, N, K, lda, ldb, ldc, 0, bf16, stream);
}

// out (n, n) = max(r, (r @ r) > 0); out must not alias r.
extern "C" int rlc_closure_step(const void* r, void* out, int n, int64_t ldr,
                                int64_t ldc, int bf16, void* stream) {
  return dispatch(r, r, r, out, n, n, n, ldr, ldr, ldc, ldr, bf16, stream);
}
