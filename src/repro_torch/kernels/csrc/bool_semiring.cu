// OR-AND (boolean semiring) matrix products for Hopper: two kernels, one
// for each regime of the dense engine's products.
//
// Replaces the Pallas kernels repro/kernels/bool_semiring.py::bool_matmul
// (_bool_mm_kernel), ::closure_step (_fused_closure_kernel) and, through
// the same entry point, repro/kernels/label_frontier.py::frontier_step:
//
//   bool_matmul:  out[i, j] = (sum_k a[i, k] * b[k, j]) > 0
//   closure_step: out[i, j] = max(r[i, j], (sum_k r[i, k] * r[k, j]) > 0)
//
// Operands are 0/1 values in float32 or bf16 and the output has their type.
// 0 and 1 are exact in bf16, and float32 sums of products stay exact while
// K < 2^24, so a threshold on a float32 accumulator gives the exact OR-AND
// result whichever input type was given. OR is idempotent and does not
// depend on order, which the split-K kernel below relies on.
//
// Kernel A, wgmma_kernel (the square product, n = 6656 in the dense
// engine). Bound by operations: 2 n^3 = 5.9e11 against 3 n^2 bf16 values,
// some 2,200 operations a byte. A 128 x 256 output tile per block of three
// warpgroups: one producer thread issues TMA loads (cp.async.bulk.tensor) of
// 128 x 64 A tiles and four 64 x 64 B boxes into a 4-stage ring of
// 128-byte-swizzled shared memory, completing on mbarriers; two consumer
// warpgroups each run wgmma m64n256k16 (bf16, float32 accumulators in
// registers, B read MN-major since it is row-major (K, N)) on 64 rows of
// the tile. The epilogue thresholds the accumulator registers in place
// (the wgmma fragment layout is documented), ORs in r's (i, j) element for
// closure_step and stores with bounds checks. TMA zero-fills boxes past
// the matrix, so ragged M, N and K cost nothing. Tiles are visited in
// groups of 16 row tiles so that the blocks in flight share A and B in L2.
// TMA takes bf16 operands with a 16-byte-aligned base and row pitch; the
// staging pass (stage_kernel) writes any other operand (float32, or bf16
// with an odd pitch) as a bf16 copy with a pitch of a multiple of 8
// elements, once for each distinct operand. The tensor maps are encoded
// on the host for every call (the engine ping-pongs buffers) and passed as
// __grid_constant__ parameters; cuTensorMapEncodeTiled, a driver-API
// symbol, is fetched with cudaGetDriverEntryPoint at first use, so the
// library links no -lcuda.
//
// Kernel B, splitk_kernel (few output tiles: frontier_step's 300 x 6656
// product). Bound by bytes: it must read the (K, N) float32 slice of the
// adjacency, 177 MB, for 2.7e10 operations. A tile covers 320 rows (all
// of a 300-row frontier, so B is read from device memory once) and 128
// columns. The work is cut into units of one K step of one tile, and
// one block on each SM takes an even, contiguous share of them, so K is
// split across blocks wherever a share crosses a tile, the card is full
// even with 52 tiles, and the pipeline never drains between tiles. The
// same warp-specialised pipeline as kernel A: two producer threads issue
// TMA loads into an A ring (five 64 x 64 bf16 boxes a stage) and a B ring
// (a 64 x 128 tile), two consumer warpgroups each run wgmma m64n64k16 on
// 64 of the columns. bf16 B arrives in its wgmma layout; float32 B
// arrives plain and each consumer converts its half to bf16 in shared
// memory (exact for 0/1) and frees the stage at once, so the float32
// slice streams as it is, with no staging pass. A, the small operand, is
// staged to bf16 when it is float32. Splits combine with no float
// reduction: the entry point zeroes out, and each block stores 1 wherever
// its partial sum over its run of a tile is > 0 (for closure_step the run
// that starts at K step 0 also wherever r is 1). Every writer of an
// element stores the same value, so the result is the OR over the runs,
// exact and independent of order.
//
// Which kernel runs and whether operands are staged is decided by the
// Python wrapper (kernels/bool_semiring.py::route) and passed in. Each
// entry point checks cudaGetLastError() after each of its launches and
// returns the first error.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two adjacent elements of T as one access (float2 or bf16x2).
template <typename T>
struct Pair2;
template <>
struct Pair2<float> {
  using type = float2;
  static __device__ __forceinline__ type make(float a, float b) {
    return make_float2(a, b);
  }
  static __device__ __forceinline__ float lo(type v) { return v.x; }
  static __device__ __forceinline__ float hi(type v) { return v.y; }
};
template <>
struct Pair2<bf16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ type make(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ float lo(type v) {
    return __low2float(v);
  }
  static __device__ __forceinline__ float hi(type v) {
    return __high2float(v);
  }
};

template <typename T>
__device__ __forceinline__ bool pair_aligned(const T* p) {
  return reinterpret_cast<uintptr_t>(p) % (2 * sizeof(T)) == 0;
}

// x0 |= r[i, j] > 0 and x1 |= r[i, j + 1] > 0, in bounds (i < M checked by
// the caller); one load where the pair is aligned.
template <typename T>
__device__ __forceinline__ void or_pair(const T* r, int64_t ldr, int N,
                                        int i, int j, bool& x0, bool& x1) {
  const T* p = r + i * ldr + j;
  if (j + 1 < N && pair_aligned(p)) {
    const typename Pair2<T>::type v =
        *reinterpret_cast<const typename Pair2<T>::type*>(p);
    x0 = x0 || Pair2<T>::lo(v) > 0.0f;
    x1 = x1 || Pair2<T>::hi(v) > 0.0f;
    return;
  }
  if (j < N) x0 = x0 || to_f32(p[0]) > 0.0f;
  if (j + 1 < N) x1 = x1 || to_f32(p[1]) > 0.0f;
}

// The epilogue store of both kernels at (i, j) and (i, j + 1), in bounds:
// 1 where the flag is set and, with zeros_too, 0 where it is not (the
// split-K kernel stores only ones into its zeroed output). One store
// where the pair is aligned and both elements are written.
template <typename T>
__device__ __forceinline__ void store_pair(T* out, int64_t ldc, int M,
                                           int N, int i, int j, bool x0,
                                           bool x1, bool zeros_too) {
  if (i >= M) return;
  T* p = out + i * ldc + j;
  if (j + 1 < N && (zeros_too || (x0 && x1)) && pair_aligned(p)) {
    *reinterpret_cast<typename Pair2<T>::type*>(p) =
        Pair2<T>::make(x0 ? 1.0f : 0.0f, x1 ? 1.0f : 0.0f);
    return;
  }
  const T one = from_f32<T>(1.0f), zero = from_f32<T>(0.0f);
  if (j < N && (x0 || zeros_too)) p[0] = x0 ? one : zero;
  if (j + 1 < N && (x1 || zeros_too)) p[1] = x1 ? one : zero;
}

// ------------------------------------------------------------------ //
// Staging: a bf16 copy with a pitch of a multiple of 8 elements (16
// bytes), zero past the last column.
// ------------------------------------------------------------------ //
template <typename T>
__global__ void stage_kernel(const T* __restrict__ src, int64_t ld,
                             int rows, int cols, bf16* __restrict__ dst,
                             int64_t ldd) {
  const int64_t pairs = ldd / 2;
  const int64_t total = static_cast<int64_t>(rows) * pairs;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t i = e / pairs;
    const int j = static_cast<int>(e - i * pairs) * 2;
    const T* s = src + i * ld + j;
    const float lo = j < cols ? to_f32(s[0]) : 0.0f;
    const float hi = j + 1 < cols ? to_f32(s[1]) : 0.0f;
    reinterpret_cast<__nv_bfloat162*>(dst + i * ldd)[j / 2] =
        __floats2bfloat162_rn(lo, hi);
  }
}

// ------------------------------------------------------------------ //
// TMA, mbarriers and wgmma, shared by both kernels
// ------------------------------------------------------------------ //
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// A 2-D box of the tensor map at coordinates (c0 innermost, c1) into
// shared memory, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile; offsets in
// bytes.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= 1ull << 62;  // 128-byte swizzle
  return d;
}

#define ACC8(i)                                                   \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 256 over the warpgroup) += A (64 x 16, K-major) B (16 x 256,
// MN-major), bf16 operands, float32 accumulators.
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
        ACC8(56), ACC8(64), ACC8(72), ACC8(80), ACC8(88), ACC8(96),
        ACC8(104), ACC8(112), ACC8(120)
      : "l"(da), "l"(db), "r"(1));
}


// d (64 x 64 over the warpgroup) += A (64 x 16, K-major) B (16 x 64,
// MN-major), bf16 operands, float32 accumulators.
__device__ __forceinline__ void wgmma_64(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "l"(da), "l"(db), "r"(1));
}

#undef ACC8

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------------ //
// Kernel A: TMA + wgmma
// ------------------------------------------------------------------ //
namespace wg {

constexpr int kBM = 128, kBN = 256, kBK = 64, kStages = 4;
constexpr int kThreads = 384;      // producer warpgroup + 2 consumers
constexpr int kGroupM = 16;        // row tiles visited together
constexpr int kABytes = kBM * kBK * 2;           // 16 KB
constexpr int kBBox = kBK * 64 * 2;              // one 64 x 64 B box, 8 KB
constexpr int kStageBytes = kABytes + 4 * kBBox; // 48 KB
constexpr int kSmem = kStages * kStageBytes + 1024 + 2 * kStages * 8;

// out = (a @ b) > 0, or, with r != nullptr, max(r, (a @ b) > 0); a and b
// are bf16 behind the tensor maps (a: dims {K, M}, b: dims {N, K}).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const T* __restrict__ r, T* __restrict__ out, int M, int N,
                 int K, int64_t ldc, int64_t ldr) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  // tile order: groups of kGroupM row tiles, row tiles fastest in a group
  const int tiles_m = (M + kBM - 1) / kBM;
  const int tiles_n = (N + kBN - 1) / kBN;
  const int per_group = kGroupM * tiles_n;
  const int group = blockIdx.x / per_group;
  const int first_m = group * kGroupM;
  const int group_m = min(tiles_m - first_m, kGroupM);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % group_m) * kBM;
  const int n0 = (in_group / group_m) * kBN;
  const int nk = (K + kBK - 1) / kBK;

  const int warpgroup = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warpgroup == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], (kt / kStages - 1) & 1);
        uint8_t* st = smem + s * kStageBytes;
        mbar_expect_tx(&full[s], kStageBytes);
        tma_load(st, &map_a, &full[s], kt * kBK, m0);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          tma_load(st + kABytes + c * kBBox, &map_b, &full[s], n0 + 64 * c,
                   kt * kBK);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = warpgroup - 1;  // this consumer's 64 rows of the tile
  const int t = threadIdx.x % 128;
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const uint8_t* st = smem + s * kStageBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // A: K-major rows of 128 bytes, 8-row groups 1024 bytes apart; the
      // k16 slice starts 32 bytes further along the row.
      const uint64_t da = desc(st + cw * 64 * 128 + kk * 32, 16, 1024);
      // B: MN-major 64 x 64 boxes 8 KB apart (LBO), 8-row groups of K
      // 1024 bytes apart (SBO); the k16 slice starts 16 rows further.
      const uint64_t db = desc(st + kABytes + kk * 16 * 128, kBBox, 1024);
      wgmma_256(d, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // one group in flight: the previous stage is free
    if (kt > 0 && t % 32 == 0) mbar_arrive(&empty[(kt - 1) % kStages]);
  }
  wgmma_wait<0>();

  // d[4 j + 2 h + e] holds row 16 w + t / 4 + 8 h, column 8 j + 2 (t % 4)
  // + e of this warpgroup's 64 x 256 block (w = warp in the warpgroup).
  const int row = m0 + cw * 64 + (t / 32) * 16 + (t % 32) / 4;
  const int col = n0 + 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = row + 8 * h, c = col + 8 * j;
      bool x0 = d[4 * j + 2 * h] > 0.0f, x1 = d[4 * j + 2 * h + 1] > 0.0f;
      if (r != nullptr && i < M) or_pair(r, ldr, N, i, c, x0, x1);
      store_pair(out, ldc, M, N, i, c, x0, x1, true);
    }
  }
}

}  // namespace wg

// ------------------------------------------------------------------ //
// Kernel B: split-K, TMA + wgmma
// ------------------------------------------------------------------ //
namespace sk {

constexpr int kBN = 128;           // two consumer warpgroups of 64 columns
constexpr int kBK = 64;
constexpr int kThreads = 384;      // producer warpgroup + 2 consumers
constexpr int kBox = 64 * 64 * 2;  // one 64 x 64 bf16 box, 8 KB
constexpr int kMT = 5;             // 64-row tiles a block covers
constexpr int kBM = 64 * kMT;      // 320 rows: all of a 300-row frontier

// Shared memory of a block with B of type T, in two rings with barriers
// of their own: A (kMT bf16 boxes a stage) and B.
// bf16 B arrives by TMA in its wgmma layout (two 128-byte-swizzled
// 64 x 64 boxes) and is read by wgmma, so its stage is freed with A's.
// float32 B arrives as a plain kBK x kBN tile that each consumer
// warpgroup converts into a bf16 box of its own (two, alternating); its
// stage is freed as soon as it is converted, so the stream from device
// memory runs ahead of the tensor cores.
template <typename T>
struct Cfg {
  static constexpr bool kConvert = sizeof(T) == 4;
  static constexpr int kABytes = kMT * kBox;
  static constexpr int kBBytes = kBK * kBN * static_cast<int>(sizeof(T));
  static constexpr int kStagesA = kConvert ? 3 : 4;
  static constexpr int kStagesB = kConvert ? 2 : 3;
  static constexpr int kConvBytes = kConvert ? 2 * 2 * kBox : 0;
  static constexpr int kBarOffset =
      kStagesA * kABytes + kStagesB * kBBytes + kConvBytes;
  static constexpr int kSmem =
      kBarOffset + 1024 + 2 * (kStagesA + kStagesB) * 8;
};

// The work is a list of units, one K step of one output tile each: K
// steps fastest, then row tiles, then column tiles. Block b takes units
// [b * per, (b + 1) * per) and runs them through one pipeline, so a tile
// is split across the blocks whose ranges cross it, and the loads of the
// next tile overlap the epilogue of the last. At the end of each tile's
// run of units a block stores out |= (partial product) > 0 (and ORs in r
// where its run began at K step 0); out was zeroed by the entry point.
// a is bf16 behind map_a (dims {K, M}); b is behind map_b (dims {N, K}),
// bf16 or float32. Rows past M arrive as zeros from TMA; nothing past M
// or N is stored.
template <typename T, typename TOut>
__global__ void __launch_bounds__(kThreads, 1)
    splitk_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  const TOut* __restrict__ r, TOut* __restrict__ out, int M,
                  int N, int K, int64_t ldc, int64_t ldr, int per) {
  using C = Cfg<T>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring_a = smem;
  uint8_t* ring_b = ring_a + C::kStagesA * C::kABytes;
  uint8_t* conv = ring_b + C::kStagesB * C::kBBytes;
  uint64_t* full_a = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* empty_a = full_a + C::kStagesA;
  uint64_t* full_b = empty_a + C::kStagesA;
  uint64_t* empty_b = full_b + C::kStagesB;

  const int steps = (K + kBK - 1) / kBK;
  const int tiles_m = (M + kBM - 1) / kBM;
  const int64_t units =
      static_cast<int64_t>(steps) * tiles_m * ((N + kBN - 1) / kBN);
  const int64_t u0 = static_cast<int64_t>(blockIdx.x) * per;
  const int64_t left = units - u0;
  const int nk = left <= 0 ? 0 : static_cast<int>(left < per ? left : per);
  // unit u0 + i: K step, row origin and column origin
  auto unit = [&](int i, int& k, int& m, int& n) {
    const int64_t u = u0 + i;
    const int64_t tile = u / steps;
    k = static_cast<int>(u - tile * steps);
    m = static_cast<int>(tile % tiles_m) * kBM;
    n = static_cast<int>(tile / tiles_m) * kBN;
  };

  const int warpgroup = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStagesA; ++s) {
      mbar_init(&full_a[s], 1);
      mbar_init(&empty_a[s], 8);  // one arrival from each consumer warp
    }
    for (int s = 0; s < C::kStagesB; ++s) {
      mbar_init(&full_b[s], 1);
      mbar_init(&empty_b[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warpgroup == 0) {
    // two producer threads, one a ring, so that B does not wait on A
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % C::kStagesA;
        if (kt >= C::kStagesA)
          mbar_wait(&empty_a[s], (kt / C::kStagesA - 1) & 1);
        uint8_t* st = ring_a + s * C::kABytes;
        int k, m, n;
        unit(kt, k, m, n);
        mbar_expect_tx(&full_a[s], C::kABytes);
#pragma unroll
        for (int i = 0; i < kMT; ++i)
          tma_load(st + i * kBox, &map_a, &full_a[s], k * kBK, m + 64 * i);
      }
    } else if (threadIdx.x == 32) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % C::kStagesB;
        if (kt >= C::kStagesB)
          mbar_wait(&empty_b[s], (kt / C::kStagesB - 1) & 1);
        uint8_t* st = ring_b + s * C::kBBytes;
        int k, m, n;
        unit(kt, k, m, n);
        mbar_expect_tx(&full_b[s], C::kBBytes);
        tma_load(st, &map_b, &full_b[s], n, k * kBK);
        if (!C::kConvert)
          tma_load(st + kBox, &map_b, &full_b[s], n + 64, k * kBK);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = warpgroup - 1;  // this consumer's 64 columns of the tile
  const int t = threadIdx.x % 128;
  float d[kMT][32];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) d[i][e] = 0.0f;
  int k_first = 0;  // K step at which this block's run of the tile began
  if (nk > 0) {
    int m, n;
    unit(0, k_first, m, n);
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int sb = kt % C::kStagesB;
    mbar_wait(&full_b[sb], (kt / C::kStagesB) & 1);
    const uint8_t* bbox = ring_b + sb * C::kBBytes + cw * kBox;
    if (C::kConvert) {
      // this warpgroup's 64 x 64 float32 block of B into a bf16 box in
      // the layout TMA would give it: 128-byte rows, 16-byte chunks
      // swizzled by the row's index mod 8. The box was last read by the
      // wgmma of step kt - 2, which wgmma_wait<1> at step kt - 1 retired.
      uint8_t* box = conv + (2 * cw + kt % 2) * kBox;
      const float* src =
          reinterpret_cast<const float*>(ring_b + sb * C::kBBytes) + 64 * cw;
#pragma unroll
      for (int c = t; c < 64 * 8; c += 128) {
        const int row = c / 8, ch = c % 8;
        const float4 lo =
            *reinterpret_cast<const float4*>(src + row * kBN + 8 * ch);
        const float4 hi =
            *reinterpret_cast<const float4*>(src + row * kBN + 8 * ch + 4);
        __nv_bfloat162 v[4] = {__floats2bfloat162_rn(lo.x, lo.y),
                               __floats2bfloat162_rn(lo.z, lo.w),
                               __floats2bfloat162_rn(hi.x, hi.y),
                               __floats2bfloat162_rn(hi.z, hi.w)};
        *reinterpret_cast<uint4*>(box + row * 128 + ((ch ^ (row % 8)) * 16)) =
            *reinterpret_cast<uint4*>(v);
      }
      // the generic-proxy stores must be visible to wgmma (async proxy)
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      if (cw == 0)
        asm volatile("bar.sync 1, 128;" ::: "memory");
      else
        asm volatile("bar.sync 2, 128;" ::: "memory");
      if (t % 32 == 0) mbar_arrive(&empty_b[sb]);  // float32 stage read
      bbox = box;
    }
    const int sa = kt % C::kStagesA;
    mbar_wait(&full_a[sa], (kt / C::kStagesA) & 1);
    const uint8_t* abox = ring_a + sa * C::kABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t db = desc(bbox + kk * 16 * 128, kBox, 1024);
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        wgmma_64(d[i], desc(abox + i * kBox + kk * 32, 16, 1024), db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // one group in flight: step kt - 1's stages are free
    if (kt > 0 && t % 32 == 0) {
      mbar_arrive(&empty_a[(kt - 1) % C::kStagesA]);
      if (!C::kConvert) mbar_arrive(&empty_b[(kt - 1) % C::kStagesB]);
    }

    int k, m, n;
    unit(kt, k, m, n);
    if (k + 1 < steps && kt + 1 < nk) continue;
    // the end of this block's run of the tile at (m, n): store and reset.
    // d[i][4 j + 2 h + e] holds row 64 i + 16 w + t / 4 + 8 h, column
    // 8 j + 2 (t % 4) + e of this warpgroup's 64 columns (w = warp in the
    // group).
    wgmma_wait<0>();
    const bool with_r = r != nullptr && k_first == 0;
    const int row = m + (t / 32) * 16 + (t % 32) / 4;
    const int col = n + 64 * cw + 2 * (t % 4);
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gi = row + 64 * i + 8 * h, gj = col + 8 * j;
          bool x0 = d[i][4 * j + 2 * h] > 0.0f;
          bool x1 = d[i][4 * j + 2 * h + 1] > 0.0f;
          d[i][4 * j + 2 * h] = d[i][4 * j + 2 * h + 1] = 0.0f;
          if (with_r && gi < M) or_pair(r, ldr, N, gi, gj, x0, x1);
          store_pair(out, ldc, M, N, gi, gj, x0, x1, false);
        }
    k_first = 0;  // the next tile's run starts at its K step 0
  }
  wgmma_wait<0>();
}

}  // namespace sk

// ------------------------------------------------------------------ //
// Host side
// ------------------------------------------------------------------ //
enum Route { kWgmma = 0, kSplitK = 1 };

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded (no
// -lcuda at link time).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major (rows, cols) matrix of T with row pitch ld (elements) as a
// tensor map of box_rows x box_cols boxes: bf16 128-byte swizzled (the
// wgmma layout), float32 plain.
template <typename T>
bool encode(EncodeTiled enc, CUtensorMap* map, const T* p, int rows,
            int cols, int64_t ld, int box_cols, int box_rows) {
  const bool f32 = sizeof(T) == 4;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map,
             f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             2, const_cast<T*>(p), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             f32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int stage(const T* src, int64_t ld, int rows, int cols, bf16* dst,
          int64_t ldd, cudaStream_t stream) {
  const int64_t pairs = static_cast<int64_t>(rows) * (ldd / 2);
  if (pairs == 0) return cudaSuccess;
  const int blocks = static_cast<int>(
      pairs / 256 + 1 < 132 * 16 ? pairs / 256 + 1 : 132 * 16);
  stage_kernel<T><<<blocks, 256, 0, stream>>>(src, ld, rows, cols, dst, ldd);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_wgmma(const bf16* a, const bf16* b, int64_t lda, int64_t ldb,
                 const T* r, T* out, int M, int N, int K, int64_t ldc,
                 int64_t ldr, cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap map_a, map_b;
  if (!encode(enc, &map_a, a, M, K, lda, 64, wg::kBM) ||
      !encode(enc, &map_b, b, K, N, ldb, 64, wg::kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        wg::wgmma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        wg::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const int tiles = ((M + wg::kBM - 1) / wg::kBM) *
                    ((N + wg::kBN - 1) / wg::kBN);
  wg::wgmma_kernel<T><<<tiles, wg::kThreads, wg::kSmem, stream>>>(
      map_a, map_b, r, out, M, N, K, ldc, ldr);
  return static_cast<int>(cudaGetLastError());
}

// The split-K kernel on one block for each SM.
template <typename T, typename TOut>
int launch_splitk(const bf16* a, const T* b, int64_t lda, int64_t ldb,
                  const TOut* r, TOut* out, int M, int N, int K, int64_t ldc,
                  int64_t ldr, cudaStream_t stream) {
  using C = sk::Cfg<T>;
  cudaError_t err = cudaMemset2DAsync(out, ldc * sizeof(TOut), 0,
                                      N * sizeof(TOut), M, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (K == 0) {  // nothing to multiply: out = r, or zeros
    if (r == nullptr) return cudaSuccess;
    return static_cast<int>(cudaMemcpy2DAsync(
        out, ldc * sizeof(TOut), r, ldr * sizeof(TOut), N * sizeof(TOut), M,
        cudaMemcpyDeviceToDevice, stream));
  }
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap map_a, map_b;
  if (!encode(enc, &map_a, a, M, K, lda, 64, 64) ||
      !encode(enc, &map_b, b, K, N, ldb, C::kConvert ? sk::kBN : 64,
              sk::kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool sized = false;
  if (!sized) {
    err = cudaFuncSetAttribute(sk::splitk_kernel<T, TOut>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t units = static_cast<int64_t>((K + sk::kBK - 1) / sk::kBK) *
                        ((M + sk::kBM - 1) / sk::kBM) *
                        ((N + sk::kBN - 1) / sk::kBN);
  const int64_t per = (units + sms - 1) / sms;
  if (per >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>((units + per - 1) / per);
  sk::splitk_kernel<T, TOut><<<grid, sk::kThreads, C::kSmem, stream>>>(
      map_a, map_b, r, out, M, N, K, ldc, ldr, static_cast<int>(per));
  return static_cast<int>(cudaGetLastError());
}

// out = (a @ b) > 0 (or max(r, ...)) through the given route. sa / sb,
// when given, receive bf16 copies of a / b (pitches lsa / lsb) that the
// product then reads; sb == sa stages a once for both operands. The
// wgmma kernel reads bf16 operands only; the split-K kernel a bf16 a and
// a float32 or bf16 b.
template <typename T>
int product(const T* a, const T* b, const T* r, T* out, int M, int N, int K,
            int64_t lda, int64_t ldb, int64_t ldc, int64_t ldr, int route,
            bf16* sa, int64_t lsa, bf16* sb, int64_t lsb,
            cudaStream_t stream) {
  constexpr bool is_bf16 = sizeof(T) == 2;
  if ((route != kWgmma && route != kSplitK) ||
      (!is_bf16 && sa == nullptr) ||
      (route == kWgmma && ((!is_bf16 && sb == nullptr) || K == 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* oa = reinterpret_cast<const bf16*>(a);
  const bf16* ob = reinterpret_cast<const bf16*>(b);
  int64_t la = lda, lb = ldb;
  if (sa != nullptr) {
    const int err = stage(a, lda, M, K, sa, lsa, stream);
    if (err) return err;
    oa = sa, la = lsa;
  }
  if (sb != nullptr) {
    if (sb != sa) {
      const int err = stage(b, ldb, K, N, sb, lsb, stream);
      if (err) return err;
    }
    ob = sb, lb = lsb;
  }
  if (route == kWgmma)
    return launch_wgmma<T>(oa, ob, la, lb, r, out, M, N, K, ldc, ldr,
                           stream);
  if constexpr (!is_bf16) {  // float32 b streams as it is unless staged
    if (sb == nullptr)
      return launch_splitk<float, T>(oa, b, la, ldb, r, out, M, N, K, ldc,
                                     ldr, stream);
  }
  return launch_splitk<bf16, T>(oa, ob, la, lb, r, out, M, N, K, ldc, ldr,
                                stream);
}

}  // namespace

// Dynamic shared memory (bytes) of a block: route 0 the wgmma kernel,
// route 1 the split-K kernel with float32 (f32_b = 1) or bf16 b; for the
// build log.
extern "C" int rlc_semiring_smem_bytes(int route, int f32_b) {
  if (route == kWgmma) return wg::kSmem;
  return f32_b ? sk::Cfg<float>::kSmem : sk::Cfg<bf16>::kSmem;
}

// out (M, N) = (a (M, K) @ b (K, N)) > 0; row pitches in elements; is_bf16 =
// 1 for bfloat16 operands and output, 0 for float32; route 0 = TMA + wgmma,
// 1 = split-K; sa / sb (or null) are the staging buffers for a / b with
// pitches lsa / lsb.
extern "C" int rlc_bool_matmul(const void* a, const void* b, void* out,
                               int M, int N, int K, int64_t lda, int64_t ldb,
                               int64_t ldc, int is_bf16, int route, void* sa,
                               int64_t lsa, void* sb, int64_t lsb,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return product(static_cast<const bf16*>(a),
                   static_cast<const bf16*>(b), (const bf16*)nullptr,
                   static_cast<bf16*>(out), M, N, K, lda, ldb, ldc, 0,
                   route, static_cast<bf16*>(sa), lsa,
                   static_cast<bf16*>(sb), lsb, st);
  return product(static_cast<const float*>(a), static_cast<const float*>(b),
                 (const float*)nullptr, static_cast<float*>(out), M, N, K,
                 lda, ldb, ldc, 0, route, static_cast<bf16*>(sa),
                 lsa, static_cast<bf16*>(sb), lsb, st);
}

// out (n, n) = max(r, (r @ r) > 0); out must not alias r; sa / sb (or
// null) are the staging buffers of r as the left / right operand, pitch
// lsr; sb == sa stages r once for both.
extern "C" int rlc_closure_step(const void* r, void* out, int n,
                                int64_t ldr, int64_t ldc, int is_bf16,
                                int route, void* sa, void* sb,
                                int64_t lsr, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* s_a = static_cast<bf16*>(sa);
  bf16* s_b = static_cast<bf16*>(sb);
  if (is_bf16) {
    const bf16* x = static_cast<const bf16*>(r);
    return product(x, x, x, static_cast<bf16*>(out), n, n, n, ldr, ldr,
                   ldc, ldr, route, s_a, lsr, s_b, lsr, st);
  }
  const float* x = static_cast<const float*>(r);
  return product(x, x, x, static_cast<float*>(out), n, n, n, ldr, ldr, ldc,
                 ldr, route, s_a, lsr, s_b, lsr, st);
}
