// Hopper (sm_90a) building blocks shared by the kernels of deepspeed_tpu_torch
// that stream tiles with the Tensor Memory Accelerator (TMA) and multiply
// them with warpgroup MMA (wgmma): tensor maps built on the host, mbarriers,
// TMA loads and stores, wgmma shared-memory descriptors, fences and the
// wgmma instructions themselves, and setmaxnreg for warp specialisation.
// Header only; the builder hashes it with every source.
//
// Layout convention: every tile lives in shared memory as rows of 128 bytes
// (64 16-bit values) in the 128-byte swizzle TMA writes
// (CU_TENSOR_MAP_SWIZZLE_128B): the 16-byte chunk c of row r sits at chunk
// c ^ (r % 8). A row wider than 64 values is cut into 64-column boxes, each
// box a dense [rows][128 B] block; every box starts on a 1024-byte boundary.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums only: nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace dstt {

// ------------------------------------------------------------------ host

typedef CUresult (*TensorMapEncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded (no
// -lcuda, so the build flags stay those of every other library); null when
// the driver does not have it.
static inline TensorMapEncodeTiledFn tensor_map_encoder() {
  static TensorMapEncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<TensorMapEncodeTiledFn>(p);
  }();
  return fn;
}

// A 4-D tensor map over a [n3][n2][n1][n0] array of 16-bit values read
// through its strides (in elements; the innermost dimension is contiguous),
// loading or storing boxes of `rows` rows along dimension 2 by 64 columns,
// with the 128-byte swizzle. n0 is the true head dim, any multiple of 8 up
// to the kernel's width (64 * k): a box at column 64 j holds the columns
// from 64 j up to n0 and zeros after them. Elements past the array (rows
// or columns) read as zero and are not written; a load's mbarrier still
// counts the whole box's bytes. Returns false when cuTensorMapEncodeTiled
// refuses the map (a base not 16-byte aligned, a stride not a multiple of
// 16 bytes).
template <typename T>
static inline bool make_tile_map(CUtensorMap* map, const void* base, long long n0,
                                 long long n1, long long n2, long long n3,
                                 long long s1, long long s2, long long s3,
                                 int rows) {
  static_assert(sizeof(T) == 2, "16-bit tiles only");
  TensorMapEncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const CUtensorMapDataType dt = std::is_same<T, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t dims[4] = {(cuuint64_t)n0, (cuuint64_t)n1, (cuuint64_t)n2, (cuuint64_t)n3};
  const cuuint64_t strides[3] = {(cuuint64_t)s1 * 2, (cuuint64_t)s2 * 2, (cuuint64_t)s3 * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return encode(map, dt, 4, const_cast<void*>(base), dims, strides, box, estride,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 2-D tensor map over `rows` rows of n f32 values each (an LSE or delta
// row per head), `stride` values apart (a multiple of 4: 16 bytes),
// loading boxes of `box` values of one row, unswizzled. Values past n read
// as zero. Returns false when the driver refuses it.
static inline bool make_row_map(CUtensorMap* map, const float* base, long long n,
                                long long rows, long long stride, int box) {
  TensorMapEncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)stride * 4};
  const cuuint32_t boxes[2] = {(cuuint32_t)box, 1};
  const cuuint32_t estride[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims,
                strides, boxes, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers (shared::cta), addressed by their shared-space address
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar)
               : "memory");
}
// one arrival that also announces `bytes` of TMA traffic to come
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: one box at coordinates (c0, c1, c2, c3), innermost first
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// commit this thread's TMA stores and wait until their shared-memory reads are done
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// generic-proxy writes to shared memory, made visible to TMA and wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a barrier over `count` threads (named barrier `id`; 0 is __syncthreads')
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// warp specialisation: give registers back / take them, per warpgroup. Only
// honoured when each role's code is one branch that never rejoins the other
// (ptxas warns C7508 otherwise).
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (in bytes here, 16-byte units in
// the descriptor), layout type 1 (128B swizzle).
//  * K-major (the reduction dimension contiguous, as a row of q or k):
//    lbo unused (1), sbo = 1024 (8 rows of 128 B); the k-th slice of 16
//    values starts 32 B further within the same rows, in the next 64-column
//    box from slice 4 on.
//  * MN-major (the output dimension contiguous, as v's D in P.V): sbo =
//    1024 (the next 8 rows along K), lbo = the distance between the 64-column
//    boxes along N; the k-th slice of 16 rows starts 2048 B further.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of an accumulator register
// across the asynchronous wgmma that owns it
template <int N> __device__ __forceinline__ void wgmma_fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, f32) (+)= A (64 x 16) . B (16 x N): A and B from shared memory
// (descriptors), TA/TB 1 for an MN-major operand; scale_d 0 overwrites D.
template <typename T, int TA, int TB>
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
#define DSTT_WGMMA_ASM(TY)                                                                                       \
  asm volatile(                                                                                                  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                                               \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                                              \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"                                    \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"                          \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"                          \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"                           \
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"                                                                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),          \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),  \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),  \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])   \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB))
  if constexpr (std::is_same<T, __nv_bfloat16>::value) DSTT_WGMMA_ASM("bf16");
  else DSTT_WGMMA_ASM("f16");
#undef DSTT_WGMMA_ASM
}

// the same at N = 64. FRESH: the first slice of a product, D = A.B: D is
// an output only (scale-d 0), so its old values need not stay live before
// it (an accumulator carried across a loop otherwise holds its registers)
template <typename T, int TA, int TB, bool FRESH = false>
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b) {
#define DSTT_WGMMA_ASM(TY, C)                                                                                    \
  asm volatile(                                                                                                  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                                               \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                                               \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"                                    \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"                           \
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"                                                                     \
      : C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]),                                  \
        C(d[8]), C(d[9]), C(d[10]), C(d[11]), C(d[12]), C(d[13]), C(d[14]), C(d[15]),                            \
        C(d[16]), C(d[17]), C(d[18]), C(d[19]), C(d[20]), C(d[21]), C(d[22]), C(d[23]),                          \
        C(d[24]), C(d[25]), C(d[26]), C(d[27]), C(d[28]), C(d[29]), C(d[30]), C(d[31])                           \
      : "l"(desc_a), "l"(desc_b), "r"(FRESH ? 0 : 1), "n"(TA), "n"(TB))
#define DSTT_OUT(x) "=f"(x)
#define DSTT_INOUT(x) "+f"(x)
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if constexpr (FRESH) DSTT_WGMMA_ASM("bf16", DSTT_OUT);
    else DSTT_WGMMA_ASM("bf16", DSTT_INOUT);
  } else {
    if constexpr (FRESH) DSTT_WGMMA_ASM("f16", DSTT_OUT);
    else DSTT_WGMMA_ASM("f16", DSTT_INOUT);
  }
#undef DSTT_INOUT
#undef DSTT_OUT
#undef DSTT_WGMMA_ASM
}

// the same at N = 32
template <typename T, int TA, int TB, bool FRESH = false>
__device__ __forceinline__ void wgmma_ss_m64n32k16(float (&d)[16], uint64_t desc_a,
                                                   uint64_t desc_b) {
#define DSTT_WGMMA_ASM(TY, C)                                                                                    \
  asm volatile(                                                                                                  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                                                               \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"                                               \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"                                     \
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"                                                                     \
      : C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]),                                  \
        C(d[8]), C(d[9]), C(d[10]), C(d[11]), C(d[12]), C(d[13]), C(d[14]), C(d[15])                             \
      : "l"(desc_a), "l"(desc_b), "r"(FRESH ? 0 : 1), "n"(TA), "n"(TB))
#define DSTT_OUT(x) "=f"(x)
#define DSTT_INOUT(x) "+f"(x)
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if constexpr (FRESH) DSTT_WGMMA_ASM("bf16", DSTT_OUT);
    else DSTT_WGMMA_ASM("bf16", DSTT_INOUT);
  } else {
    if constexpr (FRESH) DSTT_WGMMA_ASM("f16", DSTT_OUT);
    else DSTT_WGMMA_ASM("f16", DSTT_INOUT);
  }
#undef DSTT_INOUT
#undef DSTT_OUT
#undef DSTT_WGMMA_ASM
}

// D (64 x N, f32) (+)= A (64 x 16, registers: the m16n8k16 A fragment of
// each warp's 16 rows) . B (16 x N, shared memory); TB 1 for MN-major B.
template <typename T, int N, int TB> struct WgmmaRS;

template <typename T, int TB> struct WgmmaRS<T, 64, TB> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
#define DSTT_WGMMA_ASM(TY)                                                                                       \
  asm volatile(                                                                                                  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                                               \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                                               \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"                                    \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"                           \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"                                                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),          \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])   \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TB))
    if constexpr (std::is_same<T, __nv_bfloat16>::value) DSTT_WGMMA_ASM("bf16");
    else DSTT_WGMMA_ASM("f16");
#undef DSTT_WGMMA_ASM
  }
};

template <typename T, int TB> struct WgmmaRS<T, 128, TB> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
#define DSTT_WGMMA_ASM(TY)                                                                                       \
  asm volatile(                                                                                                  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                                               \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                                              \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"                                    \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"                          \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"                          \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"                           \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"                                                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),          \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),  \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),  \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])   \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TB))
    if constexpr (std::is_same<T, __nv_bfloat16>::value) DSTT_WGMMA_ASM("bf16");
    else DSTT_WGMMA_ASM("f16");
#undef DSTT_WGMMA_ASM
  }
};

}  // namespace dstt
