// Device helpers shared by the attention kernels of deepspeed_tpu_torch:
// dtype conversions (int8 included), the bf16/fp16 tensor-core product
// (mma.sync m16n8k16), ldmatrix and cp.async, and the timing hooks. Header only; each kernel source
// includes it, and the builder hashes it with every source.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Timing hooks of the attention kernels: DSTT_STAMP(k) marks point k of a
// block's run (0 entry, 1 first K/V stage landed, 2 key loop done, 3
// arrival ticket taken, 4 exit, 5 exit of a split with no key). Empty
// unless the source defines DSTT_STAMPS and a device function
// `dstt_stamp(int)` ahead of its includes, as scripts/stamp_paged_kernels.py
// and scripts/stamp_decode_sparse.py do in an instrumented copy.
#ifdef DSTT_STAMPS
#define DSTT_STAMP(k) dstt_stamp(k)
#else
#define DSTT_STAMP(k) ((void)0)
#endif

namespace dstt {

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }
template <> __device__ __forceinline__ __half from_float<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }

// two floats -> one 32-bit register of two storage-dtype values (lo first)
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (16x8, f32) += A (16x16, row) . B (16x8, col)
template <typename T> __device__ __forceinline__ void mma16816(float* d, const uint32_t* a, const uint32_t* b);
template <> __device__ __forceinline__ void mma16816<__nv_bfloat16>(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <> __device__ __forceinline__ void mma16816<__half>(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// 16-byte global -> shared copy; zero-fills when !valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(gmem), "r"(n));
}
// 4-byte global -> shared copy (one f32 scale); zero-fills when !valid
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace dstt
