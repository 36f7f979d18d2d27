// Fused LayerNorm forward and backward for Hopper (sm_90a): kernels B9, B10.
//
// Replace the Pallas kernels of deepspeed_tpu/ops/pallas/layer_norm.py:
//  * B9 `_ln_fwd_kernel` (:28): per row of x [R, N], f32 statistics with a
//    two-pass variance, mean((x - mean)^2); rstd = rsqrt(var + eps);
//    o = ((x - mean) * rstd) * w + b in x's dtype; mean and rstd [R] f32 are
//    kept for the backward.
//  * B10 `_ln_bwd_kernel` (:41): dx = rstd * (gw - mean(gw) - xhat *
//    mean(gw * xhat)) with gw = g * w, in x's dtype; dw = sum over rows of
//    g * xhat and db = sum of g, in f32.
//
// What bounds them on the H100: bytes. A few operations per element against
// 2 (B9: read x, write o) or 3 (B10: read x and g, write dx) elements moved;
// at the GPT-2 1.3B training shape (x [8192, 2048] bf16) that is ~67 MB and
// ~101 MB, ~0.020 ms and ~0.030 ms at 3.35 TB/s.
//
// Design:
//  * B9: one warp per row. Rows of 16-byte chunks (N a multiple of 16
//    bytes, 16-byte aligned pointers) of at most 8 KB (bf16/fp16 N <= 4096,
//    f32 N <= 2048) take a persistent kernel that keeps a steady stream of
//    loads in flight:
//    - a grid of as many 8-warp blocks as fit on the card at once, each
//      warp taking rows warp, warp + W, ... (W the grid's warps; a static
//      stride, no tile counter);
//    - each warp streams its rows through a ring of 3 row slots in shared
//      memory by 16-byte cp.async, two rows ahead of the one it reduces;
//      each lane copies and later reads only its own chunks (CPL 16-byte
//      chunks a lane, a template parameter: 1, 2, 4, 8 or 16), so the ring
//      needs no barrier;
//    - the row under work lives in registers at 16 bits; the two-pass
//      variance reads the registers, not memory;
//    - w and b are staged once per block in shared memory as f32, in
//      float4 planes by chunk (plane p of chunk c holds elements 8c+4p ..
//      8c+4p+3 at 16-bit x), so each lane reads them as float4s without
//      bank conflicts;
//    - o is written with streaming stores (st.global.cs): nothing reads it
//      back in this kernel.
//    Other rows (scalar, or wider) take a warp per row with the row kept
//    in shared memory (in x's dtype) for the variance and output passes,
//    unless 4 rows of N no longer fit, where those passes read it again
//    (from L2). Both give each row the same f32 sums in the same order.
//  * B10: the TPU kernel sums dw and db over row blocks on its sequential
//    grid with a VMEM carry; blocks on the card run in no order, so it takes
//    two stages, deterministic, without atomics:
//    - stage 1: block p walks a contiguous range of rows; each thread owns
//      fixed columns (in 16-byte chunks) and keeps the next row's x and g in
//      registers while it finishes this one. mean(gw) and mean(gw * xhat)
//      are one block-wide reduction per row, in a fixed order; each
//      thread adds g * xhat and g of its columns to f32 sums in registers
//      and, at the end, writes them to row p of a [2, P, N] scratch.
//    - stage 2: one block per 32 columns sums the P partial rows, 8 warps
//      over interleaved rows, then the 8 warp sums in order.
//    The same inputs on the same card give the same bits on every run.
//
// C interface (nvcc -shared, loaded with ctypes): each launch returns
// cudaGetLastError() so the Python wrapper can raise.

#include <algorithm>

#include "attention_common.cuh"

namespace {

using namespace dstt;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T e[VEC];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ------------------------------------------------------------------ B9

constexpr int FWD_WARPS = 4;
constexpr size_t FWD_MAX_SMEM = 160 * 1024;   // rows cached in shared memory
constexpr int ROW_WARPS = 8;     // persistent kernel: warps a block
constexpr int ROW_MAX_CPL = 16;  // 16-byte chunks a lane: rows of <= 8 KB

// SMs of the current device, read once per device
inline int sm_count() {
  static int cache[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!cache[dev]) cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount, dev);
  return cache[dev];
}

// Elements 2k and 2k+1 of a 16-byte chunk as f32. `dep`, a value the
// pass depends on anyway, keeps the compiler from merging one pass's
// conversions with another's: each pass widens the 16-bit words again, so
// the row stays in registers at 16 bits (half the registers) between
// passes instead of as f32 copies.
template <typename T>
__device__ __forceinline__ float2 pair(const uint4& c, int k, float dep);
template <>
__device__ __forceinline__ float2 pair<float>(const uint4& c, int k, float) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
  return make_float2(__uint_as_float(w[2 * k]), __uint_as_float(w[2 * k + 1]));
}
template <>
__device__ __forceinline__ float2 pair<__nv_bfloat16>(const uint4& c, int k, float dep) {
  const uint32_t w = k == 0 ? c.x : k == 1 ? c.y : k == 2 ? c.z : c.w;
  float lo, hi;   // a bf16 is the high half of an f32
  asm("{\n\t shl.b32 %0, %2, 16;\n\t and.b32 %1, %2, 0xffff0000;\n\t}"
      : "=f"(lo), "=f"(hi) : "r"(w), "f"(dep));
  return make_float2(lo, hi);
}
template <>
__device__ __forceinline__ float2 pair<__half>(const uint4& c, int k, float dep) {
  const uint32_t w = k == 0 ? c.x : k == 1 ? c.y : k == 2 ? c.z : c.w;
  float lo, hi;
  asm("{\n\t .reg .b16 l, h;\n\t mov.b32 {l, h}, %2;\n\t cvt.f32.f16 %0, l;\n\t"
      " cvt.f32.f16 %1, h;\n\t}"
      : "=f"(lo), "=f"(hi) : "r"(w), "f"(dep));
  return make_float2(lo, hi);
}

// a 16-byte store marked evict-first: the output is not read again here
__device__ __forceinline__ void store_streaming(void* dst, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1,%2,%3,%4};"
               :: "l"(dst), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// mean and rstd of one row held as CPL 16-byte chunks a lane, then its
// output from the staged w and b planes; the same f32 sums, in the same
// order, as ln_fwd_row
template <typename T, int CPL>
__device__ __forceinline__ void ln_fwd_ring_row(const uint4 (&v)[CPL],
                                                const float4* wb, int chunks,
                                                T* __restrict__ orow, int N,
                                                float eps, int lane,
                                                float* mean_out, float* rstd_out) {
  constexpr int V = 16 / sizeof(T), P = V / 4;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i)
    if (lane + 32 * i < chunks) {
#pragma unroll
      for (int k = 0; k < V / 2; ++k) {
        const float2 f = pair<T>(v[i], k, 0.f);
        s += f.x;
        s += f.y;
      }
    }
  const float mu = warp_sum(s) / N;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i)
    if (lane + 32 * i < chunks) {
#pragma unroll
      for (int k = 0; k < V / 2; ++k) {
        const float2 f = pair<T>(v[i], k, mu);
        ss += (f.x - mu) * (f.x - mu);
        ss += (f.y - mu) * (f.y - mu);
      }
    }
  const float rs = rsqrtf(warp_sum(ss) / N + eps);
  Pack<T, V>* dst = reinterpret_cast<Pack<T, V>*>(orow);
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    if (c >= chunks) continue;
    Pack<T, V> out;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float4 wv = wb[p * chunks + c], bv = wb[(P + p) * chunks + c];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float2 f = pair<T>(v[i], 2 * p + k, rs);
        const int e = 4 * p + 2 * k;
        out.e[e] = from_float<T>((f.x - mu) * rs * lane_of(wv, 2 * k) + lane_of(bv, 2 * k));
        out.e[e + 1] = from_float<T>((f.y - mu) * rs * lane_of(wv, 2 * k + 1) + lane_of(bv, 2 * k + 1));
      }
    }
    store_streaming(dst + c, *reinterpret_cast<const uint4*>(&out));
  }
  if (lane == 0) {
    *mean_out = mu;
    *rstd_out = rs;
  }
}

// the persistent kernel: rows of N / V 16-byte chunks, at most 32 * CPL.
// Each warp streams its rows through a ring of ROW_DEPTH row slots in
// shared memory by 16-byte cp.async, ROW_DEPTH - 1 rows ahead; each lane
// copies and later reads only its own chunks, so the ring needs no barrier.
constexpr int ROW_DEPTH = 3;

template <typename T, int CPL>
__global__ void __launch_bounds__(ROW_WARPS * 32)
ln_fwd_ring_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, T* __restrict__ o,
                   float* __restrict__ mean, float* __restrict__ rstd, int R,
                   int N, float eps) {
  constexpr int V = 16 / sizeof(T), P = V / 4;
  extern __shared__ float4 wb[];   // [2][P][chunks]: w's planes, then b's;
  const int chunks = N / V, lane = threadIdx.x % 32;   // then the rings
  uint4* ring = reinterpret_cast<uint4*>(wb + 2 * P * chunks) +
                (threadIdx.x / 32) * ROW_DEPTH * CPL * 32;
  const long long stride = (long long)gridDim.x * ROW_WARPS;
  const long long r0 = (long long)blockIdx.x * ROW_WARPS + threadIdx.x / 32;

  auto issue = [&](long long row, int slot) {
    const uint4* src = reinterpret_cast<const uint4*>(x + row * N);
#pragma unroll
    for (int i = 0; i < CPL; ++i)
      if (lane + 32 * i < chunks)
        cp_async16(ring + slot * CPL * 32 + lane + 32 * i, src + lane + 32 * i, true);
  };
#pragma unroll
  for (int d = 0; d < ROW_DEPTH - 1; ++d) {   // in flight while w and b are staged
    if (r0 + d * stride < R) issue(r0 + d * stride, d);
    cp_async_commit();
  }
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int col = i * V + 4 * p;
      wb[p * chunks + i] = make_float4(__ldg(w + col), __ldg(w + col + 1),
                                       __ldg(w + col + 2), __ldg(w + col + 3));
      wb[(P + p) * chunks + i] = make_float4(__ldg(b + col), __ldg(b + col + 1),
                                             __ldg(b + col + 2), __ldg(b + col + 3));
    }
  }
  __syncthreads();   // the only block-wide barrier
  int slot = 0;
  for (long long r = r0; r < R; r += stride) {
    const long long ahead = r + (ROW_DEPTH - 1) * stride;
    if (ahead < R) issue(ahead, (slot + ROW_DEPTH - 1) % ROW_DEPTH);
    cp_async_commit();
    cp_async_wait<ROW_DEPTH - 1>();   // this lane's copies of row r landed
    uint4 v[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i)
      if (lane + 32 * i < chunks) v[i] = ring[slot * CPL * 32 + lane + 32 * i];
    ln_fwd_ring_row<T, CPL>(v, wb, chunks, o + r * N, N, eps, lane, mean + r, rstd + r);
    slot = slot + 1 == ROW_DEPTH ? 0 : slot + 1;
  }
}

template <typename T, int CPL>
cudaError_t launch_fwd_ring(const void* x, const float* w, const float* b,
                            void* o, float* mean, float* rstd, int R, int N,
                            float eps, cudaStream_t s) {
  const size_t smem = 2 * (size_t)N * sizeof(float) +
                      (size_t)ROW_WARPS * ROW_DEPTH * CPL * 32 * 16;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ln_fwd_ring_kernel<T, CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (attr != cudaSuccess) return attr;
  // blocks that fit on an SM, for this instantiation and the last smem size
  static size_t last_smem = 0;
  static int per_sm = 0;
  if (smem != last_smem || per_sm == 0) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ln_fwd_ring_kernel<T, CPL>, ROW_WARPS * 32, smem);
    if (e != cudaSuccess) return e;
    last_smem = smem;
  }
  const long long want = ((long long)R + ROW_WARPS - 1) / ROW_WARPS;
  const int grid = (int)std::min<long long>(want, (long long)std::max(per_sm, 1) * sm_count());
  if (grid <= 0) return cudaErrorInvalidValue;
  ln_fwd_ring_kernel<T, CPL><<<grid, ROW_WARPS * 32, smem, s>>>(
      static_cast<const T*>(x), w, b, static_cast<T*>(o), mean, rstd, R, N, eps);
  return cudaGetLastError();
}

// Visit row `src` in chunks of VEC elements per lane: f(col, v) for each
// element value v (as float) of column col. VEC = 1 is the scalar path.
template <typename T, int VEC, typename F>
__device__ __forceinline__ void row_pass(const T* src, int N, int lane, F f) {
  for (int c = lane; c < N / VEC; c += 32) {
    const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(src + c * VEC);
#pragma unroll
    for (int i = 0; i < VEC; ++i) f(c * VEC + i, to_float(p.e[i]));
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void ln_fwd_row(const T* __restrict__ xr, T* cache,
                                           const float* __restrict__ w,
                                           const float* __restrict__ b,
                                           T* __restrict__ orow, int N,
                                           float eps, int lane, float* mean_out,
                                           float* rstd_out) {
  float s = 0.f;
#pragma unroll 4
  for (int c = lane; c < N / VEC; c += 32) {   // 4 loads in flight a lane
    const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xr + c * VEC);
    if (cache) *reinterpret_cast<Pack<T, VEC>*>(cache + c * VEC) = p;
#pragma unroll
    for (int i = 0; i < VEC; ++i) s += to_float(p.e[i]);
  }
  const float mu = warp_sum(s) / N;
  __syncwarp();   // the row cache written by every lane
  const T* src = cache ? cache : xr;
  float ss = 0.f;
  row_pass<T, VEC>(src, N, lane, [&](int, float v) { ss += (v - mu) * (v - mu); });
  const float rs = rsqrtf(warp_sum(ss) / N + eps);
  for (int c = lane; c < N / VEC; c += 32) {
    const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(src + c * VEC);
    Pack<T, VEC> out;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int col = c * VEC + i;
      const float xhat = (to_float(p.e[i]) - mu) * rs;
      out.e[i] = from_float<T>(xhat * __ldg(w + col) + __ldg(b + col));
    }
    *reinterpret_cast<Pack<T, VEC>*>(orow + c * VEC) = out;
  }
  if (lane == 0) {
    *mean_out = mu;
    *rstd_out = rs;
  }
}

template <typename T>
__global__ void __launch_bounds__(FWD_WARPS * 32)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ b, T* __restrict__ o,
              float* __restrict__ mean, float* __restrict__ rstd, int R, int N,
              float eps, int vec, int cache) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long r = (long long)blockIdx.x * FWD_WARPS + warp;
  if (r >= R) return;   // no block-wide barrier in this kernel
  T* row_cache = cache ? reinterpret_cast<T*>(smem_raw) + (size_t)warp * N : nullptr;
  if (vec)
    ln_fwd_row<T, V>(x + r * N, row_cache, w, b, o + r * N, N, eps, lane, mean + r, rstd + r);
  else
    ln_fwd_row<T, 1>(x + r * N, row_cache, w, b, o + r * N, N, eps, lane, mean + r, rstd + r);
}

// rows of at most 32 * ROW_MAX_CPL 16-byte chunks take the persistent
// kernel, the rest ln_fwd_kernel
template <typename T>
cudaError_t launch_fwd(const void* x, const float* w, const float* b, void* o,
                       float* mean, float* rstd, int R, int N, float eps,
                       int vec, cudaStream_t s) {
  const int per_lane = (N / (16 / (int)sizeof(T)) + 31) / 32;
  if (vec && per_lane <= ROW_MAX_CPL) {
    if (per_lane <= 1) return launch_fwd_ring<T, 1>(x, w, b, o, mean, rstd, R, N, eps, s);
    if (per_lane <= 2) return launch_fwd_ring<T, 2>(x, w, b, o, mean, rstd, R, N, eps, s);
    if (per_lane <= 4) return launch_fwd_ring<T, 4>(x, w, b, o, mean, rstd, R, N, eps, s);
    if (per_lane <= 8) return launch_fwd_ring<T, 8>(x, w, b, o, mean, rstd, R, N, eps, s);
    return launch_fwd_ring<T, 16>(x, w, b, o, mean, rstd, R, N, eps, s);
  }
  const size_t rows_bytes = (size_t)FWD_WARPS * N * sizeof(T);
  const int cache = rows_bytes <= FWD_MAX_SMEM;
  const size_t smem = cache ? rows_bytes : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ln_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  ln_fwd_kernel<T><<<(R + FWD_WARPS - 1) / FWD_WARPS, FWD_WARPS * 32, smem, s>>>(
      static_cast<const T*>(x), w, b, static_cast<T*>(o), mean, rstd, R, N, eps, vec, cache);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ B10

// stage 1: dx of rows [p * rows_per, ...) and their partial column sums
template <typename T, int VEC, int CPT>
__global__ void __launch_bounds__(CPT < 8 ? 256 : 1024)
ln_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ mean, const float* __restrict__ rstd,
                   const T* __restrict__ g, T* __restrict__ dx,
                   float* __restrict__ part, int R, int N, int rows_per) {
  __shared__ float2 red[2][32];   // [row parity][warp]: (sum gw, sum gw*xhat)
  const int NT = blockDim.x, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nwarps = NT / 32;
  const int P = gridDim.x, p = blockIdx.x;
  const long long r0 = (long long)p * rows_per;
  const long long r1 = min((long long)R, r0 + rows_per);
  const int chunks = N / VEC;

  float wv[CPT][VEC], dw[CPT][VEC], db[CPT][VEC];
  Pack<T, VEC> xc[CPT], gc[CPT], xn[CPT], gn[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = tid + i * NT;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      wv[i][e] = c < chunks ? __ldg(w + c * VEC + e) : 0.f;
      dw[i][e] = db[i][e] = 0.f;
      xc[i].e[e] = gc[i].e[e] = xn[i].e[e] = gn[i].e[e] = from_float<T>(0.f);
    }
  }
  auto load_row = [&](long long r, Pack<T, VEC>* xs, Pack<T, VEC>* gs) {
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = tid + i * NT;
      if (c < chunks) {
        xs[i] = *reinterpret_cast<const Pack<T, VEC>*>(x + r * N + c * VEC);
        gs[i] = *reinterpret_cast<const Pack<T, VEC>*>(g + r * N + c * VEC);
      }
    }
  };
  if (r0 < r1) load_row(r0, xc, gc);

  int par = 0;
  for (long long r = r0; r < r1; ++r) {
    if (r + 1 < r1) load_row(r + 1, xn, gn);   // in flight while this row runs
    const float mu = __ldg(mean + r), rs = __ldg(rstd + r);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xhat = (to_float(xc[i].e[e]) - mu) * rs;
        const float gw = to_float(gc[i].e[e]) * wv[i][e];
        s1 += gw;
        s2 += gw * xhat;
      }
    }
    float2 v = make_float2(warp_sum(s1), warp_sum(s2));
    if (lane == 0) red[par][warp] = v;
    __syncthreads();
    float t1 = 0.f, t2 = 0.f;
    for (int i = 0; i < nwarps; ++i) {
      t1 += red[par][i].x;
      t2 += red[par][i].y;
    }
    par ^= 1;
    const float m1 = t1 / N, m2 = t2 / N;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = tid + i * NT;
      if (c >= chunks) continue;
      Pack<T, VEC> out;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float gf = to_float(gc[i].e[e]);
        const float xhat = (to_float(xc[i].e[e]) - mu) * rs;
        out.e[e] = from_float<T>(rs * (gf * wv[i][e] - m1 - xhat * m2));
        dw[i][e] += gf * xhat;
        db[i][e] += gf;
      }
      *reinterpret_cast<Pack<T, VEC>*>(dx + r * N + c * VEC) = out;
    }
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      xc[i] = xn[i];
      gc[i] = gn[i];
    }
  }
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = tid + i * NT;
    if (c >= chunks) continue;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      part[(long long)p * N + c * VEC + e] = dw[i][e];
      part[((long long)P + p) * N + c * VEC + e] = db[i][e];
    }
  }
}

constexpr int COL_WARPS = 8;

// stage 2: dw = sum over P of part[0], db = sum of part[1]; blockIdx.y picks
__global__ void __launch_bounds__(COL_WARPS * 32)
ln_bwd_cols_kernel(const float* __restrict__ part, float* __restrict__ dw,
                   float* __restrict__ db, int P, int N) {
  __shared__ float red[COL_WARPS][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane;
  const float* src = part + (long long)blockIdx.y * P * N;
  float s = 0.f;
  if (col < N) {
#pragma unroll 4
    for (int p = warp; p < P; p += COL_WARPS) s += src[(long long)p * N + col];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < N) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < COL_WARPS; ++i) t += red[i][lane];
    (blockIdx.y ? db : dw)[col] = t;
  }
}

template <typename T, int VEC, int CPT>
cudaError_t launch_rows(const void* x, const float* w, const float* mean,
                        const float* rstd, const void* g, void* dx, float* part,
                        int R, int N, int P, int rows_per, int nt,
                        cudaStream_t s) {
  ln_bwd_rows_kernel<T, VEC, CPT><<<P, nt, 0, s>>>(
      static_cast<const T*>(x), w, mean, rstd, static_cast<const T*>(g),
      static_cast<T*>(dx), part, R, N, rows_per);
  return cudaGetLastError();
}

// threads per block and chunks per thread for N / VEC chunks of a row:
// up to 256 threads with 1, 2, 4 or 8 chunks each, then up to 1024 threads
// with 8; the wrapper refuses wider rows
template <typename T, int VEC>
cudaError_t launch_bwd(const void* x, const float* w, const float* mean,
                       const float* rstd, const void* g, void* dx, float* part,
                       float* dw, float* db, int R, int N, int P, int rows_per,
                       cudaStream_t s) {
  const int chunks = N / VEC;
  int cpt = 1;
  while (cpt < 8 && cpt * 256 < chunks) cpt *= 2;
  const int per = (chunks + cpt - 1) / cpt;
  const int nt = ((per + 31) / 32) * 32;
  if (nt > 1024) return cudaErrorInvalidValue;
  cudaError_t e;
  switch (cpt) {
    case 1: e = launch_rows<T, VEC, 1>(x, w, mean, rstd, g, dx, part, R, N, P, rows_per, nt, s); break;
    case 2: e = launch_rows<T, VEC, 2>(x, w, mean, rstd, g, dx, part, R, N, P, rows_per, nt, s); break;
    case 4: e = launch_rows<T, VEC, 4>(x, w, mean, rstd, g, dx, part, R, N, P, rows_per, nt, s); break;
    default: e = launch_rows<T, VEC, 8>(x, w, mean, rstd, g, dx, part, R, N, P, rows_per, nt, s); break;
  }
  if (e != cudaSuccess) return e;
  ln_bwd_cols_kernel<<<dim3((N + 31) / 32, 2), COL_WARPS * 32, 0, s>>>(part, dw, db, P, N);
  return cudaGetLastError();
}

}  // namespace

// x, o: [R, N] row-major in x's dtype (0 float32, 1 float16, 2 bfloat16);
// w, b: [N] float32; mean, rstd: [R] float32. vec: N is a multiple of 16
// bytes and every pointer is 16-byte aligned.
extern "C" int dstt_layer_norm_fwd(const void* x, const void* w, const void* b,
                                   void* o, void* mean, void* rstd, int R,
                                   int N, float eps, int vec, int dtype,
                                   void* stream) {
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 2) return (int)launch_fwd<__nv_bfloat16>(x, wf, bf, o, m, r, R, N, eps, vec, s);
  if (dtype == 1) return (int)launch_fwd<__half>(x, wf, bf, o, m, r, R, N, eps, vec, s);
  if (dtype == 0) return (int)launch_fwd<float>(x, wf, bf, o, m, r, R, N, eps, vec, s);
  return (int)cudaErrorInvalidValue;
}

// x, g, dx: [R, N] row-major in x's dtype; w [N], mean/rstd [R], dw/db [N]
// float32; part: [2, P, N] float32 scratch, P = ceil(R / rows_per).
extern "C" int dstt_layer_norm_bwd(const void* x, const void* w,
                                   const void* mean, const void* rstd,
                                   const void* g, void* dx, void* part,
                                   void* dw, void* db, int R, int N, int P,
                                   int rows_per, int vec, int dtype,
                                   void* stream) {
  const float* wf = static_cast<const float*>(w);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  float* pt = static_cast<float*>(part);
  float* dwf = static_cast<float*>(dw);
  float* dbf = static_cast<float*>(db);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || N <= 0 || P <= 0 || rows_per <= 0 || (long long)P * rows_per < R)
    return (int)cudaErrorInvalidValue;
  if (dtype == 2 && vec) return (int)launch_bwd<__nv_bfloat16, 8>(x, wf, m, r, g, dx, pt, dwf, dbf, R, N, P, rows_per, s);
  if (dtype == 2) return (int)launch_bwd<__nv_bfloat16, 1>(x, wf, m, r, g, dx, pt, dwf, dbf, R, N, P, rows_per, s);
  if (dtype == 1 && vec) return (int)launch_bwd<__half, 8>(x, wf, m, r, g, dx, pt, dwf, dbf, R, N, P, rows_per, s);
  if (dtype == 1) return (int)launch_bwd<__half, 1>(x, wf, m, r, g, dx, pt, dwf, dbf, R, N, P, rows_per, s);
  if (dtype == 0 && vec) return (int)launch_bwd<float, 4>(x, wf, m, r, g, dx, pt, dwf, dbf, R, N, P, rows_per, s);
  if (dtype == 0) return (int)launch_bwd<float, 1>(x, wf, m, r, g, dx, pt, dwf, dbf, R, N, P, rows_per, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dstt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
