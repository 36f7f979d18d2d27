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
//    grid with a VMEM carry; blocks on the card run in no order, so each
//    of P persistent blocks sums dw and db over a contiguous range of rows
//    (at least 8 rows where R allows, so a small problem merges few
//    partial rows), and the P partial rows are merged in the same launch,
//    deterministic, without atomics in the sums:
//    - `ln_bwd_ring_kernel` (rows of 16-byte chunks, at most 4 x 256 of
//      them: bf16/fp16 N <= 8192, f32 N <= 4096; two blocks an SM, one at
//      4 chunks a thread): each thread owns fixed chunks of every row (1,
//      2 or 4: CPT), w and dw, db of them in registers. x and g stream
//      through a cp.async ring of 3 groups of G rows (4 / CPT; 8 for rows
//      of at most 128 chunks) in shared memory, two groups ahead, each
//      thread copying and later reading only its own chunks (no barrier
//      for the ring, as B9's); mean and rstd are loaded with the group's
//      copies. mean(g w) and mean(g w xhat) of a group's rows are
//      per-thread partial sums, warp sums by shuffles and the warps' sums
//      in order: one barrier a group.
//    - `ln_bwd_wide_kernel` (wider rows, or rows that are no whole 16-byte
//      chunks, over tensors that start on 16 bytes), 512 threads, one an
//      SM: where a row's staging and the block's dw and db fit 200 KB of
//      shared memory (N <= ~12800 in 16 bits), each row is copied once by
//      cp.async into one of two row buffers (the next row's while this
//      one is worked on); each thread takes its chunks of it into
//      registers (a row that starts inside a 16-byte chunk: two chunks
//      funnel-shifted into place), the row's two means are block sums
//      (two barriers a row) and dx comes from the same registers; dw and
//      db sit in shared memory, each chunk's touched by its owner only.
//      Wider rows: each row's means a warp a row, then tile by tile of 512
//      chunks a walk down the block's rows (a second read of x and g:
//      5 elements moved for 3), dw and db in registers.
//      `ln_bwd_scalar_kernel` does the same element by element for
//      tensors that do not start on 16 bytes (views).
//    - the merge (`merge_partials`): each block writes its partial row of
//      a [2, P, ld] scratch (ld = N rounded up to 4; 2.2 MB at N = 2048 on
//      132 SMs); a grid-wide barrier (the launch is cooperative, so all P
//      blocks are resident); then every block sums strips of 128 columns
//      over the P rows, its warps over interleaved rows with 16-byte loads
//      and the warps' sums in order. No second launch, no memset: the
//      barrier's counters are reset by the last block out. (A merge by the
//      last block alone, behind an arrival ticket, would read the whole
//      scratch from one SM.)
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

constexpr int BWD_THREADS = 256;   // threads a block of the ring kernel (at most)
constexpr int WIDE_THREADS = 512;  // threads a block of the wide and scalar kernels
constexpr int BWD_STAGES = 3;      // ring kernel: row groups in the ring, 2 ahead
constexpr int MERGE_WARPS = WIDE_THREADS / 32;
constexpr int MERGE_BATCH = 16;    // partial rows a lane loads at once in the merge

// a 32-bit load with acquire semantics at device scope (the grid barrier)
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The last step of every B10 kernel: each block has written its partial
// column sums, row p of part [2][P][ld] (dw's, then db's; ld = N rounded
// up to 4, so rows start on 16 bytes). A grid-wide barrier (the launch is
// cooperative, so all P blocks are resident), then the blocks share the
// merge: block p takes strips of 128 columns p, p + P, ...; each lane
// loads 4 columns of MERGE_BATCH partial rows at once (16-byte loads), its
// warp sums interleaved rows, then the warps' sums go in order. The same
// P on the same card gives the same bits. The last block to leave resets
// the barrier's two counters for the next launch (no memset).
__device__ void merge_partials(const float* __restrict__ part, float* __restrict__ dw,
                               float* __restrict__ db, int* bar, int P, int N) {
  __shared__ float4 red[MERGE_WARPS][32];
  __syncthreads();   // the block's partial sums written
  if (threadIdx.x == 0) {
    __threadfence();   // and, cumulatively, visible to every block
    atomicAdd(bar, 1);
    while (ld_acquire(bar) < P) __nanosleep(100);
    __threadfence();
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  const int ld = (N + 3) & ~3, strips = (N + 127) / 128;   // strips of dw, then of db
  for (int st = blockIdx.x; st < 2 * strips; st += P) {
    const int which = st >= strips;
    const int c = (st - which * strips) * 128 + 4 * lane;   // this lane's 4 columns
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < N) {
      const float* src = part + (long long)which * P * ld + c;
      for (int q0 = warp; q0 < P; q0 += MERGE_BATCH * warps) {
        float4 v[MERGE_BATCH];   // independent loads first, then their sum in row order
#pragma unroll
        for (int u = 0; u < MERGE_BATCH; ++u) {
          const int q = q0 + u * warps;
          v[u] = q < P ? __ldcg(reinterpret_cast<const float4*>(src + (long long)q * ld))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < MERGE_BATCH; ++u) {
          s.x += v[u].x;
          s.y += v[u].y;
          s.z += v[u].z;
          s.w += v[u].w;
        }
      }
    }
    red[warp][lane] = s;
    __syncthreads();
    if (warp == 0 && c < N) {
      float t[4] = {0.f, 0.f, 0.f, 0.f};
      for (int i = 0; i < warps; ++i) {
        t[0] += red[i][lane].x;
        t[1] += red[i][lane].y;
        t[2] += red[i][lane].z;
        t[3] += red[i][lane].w;
      }
      float* out = which ? db : dw;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < N) out[c + e] = t[e];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0 && atomicAdd(bar + 1, 1) == P - 1) {
    bar[0] = 0;
    bar[1] = 0;
  }
}

// dx of one 16-byte chunk of a row (VEC elements at x, g, w) with the row's
// m1 = mean(g w), m2 = mean(g w xhat); adds g xhat and g to dw and db
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> dx_chunk(const Pack<T, VEC>& xc, const Pack<T, VEC>& gc,
                                                 const float (&wv)[VEC], float mu, float rs,
                                                 float m1, float m2, float (&dw)[VEC],
                                                 float (&db)[VEC]) {
  Pack<T, VEC> out;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float gf = to_float(gc.e[e]);
    const float xhat = (to_float(xc.e[e]) - mu) * rs;
    out.e[e] = from_float<T>(rs * (gf * wv[e] - m1 - xhat * m2));
    dw[e] += gf * xhat;
    db[e] += gf;
  }
  return out;
}

// rows of N / V 16-byte chunks, at most CPT a thread (N * sizeof(T) a
// multiple of 16, every row tensor 16-byte aligned). Block p of P takes
// rows [R p / P, R (p + 1) / P) and its threads fixed chunks, tid + i NT.
// The rows stream through a ring of BWD_STAGES groups of G rows (4 / CPT;
// 8 for rows of at most 128 chunks, so a block's 16 rows are all in
// flight at once) in shared memory by 16-byte cp.async, two groups ahead; each thread
// copies and later reads only its own chunks, so the ring needs no
// barrier. A group's row statistics are partial sums over each thread's
// chunks, warp sums by shuffles, then the warps' sums in order: one
// barrier a group. dw and db of the thread's columns stay in registers
// until the merge.
template <typename T, int CPT, int G>
__global__ void __launch_bounds__(BWD_THREADS, CPT < 4 ? 2 : 1)
ln_bwd_ring_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ mean, const float* __restrict__ rstd,
                   const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ part,
                   float* __restrict__ dw, float* __restrict__ db, int* bar, int R, int N) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ uint4 ring[];   // [BWD_STAGES * G][x, g][chunks]
  __shared__ float2 red[2][G][BWD_THREADS / 32];   // [group parity][row][warp]
  const int NT = blockDim.x, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nwarps = NT / 32, chunks = N / V;
  const int P = gridDim.x, p = blockIdx.x;
  const long long r0 = (long long)R * p / P;
  const int n = (int)((long long)R * (p + 1) / P - r0);   // rows of this block
  const int ngroups = (n + G - 1) / G;

  float wv[CPT][V], dwa[CPT][V], dba[CPT][V];
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = tid + i * NT;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      wv[i][e] = c < chunks ? __ldg(w + c * V + e) : 0.f;
      dwa[i][e] = dba[i][e] = 0.f;
    }
  }
  auto slot = [&](int row, int which, int c) {   // row within the block
    return ring + ((((row / G) % BWD_STAGES) * G + row % G) * 2 + which) * chunks + c;
  };
  auto issue = [&](int k) {   // this thread's chunks of group k's rows
    for (int r = k * G; r < min(n, k * G + G); ++r) {
      const T* xr = x + (r0 + r) * N;
      const T* gr = g + (r0 + r) * N;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int c = tid + i * NT;
        if (c < chunks) {
          cp_async16(slot(r, 0, c), xr + c * V, true);
          cp_async16(slot(r, 1, c), gr + c * V, true);
        }
      }
    }
    cp_async_commit();   // one commit a group, empty past the last
  };
  // mean and rstd of group k's rows, loaded with its copies (a load used
  // at once would stall the group); a row past the block's repeats its last
  auto stats_of = [&](int k, float (&mu)[G], float (&rs)[G]) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int r = min(k * G + j, n - 1);
      mu[j] = __ldg(mean + r0 + r);
      rs[j] = __ldg(rstd + r0 + r);
    }
  };
  float mu[G], rs[G], mu1[G], rs1[G], mu2[G], rs2[G];
  issue(0);
  stats_of(0, mu1, rs1);
  issue(1);
  stats_of(1, mu2, rs2);
  for (int k = 0; k < ngroups; ++k) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      mu[j] = mu1[j], rs[j] = rs1[j];
      mu1[j] = mu2[j], rs1[j] = rs2[j];
    }
    issue(k + 2);   // into the slots of group k - 1, done with by this thread
    stats_of(k + 2, mu2, rs2);
    cp_async_wait<2>();   // this thread's copies of group k have landed
    float s1[G], s2[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int r = min(k * G + j, n - 1);
      s1[j] = s2[j] = 0.f;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int c = tid + i * NT;
        if (c >= chunks) continue;
        const Pack<T, V> xc = *reinterpret_cast<const Pack<T, V>*>(slot(r, 0, c));
        const Pack<T, V> gc = *reinterpret_cast<const Pack<T, V>*>(slot(r, 1, c));
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xhat = (to_float(xc.e[e]) - mu[j]) * rs[j];
          const float gw = to_float(gc.e[e]) * wv[i][e];
          s1[j] += gw;
          s2[j] += gw * xhat;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      s1[j] = warp_sum(s1[j]);
      s2[j] = warp_sum(s2[j]);
      if (lane == 0) red[k & 1][j][warp] = make_float2(s1[j], s2[j]);
    }
    __syncthreads();   // the only barrier of the group
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int r = k * G + j;
      if (r >= n) break;
      float t1 = 0.f, t2 = 0.f;
      for (int i = 0; i < nwarps; ++i) {
        t1 += red[k & 1][j][i].x;
        t2 += red[k & 1][j][i].y;
      }
      const float m1 = t1 / N, m2 = t2 / N;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int c = tid + i * NT;
        if (c >= chunks) continue;
        const Pack<T, V> out = dx_chunk<T, V>(
            *reinterpret_cast<const Pack<T, V>*>(slot(r, 0, c)),
            *reinterpret_cast<const Pack<T, V>*>(slot(r, 1, c)), wv[i], mu[j], rs[j], m1, m2,
            dwa[i], dba[i]);
        store_streaming(dx + (r0 + r) * N + c * V, *reinterpret_cast<const uint4*>(&out));
      }
    }
  }
  const int ld = (N + 3) & ~3;   // floats a partial row
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = tid + i * NT;
    if (c >= chunks) continue;
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      *reinterpret_cast<float4*>(part + (long long)p * ld + c * V + e) =
          make_float4(dwa[i][e], dwa[i][e + 1], dwa[i][e + 2], dwa[i][e + 3]);
      *reinterpret_cast<float4*>(part + ((long long)P + p) * ld + c * V + e) =
          make_float4(dba[i][e], dba[i][e + 1], dba[i][e + 2], dba[i][e + 3]);
    }
  }
  merge_partials(part, dw, db, bar, P, N);
}

// 16 bytes of row-major data from element i on, at any i, out of the
// 16-byte aligned array p of `end` elements: the aligned chunk that holds
// element i and the next one (the same again at the array's last chunk),
// funnel-shifted down to i. No branch, so the loads of several calls are
// in flight together; bytes past the array are garbage for the caller to
// drop.
template <typename T>
__device__ __forceinline__ uint4 load16_at(const T* __restrict__ p, long long i, long long end) {
  constexpr int V = 16 / sizeof(T);
  const long long k = i / V;
  const uint4* c = reinterpret_cast<const uint4*>(p);
  const uint4 a = __ldg(c + k);
  const uint4 b = __ldg(c + min(k + 1, (end - 1) / V));
  const int sb = (int)(i % V) * (int)sizeof(T);   // bytes into the chunk
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int q = sb >> 2;
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {   // words q + j and q + j + 1, by selects
    const uint32_t lo = q == 0 ? w[j] : q == 1 ? w[j + 1] : q == 2 ? w[j + 2] : w[j + 3];
    const uint32_t hi = q == 0 ? w[j + 1] : q == 1 ? w[j + 2] : q == 2 ? w[j + 3] : w[j + 4];
    o[j] = (sb & 2) ? __funnelshift_r(lo, hi, 16) : lo;
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// 16 bytes from element s on of a row staged in shared memory from its
// first element's 16-byte chunk on (s < V: the row's offset in that
// chunk), as load16_at: two aligned chunks, funnel-shifted
template <typename T>
__device__ __forceinline__ uint4 shifted16(const uint4* __restrict__ row, int c, int sb) {
  const uint4 a = row[c];
  if (sb == 0) return a;   // sb is the same for every chunk of a row: no divergence
  const uint4 b = row[c + 1];
  const int sh = (sb & 2) * 8;   // bits a word moves (16 or 0)
  switch (sb >> 2) {   // whole words moved
    case 0:
      return make_uint4(__funnelshift_r(a.x, a.y, sh), __funnelshift_r(a.y, a.z, sh),
                        __funnelshift_r(a.z, a.w, sh), __funnelshift_r(a.w, b.x, sh));
    case 1:
      return make_uint4(__funnelshift_r(a.y, a.z, sh), __funnelshift_r(a.z, a.w, sh),
                        __funnelshift_r(a.w, b.x, sh), __funnelshift_r(b.x, b.y, sh));
    case 2:
      return make_uint4(__funnelshift_r(a.z, a.w, sh), __funnelshift_r(a.w, b.x, sh),
                        __funnelshift_r(b.x, b.y, sh), __funnelshift_r(b.y, b.z, sh));
    default:
      return make_uint4(__funnelshift_r(a.w, b.x, sh), __funnelshift_r(b.x, b.y, sh),
                        __funnelshift_r(b.y, b.z, sh), __funnelshift_r(b.z, b.w, sh));
  }
}

// rows wider than 4 x BWD_THREADS 16-byte chunks, or rows of any width
// that are no whole chunks (x, g and dx 16-byte aligned; a row then starts
// anywhere in a chunk). Block p of P takes rows [R p / P, R (p + 1) / P);
// its threads own chunks c = tid + i NT of every row (columns c V ...).
//  * STAGED (rows of at most STAGED_CPT x NT chunks whose staging and sums
//    fit shared memory): each row's span of 16-byte chunks is copied by
//    cp.async into one of two row buffers, the next row's while this one
//    is worked on, so x and g are read from device memory once; each
//    thread takes its chunks of the row into registers (a row that starts
//    inside a chunk: two staged chunks funnel-shifted, `shifted16`), sums
//    them for m1 and m2 (warp sums, then the warps' in order: two barriers
//    a row) and computes dx from the same registers. w stays in registers;
//    dw and db of the owned chunks sit in shared memory, read and written
//    by their owner only.
//  * else (wider rows): first every row's m1 and m2, a warp a row, kept in
//    `stats` [R, 2]; then, tile by tile of NT chunks, each thread walks the
//    block's rows over its chunk of the tile (a second read of x and g),
//    with dw and db in registers. Chunks are read by load16_at.
constexpr size_t STAGED_SMEM = 200 * 1024;   // shared memory the staged mode may take
constexpr int STAGED_CPT = 4;                 // chunks a thread of the staged mode owns, at most

template <typename T>
__host__ __device__ constexpr size_t staged_smem(int N) {   // row buffers, then dw and db
  return (size_t)2 * 2 * ((N + 16 / sizeof(T) - 1) / (16 / sizeof(T)) + 2) * 16 +
         (size_t)2 * ((N + 16 / sizeof(T) - 1) / (16 / sizeof(T))) * 16 / sizeof(T) * 4;
}

template <typename T, bool STAGED>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
ln_bwd_wide_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ mean, const float* __restrict__ rstd,
                   const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ part,
                   float2* __restrict__ stats, float* __restrict__ dw, float* __restrict__ db,
                   int* bar, int R, int N) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ uint4 smem4[];
  __shared__ float2 red[2][WIDE_THREADS / 32];
  const int NT = blockDim.x, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nwarps = NT / 32, nch = (N + V - 1) / V;   // chunks of V columns a row
  const int ld = (N + 3) & ~3;                         // floats a partial row
  const long long end = (long long)R * N;
  const int P = gridDim.x, p = blockIdx.x;
  const long long r0 = (long long)R * p / P, r1 = (long long)R * (p + 1) / P;
  auto wchunk = [&](int c, float (&wv)[V]) {   // w of columns c V ..., 0 past N
    if (c * V + V <= N) {
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(w + c * V + e));
        wv[e] = f.x, wv[e + 1] = f.y, wv[e + 2] = f.z, wv[e + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) wv[e] = c * V + e < N ? __ldg(w + c * V + e) : 0.f;
    }
  };
  // sums of one chunk's elements (those past N dropped by selects)
  auto chunk_sums = [&](int c, const uint4& xr, const uint4& gr, float mu, float rs, float& s1,
                        float& s2) {
    float wv[V];
    wchunk(c, wv);
    const T* xe = reinterpret_cast<const T*>(&xr);
    const T* ge = reinterpret_cast<const T*>(&gr);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const bool in = c * V + e < N;
      const float xhat = (to_float(xe[e]) - mu) * rs;
      const float gw = to_float(ge[e]) * wv[e];
      s1 += in ? gw : 0.f;
      s2 += in ? gw * xhat : 0.f;
    }
  };
  // dx of chunk c of row r from its x and g, stored, adding to dw and db
  auto dx_store = [&](long long r, int c, const uint4& xr, const uint4& gr, float mu, float rs,
                      float m1, float m2, float (&dwa)[V], float (&dba)[V]) {
    float wv[V];
    wchunk(c, wv);
    const long long i = r * N + (long long)c * V;
    const Pack<T, V> out = dx_chunk<T, V>(*reinterpret_cast<const Pack<T, V>*>(&xr),
                                          *reinterpret_cast<const Pack<T, V>*>(&gr), wv, mu, rs,
                                          m1, m2, dwa, dba);
    if (i % V == 0 && c * V + V <= N) {
      *reinterpret_cast<uint4*>(dx + i) = *reinterpret_cast<const uint4*>(&out);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (c * V + e < N) dx[i + e] = out.e[e];
    }
  };
  if constexpr (STAGED) {
    constexpr int Q = V / 4;   // float4s of a chunk's dw (or db)
    constexpr int CPT = STAGED_CPT;
    const int span = nch + 2;  // chunks a row buffer holds
    float wv[CPT][V];
#pragma unroll
    for (int i = 0; i < CPT; ++i) wchunk(min(tid + i * NT, nch - 1), wv[i]);
    uint4* stage = smem4;      // [2 buffers][x, g][span]
    float4* adw = reinterpret_cast<float4*>(smem4 + 4 * span);
    float4* adb = adw + nch * Q;
    for (int c = tid; c < nch; c += NT)
#pragma unroll
      for (int q = 0; q < Q; ++q) adw[c * Q + q] = adb[c * Q + q] = make_float4(0.f, 0.f, 0.f, 0.f);
    // row r's chunks, from the one its first element lies in, into buffer b
    auto issue = [&](long long r, int b) {
      if (r < r1) {
        const long long k0 = r * N / V, k1 = (r * N + N - 1) / V;
        const uint4* xs = reinterpret_cast<const uint4*>(x) + k0;
        const uint4* gs = reinterpret_cast<const uint4*>(g) + k0;
        uint4* bx = stage + b * 2 * span;
        for (int c = tid; c <= (int)(k1 - k0); c += NT) {
          cp_async16(bx + c, xs + c, true);
          cp_async16(bx + span + c, gs + c, true);
        }
      }
      cp_async_commit();
    };
    issue(r0, 0);
    int par = 0;
    for (long long r = r0; r < r1; ++r, par ^= 1) {
      cp_async_wait<0>();   // this thread's copies of row r
      __syncthreads();      // everyone's, and everyone is done with row r - 1
      issue(r + 1, par ^ 1);   // into the buffer of row r - 1
      const uint4* bx = stage + par * 2 * span;
      const uint4* bg = bx + span;
      const int sb = (int)(r * N % V) * (int)sizeof(T);   // the row's bytes into its first chunk
      const float mu = __ldg(mean + r), rs = __ldg(rstd + r);
      float s1 = 0.f, s2 = 0.f;
      uint4 xc[CPT], gc[CPT];
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int c = tid + i * NT;
        if (c >= nch) break;
        xc[i] = shifted16<T>(bx, c, sb);
        gc[i] = shifted16<T>(bg, c, sb);
        const T* xe = reinterpret_cast<const T*>(&xc[i]);
        const T* ge = reinterpret_cast<const T*>(&gc[i]);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const bool in = c * V + e < N;
          const float xhat = (to_float(xe[e]) - mu) * rs;
          const float gw = to_float(ge[e]) * wv[i][e];
          s1 += in ? gw : 0.f;
          s2 += in ? gw * xhat : 0.f;
        }
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) red[par][warp] = make_float2(s1, s2);
      __syncthreads();
      float t1 = 0.f, t2 = 0.f;
      for (int i = 0; i < nwarps; ++i) {
        t1 += red[par][i].x;
        t2 += red[par][i].y;
      }
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int c = tid + i * NT;
        if (c >= nch) break;
        float dwa[V], dba[V];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const float4 a = adw[c * Q + q], b = adb[c * Q + q];
          dwa[4 * q] = a.x, dwa[4 * q + 1] = a.y, dwa[4 * q + 2] = a.z, dwa[4 * q + 3] = a.w;
          dba[4 * q] = b.x, dba[4 * q + 1] = b.y, dba[4 * q + 2] = b.z, dba[4 * q + 3] = b.w;
        }
        const long long at = r * N + (long long)c * V;
        const Pack<T, V> out = dx_chunk<T, V>(*reinterpret_cast<const Pack<T, V>*>(&xc[i]),
                                              *reinterpret_cast<const Pack<T, V>*>(&gc[i]),
                                              wv[i], mu, rs, t1 / N, t2 / N, dwa, dba);
        if (sb == 0 && c * V + V <= N) {
          *reinterpret_cast<uint4*>(dx + at) = *reinterpret_cast<const uint4*>(&out);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e)
            if (c * V + e < N) dx[at + e] = out.e[e];
        }
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          adw[c * Q + q] = make_float4(dwa[4 * q], dwa[4 * q + 1], dwa[4 * q + 2], dwa[4 * q + 3]);
          adb[c * Q + q] = make_float4(dba[4 * q], dba[4 * q + 1], dba[4 * q + 2], dba[4 * q + 3]);
        }
      }
    }
    for (int c = tid; c < nch; c += NT) {
      const float* fw = reinterpret_cast<const float*>(adw + c * Q);
      const float* fb = reinterpret_cast<const float*>(adb + c * Q);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (c * V + e >= N) break;
        part[(long long)p * ld + c * V + e] = fw[e];
        part[((long long)P + p) * ld + c * V + e] = fb[e];
      }
    }
  } else {
    for (long long r = r0 + warp; r < r1; r += nwarps) {
      const float mu = __ldg(mean + r), rs = __ldg(rstd + r);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
      for (int c = lane; c < nch; c += 32)
        chunk_sums(c, load16_at(x, r * N + (long long)c * V, end),
                   load16_at(g, r * N + (long long)c * V, end), mu, rs, s1, s2);
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) stats[r] = make_float2(s1 / N, s2 / N);
    }
    __syncthreads();   // the block's stats
    for (int c = tid; c - tid < nch; c += NT) {   // a tile: every thread one chunk
      float dwa[V], dba[V];
#pragma unroll
      for (int e = 0; e < V; ++e) dwa[e] = dba[e] = 0.f;
      if (c < nch) {
#pragma unroll 4
        for (long long r = r0; r < r1; ++r) {
          const float2 m = __ldcg(stats + r);
          const long long i = r * N + (long long)c * V;
          dx_store(r, c, load16_at(x, i, end), load16_at(g, i, end), __ldg(mean + r),
                   __ldg(rstd + r), m.x, m.y, dwa, dba);
        }
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if (c * V + e >= N) break;
          part[(long long)p * ld + c * V + e] = dwa[e];
          part[((long long)P + p) * ld + c * V + e] = dba[e];
        }
      }
    }
  }
  merge_partials(part, dw, db, bar, P, N);
}

// the same over rows read element by element, where x, g or dx is not
// 16-byte aligned (a view); correct, not fast
template <typename T>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
ln_bwd_scalar_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ mean, const float* __restrict__ rstd,
                     const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ part,
                     float2* __restrict__ stats, float* __restrict__ dw, float* __restrict__ db,
                     int* bar, int R, int N) {
  const int NT = blockDim.x, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nwarps = NT / 32, ld = (N + 3) & ~3;
  const int P = gridDim.x, p = blockIdx.x;
  const long long r0 = (long long)R * p / P, r1 = (long long)R * (p + 1) / P;
  for (long long r = r0 + warp; r < r1; r += nwarps) {
    const float mu = __ldg(mean + r), rs = __ldg(rstd + r);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll 8
    for (int c = lane; c < N; c += 32) {
      const float xhat = (to_float(x[r * N + c]) - mu) * rs;
      const float gw = to_float(g[r * N + c]) * __ldg(w + c);
      s1 += gw;
      s2 += gw * xhat;
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) stats[r] = make_float2(s1 / N, s2 / N);
  }
  __syncthreads();
  for (int c = tid; c - tid < N; c += NT) {
    float dwa[1] = {0.f}, dba[1] = {0.f};
    if (c < N) {
      const float wv[1] = {__ldg(w + c)};
#pragma unroll 8
      for (long long r = r0; r < r1; ++r) {
        const float2 m = __ldcg(stats + r);
        Pack<T, 1> xc, gc;
        xc.e[0] = x[r * N + c];
        gc.e[0] = g[r * N + c];
        dx[r * N + c] = dx_chunk<T, 1>(xc, gc, wv, __ldg(mean + r), __ldg(rstd + r), m.x, m.y,
                                       dwa, dba).e[0];
      }
      part[(long long)p * ld + c] = dwa[0];
      part[((long long)P + p) * ld + c] = dba[0];
    }
  }
  merge_partials(part, dw, db, bar, P, N);
}

// a cooperative launch of `kernel` (all P blocks resident, for the grid
// barrier of merge_partials), after checking that P blocks fit
template <typename K, typename... A>
cudaError_t launch_coop(K kernel, int P, int nt, size_t smem, cudaStream_t s, A... args) {
  // dynamic beside static shared memory may pass the default 48 KB even
  // when the dynamic part alone does not
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, nt, smem);
  if (e != cudaSuccess) return e;
  if (P < 1 || P > per_sm * sm_count()) return cudaErrorCooperativeLaunchTooLarge;
  void* argv[] = {&args...};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(P), dim3(nt), argv,
                                  smem, s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// the ring kernel for rows of at most 4 x BWD_THREADS 16-byte chunks (CPT
// chunks a thread: 1, 2 or 4), the wide kernel for other rows over
// 16-byte aligned tensors, the scalar kernel for the rest
template <typename T>
cudaError_t launch_bwd(const void* x, const float* w, const float* mean, const float* rstd,
                       const void* g, void* dx, float* part, float2* stats, float* dw, float* db,
                       int* bar, int R, int N, int P, int vec, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dxt = static_cast<T*>(dx);
  const int chunks = N / V;
  const bool rows16 = N % V == 0, bases16 = vec != 0;   // vec: every base 16-byte aligned
  if (rows16 && bases16 && chunks <= 4 * BWD_THREADS) {
    const int cpt = chunks <= BWD_THREADS ? 1 : chunks <= 2 * BWD_THREADS ? 2 : 4;
    const int rows = chunks <= BWD_THREADS / 2 ? 8 : 4 / cpt;   // G
    const int nt = BWD_THREADS;   // idle threads in a narrow row still share the merge
    const size_t smem = (size_t)BWD_STAGES * rows * 2 * chunks * 16;
    if (rows == 8)
      return launch_coop(ln_bwd_ring_kernel<T, 1, 8>, P, nt, smem, s, xt, w, mean, rstd, gt,
                         dxt, part, dw, db, bar, R, N);
    if (cpt == 1)
      return launch_coop(ln_bwd_ring_kernel<T, 1, 4>, P, nt, smem, s, xt, w, mean, rstd, gt,
                         dxt, part, dw, db, bar, R, N);
    if (cpt == 2)
      return launch_coop(ln_bwd_ring_kernel<T, 2, 2>, P, nt, smem, s, xt, w, mean, rstd, gt,
                         dxt, part, dw, db, bar, R, N);
    return launch_coop(ln_bwd_ring_kernel<T, 4, 1>, P, nt, smem, s, xt, w, mean, rstd, gt, dxt,
                       part, dw, db, bar, R, N);
  }
  if (bases16 && (N + V - 1) / V <= STAGED_CPT * WIDE_THREADS &&
      staged_smem<T>(N) <= STAGED_SMEM)
    return launch_coop(ln_bwd_wide_kernel<T, true>, P, WIDE_THREADS, staged_smem<T>(N), s, xt,
                       w, mean, rstd, gt, dxt, part, stats, dw, db, bar, R, N);
  if (stats == nullptr) return cudaErrorInvalidValue;
  if (bases16)
    return launch_coop(ln_bwd_wide_kernel<T, false>, P, WIDE_THREADS, 0, s, xt, w, mean, rstd,
                       gt, dxt, part, stats, dw, db, bar, R, N);
  return launch_coop(ln_bwd_scalar_kernel<T>, P, WIDE_THREADS, 0, s, xt, w, mean, rstd, gt,
                     dxt, part, stats, dw, db, bar, R, N);
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
// float32; vec: x, g and dx start on 16 bytes. part: [2, P, ld] float32
// scratch, ld = N rounded up to 4, P (1 <= P <= R) the persistent blocks,
// as many as the card holds at once at most; stats: [R, 2] float32 scratch
// for rows the ring kernel does not take (else may be null); bar: two int32 on the device, 0
// before the first launch (each launch leaves them 0; launches that share
// them run in order).
extern "C" int dstt_layer_norm_bwd(const void* x, const void* w,
                                   const void* mean, const void* rstd,
                                   const void* g, void* dx, void* part,
                                   void* stats, void* bar, void* dw, void* db,
                                   int R, int N, int P, int vec, int dtype,
                                   void* stream) {
  const float* wf = static_cast<const float*>(w);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  float* pt = static_cast<float*>(part);
  float2* st = static_cast<float2*>(stats);
  int* br = static_cast<int*>(bar);
  float* dwf = static_cast<float*>(dw);
  float* dbf = static_cast<float*>(db);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || N <= 0 || P <= 0 || P > R) return (int)cudaErrorInvalidValue;
  if (dtype == 2) return (int)launch_bwd<__nv_bfloat16>(x, wf, m, r, g, dx, pt, st, dwf, dbf, br, R, N, P, vec, s);
  if (dtype == 1) return (int)launch_bwd<__half>(x, wf, m, r, g, dx, pt, st, dwf, dbf, br, R, N, P, vec, s);
  if (dtype == 0) return (int)launch_bwd<float>(x, wf, m, r, g, dx, pt, st, dwf, dbf, br, R, N, P, vec, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dstt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
