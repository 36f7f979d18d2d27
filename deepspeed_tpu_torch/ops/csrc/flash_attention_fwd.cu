// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_fwd_kernel`
// (deepspeed_tpu/ops/pallas/flash_attention.py:65, driven by `_flash_fwd`
// :125): causal or full attention with an online softmax, O and the f32
// log-sum-exp LSE = m + log(l) as outputs. Numerics follow the TPU kernel:
// the softmax scale is folded into q in the storage dtype, P is rounded to
// the storage dtype before P.V, and m, l and the accumulator are f32.
//
// What bounds it on the H100: at the prefill shapes of GPT-2 XL (D = 64,
// T = 1024) the bytes of q, k, v and o and the causal half of the
// 4.B.H.T^2.D operations take about the same least time (3.35 TB/s,
// 989 TFLOP/s bf16), so both the tensor cores and the memory stream have to
// be kept busy.
//
// Design (a first, simple kernel; wgmma and TMA are later work):
//  * one block of 4 warps per (64-row q tile, q head, batch row); each warp
//    owns 16 q rows. GQA reads kv head h / (H / KH); k/v are never
//    repeated.
//  * K/V tiles of 64 keys stream through shared memory with cp.async, two
//    buffers deep, so the next tile loads while this one is multiplied.
//    Rows are padded by 16 bytes so ldmatrix reads are free of bank
//    conflicts; keys past T are zero-filled.
//  * S = Q.K^T and O += P.V run on the tensor cores with
//    mma.sync.m16n8k16 (bf16 or fp16 in, f32 out). The S accumulator's
//    register layout is the A-operand layout of the P.V product, so P never
//    leaves registers.
//  * Causal: key tiles past the diagonal are skipped; only the diagonal
//    tile and the ragged last tile pay for the mask. Blocks are issued
//    heaviest (last q tile) first to even out the causal triangle.
//  * float32 inputs take a plain FMA kernel: one warp per query row.
//
// C interface (route (b) of the build: nvcc -shared, loaded with ctypes):
// the launch returns cudaGetLastError() so the Python wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;   // query rows per block (4 warps x 16)
constexpr int BLOCK_N = 64;   // keys per tile
constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }

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
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Strides {
  long long q_b, q_t, q_h, k_b, k_t, k_h, v_b, v_t, v_h, o_b, o_t, o_h;
};

template <typename T, int D>
__global__ void __launch_bounds__(NUM_THREADS)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int T_len, int H, int KH,
                     Strides st, float scale, int causal) {
  constexpr int LD = D + 8;          // padded shared row, in elements
  constexpr int VEC = 8;             // elements per 16-byte chunk
  constexpr int CHUNKS = D / VEC;    // chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);   // [BLOCK_M][LD]
  T* sK = sQ + BLOCK_M * LD;                // [2][BLOCK_N][LD]
  T* sV = sK + 2 * BLOCK_N * LD;            // [2][BLOCK_N][LD]

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = qt * BLOCK_M;

  const T* qb = q + b * st.q_b + h * st.q_h;
  const T* kb = k + b * st.k_b + kh * st.k_h;
  const T* vb = v + b * st.v_b + kh * st.v_h;

  int n_kt = (T_len + BLOCK_N - 1) / BLOCK_N;
  if (causal) n_kt = min(n_kt, qt + 1);   // BLOCK_M == BLOCK_N: tile qt is the diagonal

  auto load_kv = [&](int tile, int buf) {
    const int k0 = tile * BLOCK_N;
    T* dK = sK + buf * BLOCK_N * LD;
    T* dV = sV + buf * BLOCK_N * LD;
    for (int c = tid; c < BLOCK_N * CHUNKS; c += NUM_THREADS) {
      const int r = c / CHUNKS, col = (c % CHUNKS) * VEC;
      const int row = k0 + r;
      const bool ok = row < T_len;
      const long long srow = ok ? row : 0;
      cp_async16(dK + r * LD + col, kb + srow * st.k_t + col, ok);
      cp_async16(dV + r * LD + col, vb + srow * st.v_t + col, ok);
    }
    cp_async_commit();
  };

  load_kv(0, 0);

  // Q tile, scaled in the storage dtype: (q * scale).astype(q.dtype)
  for (int c = tid; c < BLOCK_M * CHUNKS; c += NUM_THREADS) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * VEC;
    const int row = q0 + r;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (row < T_len) raw = *reinterpret_cast<const uint4*>(qb + (long long)row * st.q_t + col);
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_float<T>(to_float(e[i]) * scale);
    *reinterpret_cast<uint4*>(sQ + r * LD + col) = raw;
  }
  __syncthreads();

  const int wr = warp * 16;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], sQ + (wr + (lane % 8) + ((lane / 8) % 2) * 8) * LD + kk * 16 + (lane / 16) * 8);

  const int g = lane / 4, t4 = lane % 4;
  const int row_a = q0 + wr + g, row_b = row_a + 8;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};   // per-thread partial row sums, reduced at the end
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j = 0; j < n_kt; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_kt) {
      load_kv(j + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* cK = sK + buf * BLOCK_N * LD;
    const T* cV = sV + buf * BLOCK_N * LD;

    // S = Qs . K^T, 16 x 64 per warp
    float s[BLOCK_N / 8][4];
#pragma unroll
    for (int i = 0; i < BLOCK_N / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BLOCK_N / 16; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, cK + (np * 16 + (lane / 16) * 8 + (lane % 8)) * LD + kk * 16 + ((lane / 8) % 2) * 8);
        mma16816<T>(s[2 * np], qf[kk], bf);
        mma16816<T>(s[2 * np + 1], qf[kk], bf + 2);
      }
    }

    const int k0 = j * BLOCK_N;
    if ((causal && j == qt) || k0 + BLOCK_N > T_len) {
#pragma unroll
      for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + nt * 8 + 2 * t4 + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          if (col >= T_len || (causal && col > row)) s[nt][e] = -INFINITY;
        }
      }
    }

    // online softmax: new running max, rescale factor, P in registers
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float base[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      base[i] = mx[i] == -INFINITY ? 0.f : mx[i];
      alpha[i] = __expf(m_r[i] - base[i]);
      m_r[i] = mx[i];
    }
    uint32_t pf[BLOCK_N / 16][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
      const float p0 = __expf(s[nt][0] - base[0]), p1 = __expf(s[nt][1] - base[0]);
      const float p2 = __expf(s[nt][2] - base[1]), p3 = __expf(s[nt][3] - base[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pf[nt / 2][(nt % 2) * 2 + 0] = pack2<T>(p0, p1);
      pf[nt / 2][(nt % 2) * 2 + 1] = pack2<T>(p2, p3);
    }
    l_r[0] = l_r[0] * alpha[0] + rs[0];
    l_r[1] = l_r[1] * alpha[1] + rs[1];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    // O += P . V
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, cV + (kk * 16 + ((lane / 8) % 2) * 8 + (lane % 8)) * LD + dp * 16 + (lane / 16) * 8);
        mma16816<T>(acc[2 * dp], pf[kk], bf);
        mma16816<T>(acc[2 * dp + 1], pf[kk], bf + 2);
      }
    }
    __syncthreads();   // this buffer is refilled by the next prefetch
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
  T* ob = o + b * st.o_b + h * st.o_h;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int d = i * 8 + 2 * t4;
    if (row_a < T_len)
      *reinterpret_cast<uint32_t*>(ob + (long long)row_a * st.o_t + d) =
          pack2<T>(acc[i][0] / l_r[0], acc[i][1] / l_r[0]);
    if (row_b < T_len)
      *reinterpret_cast<uint32_t*>(ob + (long long)row_b * st.o_t + d) =
          pack2<T>(acc[i][2] / l_r[1], acc[i][3] / l_r[1]);
  }
  if (t4 == 0) {
    float* lb = lse + ((long long)b * H + h) * T_len;
    if (row_a < T_len) lb[row_a] = m_r[0] + logf(l_r[0]);
    if (row_b < T_len) lb[row_b] = m_r[1] + logf(l_r[1]);
  }
}

// float32: one warp per query row, each lane holding D/32 columns
template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int T_len, int H, int KH,
                     Strides st, float scale, int causal) {
  constexpr int E = D / 32;
  const int row = blockIdx.x * NUM_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= T_len) return;
  const int kh = h / (H / KH);
  const float* qr = q + b * st.q_b + (long long)row * st.q_t + h * st.q_h;
  const float* kb = k + b * st.k_b + kh * st.k_h;
  const float* vb = v + b * st.v_b + kh * st.v_h;
  float qv[E], acc[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    qv[i] = qr[lane + 32 * i] * scale;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const int n_keys = causal ? row + 1 : T_len;
  for (int c = 0; c < n_keys; ++c) {
    const float* kr = kb + (long long)c * st.k_t;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) s = fmaf(qv[i], kr[lane + 32 * i], s);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
    const float mn = fmaxf(m, s);
    const float alpha = __expf(m - mn), p = __expf(s - mn);
    l = l * alpha + p;
    const float* vr = vb + (long long)c * st.v_t;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[i] = fmaf(p, vr[lane + 32 * i], acc[i] * alpha);
    m = mn;
  }
  float* orow = o + b * st.o_b + (long long)row * st.o_t + h * st.o_h;
#pragma unroll
  for (int i = 0; i < E; ++i) orow[lane + 32 * i] = acc[i] / l;
  if (lane == 0) lse[((long long)b * H + h) * T_len + row] = m + logf(l);
}

template <typename T, int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int T_len, int H, int KH,
                       const Strides& st, float scale, int causal,
                       cudaStream_t stream) {
  const size_t smem = (size_t)(BLOCK_M + 4 * BLOCK_N) * (D + 8) * sizeof(T);
  // per device, so it is set on every launch (a host-side call, no sync)
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_mma_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((T_len + BLOCK_M - 1) / BLOCK_M, H, B);
  flash_fwd_mma_kernel<T, D><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, T_len, H, KH, st, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int T_len, int H, int KH,
                       const Strides& st, float scale, int causal,
                       cudaStream_t stream) {
  dim3 grid((T_len + NUM_WARPS - 1) / NUM_WARPS, H, B);
  flash_fwd_f32_kernel<D><<<grid, NUM_THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, T_len, H, KH,
      st, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16. Strides are in elements; the
// head dim must be contiguous. lse is [B, H, T] float32, contiguous.
extern "C" int dstt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int T_len, int H, int KH, int D, long long q_b, long long q_t,
    long long q_h, long long k_b, long long k_t, long long k_h, long long v_b,
    long long v_t, long long v_h, long long o_b, long long o_t, long long o_h,
    float scale, int causal, int dtype, void* stream) {
  const Strides st{q_b, q_t, q_h, k_b, k_t, k_h, v_b, v_t, v_h, o_b, o_t, o_h};
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T_len <= 0 || H <= 0 || KH <= 0 || H % KH) return (int)cudaErrorInvalidValue;
  if (dtype == 2 && D == 64) return (int)launch_mma<__nv_bfloat16, 64>(q, k, v, o, l, B, T_len, H, KH, st, scale, causal, s);
  if (dtype == 2 && D == 128) return (int)launch_mma<__nv_bfloat16, 128>(q, k, v, o, l, B, T_len, H, KH, st, scale, causal, s);
  if (dtype == 1 && D == 64) return (int)launch_mma<__half, 64>(q, k, v, o, l, B, T_len, H, KH, st, scale, causal, s);
  if (dtype == 1 && D == 128) return (int)launch_mma<__half, 128>(q, k, v, o, l, B, T_len, H, KH, st, scale, causal, s);
  if (dtype == 0 && D == 64) return (int)launch_f32<64>(q, k, v, o, l, B, T_len, H, KH, st, scale, causal, s);
  if (dtype == 0 && D == 128) return (int)launch_f32<128>(q, k, v, o, l, B, T_len, H, KH, st, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dstt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
