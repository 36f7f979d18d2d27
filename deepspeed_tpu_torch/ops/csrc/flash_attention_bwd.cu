// Flash attention backward for Hopper (sm_90a): two kernels.
//
// Replaces the Pallas kernels of deepspeed_tpu/ops/pallas/flash_attention.py,
// driven by `_flash_bwd` (:293):
//  * B2 `_bwd_dq_kernel` (:167): P = exp(qs.K^T - lse), dS = P o (dO.V^T -
//    delta), dQ = scale . sum_k dS.K. The dq kernel here also computes
//    delta = rowsum(dO o O) (done outside the Pallas kernels, :298) for its
//    rows and writes it for the dk/dv kernel, which runs after it on the
//    same stream.
//  * B3 `_bwd_dkv_kernel` (:215): dV = sum_q P^T.dO, dK = scale . sum_q
//    dS^T.Q, summed over the GQA group of q heads that share a kv head.
// Numerics follow the TPU kernels: the scale is folded into q for dq and
// into k for dk/dv (`ks`, :248), each rounded to the storage dtype; P is
// rounded to the storage dtype before P^T.dO (`p16`, :266) and dS before
// both of its products (:203, :272); masked scores are -1e30 (NEG_INF :34);
// all sums are f32 and the scale is applied once at the end.
//
// What bounds them on the H100: at the training shape of GPT-2 1.3B (B = 8,
// T = 1024, H = 16, D = 128, causal) dq does three products and dk/dv four
// over the causal half of the T x T pairs (~52 and ~69 GFLOP, ~0.05 and
// ~0.07 ms at 989 TFLOP/s bf16), against ~0.01 ms of bytes: both are
// bound by the tensor cores.
//
// Design (a first, simple pair of kernels; wgmma and TMA are later work):
//  * dq: one block of 4 warps per (64-row q tile, q head, batch row); each
//    warp owns 16 q rows. The block loops over the visible K/V tiles,
//    double-buffered through shared memory with cp.async; under causal
//    masking it stops at the diagonal tile. Q (scaled) and dO stay in
//    shared memory.
//  * dk/dv: one block of 4 warps per (64-row k tile, kv head, batch row);
//    each warp owns 16 keys. The block loops over the GQA group and, for
//    each member, over the visible q tiles (Q, dO, lse and delta tiles
//    double-buffered with cp.async). This loop takes the place of the TPU
//    kernel's sequential group axis with its VMEM scratch carry: blocks of
//    a grid do not run in order on the card, so the sum over the group
//    stays in registers, with no atomics, and is deterministic.
//  * Every product runs on mma.sync.m16n8k16 (bf16 or fp16 in, f32 out).
//    The score tile is computed transposed in the dk/dv kernel (S^T =
//    Ks.Q^T, keys as rows), so P^T and dS^T are already in the A-operand
//    register layout of P^T.dO and dS^T.Q and never touch shared memory.
//  * float32 inputs take plain FMA kernels: one warp per query row (dq) or
//    per key row (dk/dv).
//
// C interface (route (b) of the build: nvcc -shared, loaded with ctypes):
// each launch returns cudaGetLastError() so the Python wrapper can raise.

#include "attention_common.cuh"

namespace {

using namespace dstt;

constexpr int BLOCK = 64;   // rows of a q tile and of a k tile
constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr float NEG_BIG = -1e30f;   // the TPU kernels' NEG_INF

// element strides of q, k, v, o and dO (batch, time, head); the head dim is
// contiguous. dq, dk and dv are written contiguous [B, T, heads, D].
struct Strides {
  long long q_b, q_t, q_h, k_b, k_t, k_h, v_b, v_t, v_h, o_b, o_t, o_h,
      do_b, do_t, do_h;
};

// 4-byte global -> shared copy (lse and delta rows need no 16-byte
// alignment); zero-fills when !valid
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a), "l"(gmem), "r"(n));
}

// rows [row0, row0 + 64) of a [T, D] slice into a padded shared tile, with
// plain loads, optionally scaled in the storage dtype; rows past T are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride_t,
                                          int row0, int T_len, float scale,
                                          bool scaled, int tid) {
  constexpr int LD = D + 8, VEC = 8, CHUNKS = D / VEC;
  for (int c = tid; c < BLOCK * CHUNKS; c += NUM_THREADS) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * VEC;
    const int row = row0 + r;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (row < T_len) raw = *reinterpret_cast<const uint4*>(src + (long long)row * stride_t + col);
    if (scaled) {
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) e[i] = from_float<T>(to_float(e[i]) * scale);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + col) = raw;
  }
}

// the same with cp.async (the caller commits)
template <typename T, int D>
__device__ __forceinline__ void async_tile(T* dst, const T* src, long long stride_t,
                                           int row0, int T_len, int tid) {
  constexpr int LD = D + 8, VEC = 8, CHUNKS = D / VEC;
  for (int c = tid; c < BLOCK * CHUNKS; c += NUM_THREADS) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * VEC;
    const int row = row0 + r;
    const bool ok = row < T_len;
    cp_async16(dst + r * LD + col, src + (long long)(ok ? row : 0) * stride_t + col, ok);
  }
}

// c[16 x 64] = A[r0 .. r0+16, :D] . B^T, A and B padded shared tiles with
// rows of D; B holds the 64 columns of c as its rows
template <typename T, int D>
__device__ __forceinline__ void mm_abt(float (&c)[BLOCK / 8][4], const T* sA, int r0,
                                       const T* sB, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int i = 0; i < BLOCK / 8; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, sA + (r0 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int np = 0; np < BLOCK / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, sB + (np * 16 + (lane / 16) * 8 + (lane % 8)) * LD + kk * 16 + ((lane / 8) % 2) * 8);
      mma16816<T>(c[2 * np], a, b);
      mma16816<T>(c[2 * np + 1], a, b + 2);
    }
  }
}

// acc[16 x D] += F . B, F a 16 x 64 A operand in registers, B a padded
// shared tile of 64 rows of D
template <typename T, int D>
__device__ __forceinline__ void mm_fb(float (&acc)[D / 8][4], const uint32_t (&f)[BLOCK / 16][4],
                                      const T* sB, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < BLOCK / 16; ++kk) {
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, sB + (kk * 16 + ((lane / 8) % 2) * 8 + (lane % 8)) * LD + dp * 16 + (lane / 16) * 8);
      mma16816<T>(acc[2 * dp], f[kk], b);
      mma16816<T>(acc[2 * dp + 1], f[kk], b + 2);
    }
  }
}

// the f32 accumulator layout of a 16 x 64 tile -> its A-operand layout in
// the storage dtype (rounds each value once)
template <typename T>
__device__ __forceinline__ void to_frag(uint32_t (&f)[BLOCK / 16][4], const float (&x)[BLOCK / 8][4]) {
#pragma unroll
  for (int nt = 0; nt < BLOCK / 8; ++nt) {
    f[nt / 2][(nt % 2) * 2 + 0] = pack2<T>(x[nt][0], x[nt][1]);
    f[nt / 2][(nt % 2) * 2 + 1] = pack2<T>(x[nt][2], x[nt][3]);
  }
}

// store a warp's 16 x D f32 accumulator (times mul) to rows of a
// contiguous [B, T, heads, D] output
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[D / 8][4], int row_a,
                                           int T_len, long long row_stride, float mul, int t4) {
  const int row_b = row_a + 8;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int d = i * 8 + 2 * t4;
    if (row_a < T_len)
      *reinterpret_cast<uint32_t*>(out + row_a * row_stride + d) =
          pack2<T>(acc[i][0] * mul, acc[i][1] * mul);
    if (row_b < T_len)
      *reinterpret_cast<uint32_t*>(out + row_b * row_stride + d) =
          pack2<T>(acc[i][2] * mul, acc[i][3] * mul);
  }
}

// ---------------------------------------------------------------- B2: dq

template <typename T, int D>
__global__ void __launch_bounds__(NUM_THREADS)
bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ o,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  float* __restrict__ delta, T* __restrict__ dq, int T_len,
                  int H, int KH, Strides st, float scale, int causal) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);   // [BLOCK][LD], q * scale
  T* sdO = sQ + BLOCK * LD;                 // [BLOCK][LD]
  T* sK = sdO + BLOCK * LD;                 // [2][BLOCK][LD]
  T* sV = sK + 2 * BLOCK * LD;              // [2][BLOCK][LD]
  __shared__ float sDelta[BLOCK];

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = qt * BLOCK;
  const long long bh = (long long)b * H + h;

  const T* kb = k + b * st.k_b + kh * st.k_h;
  const T* vb = v + b * st.v_b + kh * st.v_h;

  int n_kt = (T_len + BLOCK - 1) / BLOCK;
  if (causal) n_kt = min(n_kt, qt + 1);   // tile qt is the diagonal

  auto load_kv = [&](int tile, int buf) {
    async_tile<T, D>(sK + buf * BLOCK * LD, kb, st.k_t, tile * BLOCK, T_len, tid);
    async_tile<T, D>(sV + buf * BLOCK * LD, vb, st.v_t, tile * BLOCK, T_len, tid);
    cp_async_commit();
  };
  load_kv(0, 0);
  load_tile<T, D>(sQ, q + b * st.q_b + h * st.q_h, st.q_t, q0, T_len, scale, true, tid);
  load_tile<T, D>(sdO, dout + b * st.do_b + h * st.do_h, st.do_t, q0, T_len, 1.f, false, tid);
  __syncthreads();

  // delta = rowsum(dO o O) in f32, two threads per row
  {
    const int r = tid / 2, half = tid % 2, row = q0 + r;
    float acc = 0.f;
    if (row < T_len) {
      const T* orow = o + b * st.o_b + h * st.o_h + (long long)row * st.o_t + half * (D / 2);
      const T* drow = sdO + r * LD + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        uint4 ro = *reinterpret_cast<const uint4*>(orow + c);
        uint4 rd = *reinterpret_cast<const uint4*>(drow + c);
        const T* eo = reinterpret_cast<const T*>(&ro);
        const T* ed = reinterpret_cast<const T*>(&rd);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc += to_float(ed[i]) * to_float(eo[i]);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      sDelta[r] = acc;
      if (row < T_len) delta[bh * T_len + row] = acc;
    }
  }
  __syncthreads();

  const int wr = warp * 16, g = lane / 4, t4 = lane % 4;
  const int row_a = q0 + wr + g, row_b = row_a + 8;
  const float lse_a = row_a < T_len ? lse[bh * T_len + row_a] : 0.f;
  const float lse_b = row_b < T_len ? lse[bh * T_len + row_b] : 0.f;
  const float dl_a = sDelta[wr + g], dl_b = sDelta[wr + g + 8];
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
    const T* cK = sK + buf * BLOCK * LD;
    const T* cV = sV + buf * BLOCK * LD;

    // P = exp(qs.K^T - lse), 16 x 64 per warp
    float s[BLOCK / 8][4];
    mm_abt<T, D>(s, sQ, wr, cK, lane);
    const int k0 = j * BLOCK;
    const bool masked = (causal && j == qt) || k0 + BLOCK > T_len;
#pragma unroll
    for (int nt = 0; nt < BLOCK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t4 + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        float x = s[nt][e];
        if (masked && (col >= T_len || (causal && col > row))) x = NEG_BIG;
        s[nt][e] = __expf(x - (e < 2 ? lse_a : lse_b));
      }
    }
    // dS = P o (dO.V^T - delta), rounded to the storage dtype
    float dp[BLOCK / 8][4];
    mm_abt<T, D>(dp, sdO, wr, cV, lane);
#pragma unroll
    for (int nt = 0; nt < BLOCK / 8; ++nt) {
      dp[nt][0] = s[nt][0] * (dp[nt][0] - dl_a);
      dp[nt][1] = s[nt][1] * (dp[nt][1] - dl_a);
      dp[nt][2] = s[nt][2] * (dp[nt][2] - dl_b);
      dp[nt][3] = s[nt][3] * (dp[nt][3] - dl_b);
    }
    uint32_t dsf[BLOCK / 16][4];
    to_frag<T>(dsf, dp);
    // dQ += dS . K
    mm_fb<T, D>(acc, dsf, cK, lane);
    __syncthreads();   // this buffer is refilled by the next prefetch
  }
  store_rows<T, D>(dq + (long long)b * T_len * H * D + h * D, acc, row_a, T_len,
                   (long long)H * D, scale, t4);
}

// -------------------------------------------------------------- B3: dk/dv

template <typename T, int D>
__global__ void __launch_bounds__(NUM_THREADS)
bwd_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   T* __restrict__ dk, T* __restrict__ dv, int T_len, int H,
                   int KH, Strides st, float scale, int causal) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);   // [BLOCK][LD], k * scale
  T* sV = sK + BLOCK * LD;                  // [BLOCK][LD]
  T* sQ = sV + BLOCK * LD;                  // [2][BLOCK][LD]
  T* sdO = sQ + 2 * BLOCK * LD;             // [2][BLOCK][LD]
  float* sL = reinterpret_cast<float*>(sdO + 2 * BLOCK * LD);   // [2][BLOCK]
  float* sDl = sL + 2 * BLOCK;                                  // [2][BLOCK]

  const int kt = blockIdx.x;   // under causal masking tile 0 sees the most
  const int kh = blockIdx.y, b = blockIdx.z;
  const int rep = H / KH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = kt * BLOCK;
  const int n_qt = (T_len + BLOCK - 1) / BLOCK;
  const int q_first = causal ? kt : 0;   // earlier q tiles see none of these keys
  const int per_head = n_qt - q_first;
  const int n_it = rep * per_head;       // (group member, q tile) pairs

  auto load_q = [&](int it, int buf) {
    const int hh = kh * rep + it / per_head;
    const int q0 = (q_first + it % per_head) * BLOCK;
    async_tile<T, D>(sQ + buf * BLOCK * LD, q + b * st.q_b + hh * st.q_h, st.q_t, q0, T_len, tid);
    async_tile<T, D>(sdO + buf * BLOCK * LD, dout + b * st.do_b + hh * st.do_h, st.do_t, q0,
                     T_len, tid);
    if (tid < BLOCK) {
      const int row = q0 + tid;
      const bool ok = row < T_len;
      const long long off = ((long long)b * H + hh) * T_len + (ok ? row : 0);
      cp_async4(sL + buf * BLOCK + tid, lse + off, ok);
      cp_async4(sDl + buf * BLOCK + tid, delta + off, ok);
    }
    cp_async_commit();
  };
  if (n_it > 0) load_q(0, 0);
  load_tile<T, D>(sK, k + b * st.k_b + kh * st.k_h, st.k_t, k0, T_len, scale, true, tid);
  load_tile<T, D>(sV, v + b * st.v_b + kh * st.v_h, st.v_t, k0, T_len, 1.f, false, tid);

  const int wr = warp * 16, g = lane / 4, t4 = lane % 4;
  const int row_a = k0 + wr + g, row_b = row_a + 8;   // key rows of this thread
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) {
      load_q(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int qt = q_first + it % per_head, q0 = qt * BLOCK;
    const T* cQ = sQ + buf * BLOCK * LD;
    const T* cdO = sdO + buf * BLOCK * LD;
    const float* cL = sL + buf * BLOCK;
    const float* cDl = sDl + buf * BLOCK;

    // P^T = exp(Ks.Q^T - lse), keys as rows: 16 x 64 per warp
    float s[BLOCK / 8][4];
    mm_abt<T, D>(s, sK, wr, cQ, lane);
    const bool masked = (causal && qt == kt) || q0 + BLOCK > T_len;
#pragma unroll
    for (int nt = 0; nt < BLOCK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t4 + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        float x = s[nt][e];
        if (masked && (q0 + c >= T_len || (causal && q0 + c < row))) x = NEG_BIG;
        s[nt][e] = __expf(x - cL[c]);
      }
    }
    // dV += P^T . dO, P rounded to the storage dtype
    uint32_t f[BLOCK / 16][4];
    to_frag<T>(f, s);
    mm_fb<T, D>(dv_acc, f, cdO, lane);
    // dS^T = P^T o (V.dO^T - delta), rounded; dK += dS^T . Q
    float dp[BLOCK / 8][4];
    mm_abt<T, D>(dp, sV, wr, cdO, lane);
#pragma unroll
    for (int nt = 0; nt < BLOCK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[nt][e] = s[nt][e] * (dp[nt][e] - cDl[nt * 8 + 2 * t4 + (e & 1)]);
    }
    to_frag<T>(f, dp);
    mm_fb<T, D>(dk_acc, f, cQ, lane);
    __syncthreads();   // this buffer is refilled by the next prefetch
  }
  const long long off = (long long)b * T_len * KH * D + kh * D;
  store_rows<T, D>(dk + off, dk_acc, row_a, T_len, (long long)KH * D, scale, t4);
  store_rows<T, D>(dv + off, dv_acc, row_a, T_len, (long long)KH * D, 1.f, t4);
}

// ------------------------------------------------------------ float32 path

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// dq: one warp per query row, each lane holding D/32 columns
template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ o,
                  const float* __restrict__ dout, const float* __restrict__ lse,
                  float* __restrict__ delta, float* __restrict__ dq, int T_len,
                  int H, int KH, Strides st, float scale, int causal) {
  constexpr int E = D / 32;
  const int row = blockIdx.x * NUM_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= T_len) return;
  const int kh = h / (H / KH);
  const long long bh = (long long)b * H + h;
  const float* qr = q + b * st.q_b + (long long)row * st.q_t + h * st.q_h;
  const float* orow = o + b * st.o_b + (long long)row * st.o_t + h * st.o_h;
  const float* dr = dout + b * st.do_b + (long long)row * st.do_t + h * st.do_h;
  const float* kb = k + b * st.k_b + kh * st.k_h;
  const float* vb = v + b * st.v_b + kh * st.v_h;
  float qv[E], dov[E], acc[E], dl = 0.f;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    qv[i] = qr[lane + 32 * i] * scale;
    dov[i] = dr[lane + 32 * i];
    dl += dov[i] * orow[lane + 32 * i];
    acc[i] = 0.f;
  }
  dl = warp_sum(dl);
  if (lane == 0) delta[bh * T_len + row] = dl;
  const float L = lse[bh * T_len + row];
  const int n_keys = causal ? row + 1 : T_len;
  for (int c = 0; c < n_keys; ++c) {
    const float* kr = kb + (long long)c * st.k_t;
    const float* vr = vb + (long long)c * st.v_t;
    float s = 0.f, dp = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      s = fmaf(qv[i], kr[lane + 32 * i], s);
      dp = fmaf(dov[i], vr[lane + 32 * i], dp);
    }
    s = warp_sum(s);
    dp = warp_sum(dp);
    const float ds = __expf(s - L) * (dp - dl);
#pragma unroll
    for (int i = 0; i < E; ++i) acc[i] = fmaf(ds, kr[lane + 32 * i], acc[i]);
  }
  float* out = dq + ((long long)b * T_len + row) * H * D + h * D;
#pragma unroll
  for (int i = 0; i < E; ++i) out[lane + 32 * i] = acc[i] * scale;
}

// dk/dv: one warp per key row, looping over the GQA group and the query
// rows that see it
template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dk, float* __restrict__ dv, int T_len,
                   int H, int KH, Strides st, float scale, int causal) {
  constexpr int E = D / 32;
  const int row = blockIdx.x * NUM_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kh = blockIdx.y, b = blockIdx.z;
  if (row >= T_len) return;
  const int rep = H / KH;
  const float* kr = k + b * st.k_b + (long long)row * st.k_t + kh * st.k_h;
  const float* vr = v + b * st.v_b + (long long)row * st.v_t + kh * st.v_h;
  float ks[E], vv[E], dka[E], dva[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    ks[i] = kr[lane + 32 * i] * scale;
    vv[i] = vr[lane + 32 * i];
    dka[i] = dva[i] = 0.f;
  }
  for (int hh = kh * rep; hh < (kh + 1) * rep; ++hh) {
    const long long bh = (long long)b * H + hh;
    for (int r = causal ? row : 0; r < T_len; ++r) {
      const float* qr = q + b * st.q_b + (long long)r * st.q_t + hh * st.q_h;
      const float* dr = dout + b * st.do_b + (long long)r * st.do_t + hh * st.do_h;
      float s = 0.f, dp = 0.f, qv[E], dov[E];
#pragma unroll
      for (int i = 0; i < E; ++i) {
        qv[i] = qr[lane + 32 * i];
        dov[i] = dr[lane + 32 * i];
        s = fmaf(qv[i], ks[i], s);
        dp = fmaf(dov[i], vv[i], dp);
      }
      s = warp_sum(s);
      dp = warp_sum(dp);
      const float p = __expf(s - lse[bh * T_len + r]);
      const float ds = p * (dp - delta[bh * T_len + r]);
#pragma unroll
      for (int i = 0; i < E; ++i) {
        dva[i] = fmaf(p, dov[i], dva[i]);
        dka[i] = fmaf(ds, qv[i], dka[i]);
      }
    }
  }
  const long long off = ((long long)b * T_len + row) * KH * D + kh * D;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    dk[off + lane + 32 * i] = dka[i] * scale;
    dv[off + lane + 32 * i] = dva[i];
  }
}

// ---------------------------------------------------------------- launches

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, T_len, H, KH;
  Strides st;
  float scale;
  int causal;
  cudaStream_t stream;
};

constexpr size_t tile_bytes(int D, size_t elem) { return (size_t)BLOCK * (D + 8) * elem; }

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  const size_t smem = 6 * tile_bytes(D, sizeof(T));
  // per device, so it is set on every launch (a host-side call, no sync)
  cudaError_t e = cudaFuncSetAttribute(bwd_dq_mma_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.T_len + BLOCK - 1) / BLOCK, a.H, a.B);
  bwd_dq_mma_kernel<T, D><<<grid, NUM_THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse, a.delta,
      static_cast<T*>(a.dq), a.T_len, a.H, a.KH, a.st, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  const size_t smem = 6 * tile_bytes(D, sizeof(T)) + 4 * BLOCK * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(bwd_dkv_mma_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.T_len + BLOCK - 1) / BLOCK, a.KH, a.B);
  bwd_dkv_mma_kernel<T, D><<<grid, NUM_THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.T_len, a.H, a.KH, a.st, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_f32(const Args& a) {
  dim3 grid((a.T_len + NUM_WARPS - 1) / NUM_WARPS, a.H, a.B);
  bwd_dq_f32_kernel<D><<<grid, NUM_THREADS, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.o),
      static_cast<const float*>(a.dout), a.lse, a.delta, static_cast<float*>(a.dq), a.T_len,
      a.H, a.KH, a.st, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const Args& a) {
  dim3 grid((a.T_len + NUM_WARPS - 1) / NUM_WARPS, a.KH, a.B);
  bwd_dkv_f32_kernel<D><<<grid, NUM_THREADS, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.T_len, a.H, a.KH, a.st, a.scale,
      a.causal);
  return cudaGetLastError();
}


bool bad_shape(int B, int T_len, int H, int KH) {
  return B <= 0 || T_len <= 0 || H <= 0 || KH <= 0 || H % KH;
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16. Strides (in elements, 15 of
// them: q, k, v, o, dO, each batch/time/head) with a contiguous head dim.
// lse and delta are [B, H, T] float32, contiguous; dq is a contiguous
// [B, T, H, D]. Writes delta = rowsum(dO o O) for the dk/dv kernel.
extern "C" int dstt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, int B, int T_len, int H, int KH, int D,
    long long q_b, long long q_t, long long q_h, long long k_b, long long k_t,
    long long k_h, long long v_b, long long v_t, long long v_h, long long o_b,
    long long o_t, long long o_h, long long do_b, long long do_t, long long do_h,
    float scale, int causal, int dtype, void* stream) {
  if (bad_shape(B, T_len, H, KH)) return (int)cudaErrorInvalidValue;
  const Strides st{q_b, q_t, q_h, k_b, k_t, k_h, v_b, v_t, v_h, o_b, o_t, o_h, do_b, do_t, do_h};
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta),
               dq, nullptr, nullptr, B, T_len, H, KH, st, scale, causal,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 2 && D == 64) return (int)launch_dq<__nv_bfloat16, 64>(a);
  if (dtype == 2 && D == 128) return (int)launch_dq<__nv_bfloat16, 128>(a);
  if (dtype == 1 && D == 64) return (int)launch_dq<__half, 64>(a);
  if (dtype == 1 && D == 128) return (int)launch_dq<__half, 128>(a);
  if (dtype == 0 && D == 64) return (int)launch_dq_f32<64>(a);
  if (dtype == 0 && D == 128) return (int)launch_dq_f32<128>(a);
  return (int)cudaErrorInvalidValue;
}

// Reads q, k, v and dO (12 strides: each batch/time/head) and the delta the
// dq kernel wrote; no o. dk and dv are contiguous [B, T, KH, D].
extern "C" int dstt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, int B, int T_len, int H, int KH, int D,
    long long q_b, long long q_t, long long q_h, long long k_b, long long k_t,
    long long k_h, long long v_b, long long v_t, long long v_h, long long do_b,
    long long do_t, long long do_h, float scale, int causal, int dtype, void* stream) {
  if (bad_shape(B, T_len, H, KH)) return (int)cudaErrorInvalidValue;
  const Strides st{q_b, q_t, q_h, k_b, k_t, k_h, v_b, v_t, v_h, 0, 0, 0, do_b, do_t, do_h};
  const Args a{q, k, v, nullptr, dout, static_cast<const float*>(lse),
               const_cast<float*>(static_cast<const float*>(delta)), nullptr, dk, dv, B,
               T_len, H, KH, st, scale, causal, static_cast<cudaStream_t>(stream)};
  if (dtype == 2 && D == 64) return (int)launch_dkv<__nv_bfloat16, 64>(a);
  if (dtype == 2 && D == 128) return (int)launch_dkv<__nv_bfloat16, 128>(a);
  if (dtype == 1 && D == 64) return (int)launch_dkv<__half, 64>(a);
  if (dtype == 1 && D == 128) return (int)launch_dkv<__half, 128>(a);
  if (dtype == 0 && D == 64) return (int)launch_dkv_f32<64>(a);
  if (dtype == 0 && D == 128) return (int)launch_dkv_f32<128>(a);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dstt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
