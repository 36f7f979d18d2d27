// Paged chunked-prefill attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_paged_chunk_kernel`
// (deepspeed_tpu/ops/pallas/decode_attention.py:292, entry
// `paged_chunk_attention` :350): one slot's C-token prefill chunk at
// absolute positions start..start+C-1 (its own k/v already written into the
// pool) attends the slot's resident prefix and itself through the slot's
// block-table row; key position col is visible to chunk query qi iff
// col <= start + qi, and only the MB*BS positions the row covers exist.
// Pools are [NB, BS, KH, D], read through their strides: of q's dtype, or
// int8 with f32 scale tiles [NB, KH, BS] (the kernel's int8 branch,
// `_deq_tile` :46). Numerics: scale folded into q, f32 online softmax (m, l
// and the accumulator), output acc / l. On the tensor cores q.scale and P
// are rounded to the storage dtype before their products, as in the flash
// kernel.
//
// What bounds it on the H100: at the smoke's shape (C = 256 rows per head,
// D = 64, up to 768 keys of prefix) the bytes of q, o and the visible K/V
// and the 4.C.H.keys.D operations take about the same least time, so it is
// built like the flash kernel (flash_attention_fwd.cu), with the block
// table in the K/V loads:
//  * one block of 4 warps per (64-row q tile, q head); each warp owns 16
//    rows. GQA reads kv head h / (H / KH); nothing is repeated.
//  * the TPU's sequential table-entry grid axis becomes the loop over
//    64-key tiles. Each row of a tile is copied from pool block
//    table[pos / BS] at offset pos % BS with cp.async (16 bytes a thread),
//    two buffers deep; the loop stops at the tile holding this q tile's
//    last visible key, so blocks past the chunk are never read.
//  * S = Q.K^T and O += P.V run on mma.sync m16n8k16 with P kept in
//    registers; only tiles that reach past the causal bound of the tile's
//    first row (or past the table) pay for the mask.
//  * int8 pools: an int8 value of at most 127 in magnitude is exact in bf16
//    and fp16, so the tensor-core path is unchanged. The int8 tile and its
//    two scale columns are copied with cp.async (a 64-wide int8 row is 4
//    16-byte chunks, not 8, so the copy has its own layout in shared
//    memory), converted to q's dtype WITHOUT the scale into the tile the
//    ldmatrix addressing expects, and the scales are applied around the
//    products: scale_k per key column to S in f32 after Q.K^T, scale_v per
//    key to P before it is rounded for P.V, while l sums the unscaled P.
//  * float32 inputs take a plain FMA kernel: one warp per query row (int8
//    pools fold the scales into the score and into P, as above).

#include <type_traits>

#include "attention_common.cuh"

namespace {

using namespace dstt;

constexpr int BLOCK_M = 64;   // query rows per block (4 warps x 16)
constexpr int BLOCK_N = 64;   // keys per tile
constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;

struct Args {
  const int* table;    // [MB] block ids of the slot
  const float* ks;     // int8 pools: scale tiles [NB, KH, BS] by (ks_n, ks_h)
  const float* vs;
  int C, H, KH, NB, BS, MB, start;
  long long q_c, q_h, k_n, k_b, k_h, v_n, v_b, v_h, o_c, o_h;
  long long ks_n, ks_h, vs_n, vs_h;
  float scale;
};

// pool row of key position pos (clamped into the pool)
__device__ __forceinline__ long long pool_block(const Args& a, int pos) {
  return min(max(a.table[pos / a.BS], 0), a.NB - 1);
}

// shared memory of the mma kernel: the q tile and the K/V tiles of q's
// dtype (two deep for fp pools; one converted tile for int8 pools, whose
// int8 tiles and scale columns are the two-deep copies)
template <typename T, int D, bool Q8>
constexpr size_t mma_smem_bytes() {
  return (size_t)(BLOCK_M + (Q8 ? 2 : 4) * BLOCK_N) * (D + 8) * sizeof(T)
         + (Q8 ? (size_t)2 * 2 * BLOCK_N * (D + (int)sizeof(float)) : 0);
}

template <typename T, int D, bool Q8>
__global__ void __launch_bounds__(NUM_THREADS)
paged_chunk_mma_kernel(const T* __restrict__ q, const void* __restrict__ kp_,
                       const void* __restrict__ vp_, T* __restrict__ o, Args a) {
  using KV = std::conditional_t<Q8, int8_t, T>;
  constexpr int LD = D + 8;          // padded shared row, in elements
  constexpr int VEC = 8;             // elements per 16-byte chunk
  constexpr int CHUNKS = D / VEC;    // chunks per row
  constexpr int CHUNKS8 = D / 16;    // 16-byte chunks per int8 row
  constexpr int KV_BUFS = Q8 ? 1 : 2;
  const KV* kp = static_cast<const KV*>(kp_);
  const KV* vp = static_cast<const KV*>(vp_);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);   // [BLOCK_M][LD]
  T* sK = sQ + BLOCK_M * LD;                // [KV_BUFS][BLOCK_N][LD]
  T* sV = sK + KV_BUFS * BLOCK_N * LD;      // [KV_BUFS][BLOCK_N][LD]
  // int8 pools only: [2][BLOCK_N][D] int8 tiles, [2][BLOCK_N] f32 scales
  int8_t* sK8 = reinterpret_cast<int8_t*>(sV + KV_BUFS * BLOCK_N * LD);
  int8_t* sV8 = sK8 + 2 * BLOCK_N * D;
  float* sKs = reinterpret_cast<float*>(sV8 + 2 * BLOCK_N * D);
  float* sVs = sKs + 2 * BLOCK_N;

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y;
  const int kh = h / (a.H / a.KH);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = qt * BLOCK_M;
  const int span = a.MB * a.BS;

  const T* qb = q + h * a.q_h;
  const KV* kb = kp + kh * a.k_h;
  const KV* vb = vp + kh * a.v_h;

  // keys this q tile can see: positions < start + (its last row) + 1
  const int hi = min(a.start + min(q0 + BLOCK_M, a.C), span);
  const int n_kt = (hi + BLOCK_N - 1) / BLOCK_N;

  auto load_kv = [&](int tile, int buf) {
    const int k0 = tile * BLOCK_N;
    if constexpr (Q8) {
      int8_t* dK = sK8 + buf * BLOCK_N * D;
      int8_t* dV = sV8 + buf * BLOCK_N * D;
      for (int c = tid; c < BLOCK_N * CHUNKS8; c += NUM_THREADS) {
        const int r = c / CHUNKS8, col = (c % CHUNKS8) * 16;
        const int pos = k0 + r;
        const bool ok = pos < hi;
        const int p = ok ? pos : 0;
        const long long blk = pool_block(a, p);
        const long long off = p % a.BS;
        cp_async16(dK + r * D + col, kb + blk * a.k_n + off * a.k_b + col, ok);
        cp_async16(dV + r * D + col, vb + blk * a.v_n + off * a.v_b + col, ok);
      }
      for (int r = tid; r < BLOCK_N; r += NUM_THREADS) {
        const int pos = k0 + r;
        const bool ok = pos < hi;
        const int p = ok ? pos : 0;
        const long long blk = pool_block(a, p);
        const long long off = p % a.BS;
        cp_async4(sKs + buf * BLOCK_N + r, a.ks + blk * a.ks_n + kh * a.ks_h + off, ok);
        cp_async4(sVs + buf * BLOCK_N + r, a.vs + blk * a.vs_n + kh * a.vs_h + off, ok);
      }
    } else {
      T* dK = sK + buf * BLOCK_N * LD;
      T* dV = sV + buf * BLOCK_N * LD;
      for (int c = tid; c < BLOCK_N * CHUNKS; c += NUM_THREADS) {
        const int r = c / CHUNKS, col = (c % CHUNKS) * VEC;
        const int pos = k0 + r;
        const bool ok = pos < hi;
        const int p = ok ? pos : 0;
        const long long blk = pool_block(a, p);
        const long long off = p % a.BS;
        cp_async16(dK + r * LD + col, kb + blk * a.k_n + off * a.k_b + col, ok);
        cp_async16(dV + r * LD + col, vb + blk * a.v_n + off * a.v_b + col, ok);
      }
    }
    cp_async_commit();
  };

  // int8 pools: the arrived int8 tile of buffer buf -> the tile of q's dtype
  // (values as they are; the scales are applied around the products)
  auto convert_kv = [&](int buf) {
    const int8_t* cK8 = sK8 + buf * BLOCK_N * D;
    const int8_t* cV8 = sV8 + buf * BLOCK_N * D;
    for (int c = tid; c < 2 * BLOCK_N * CHUNKS8; c += NUM_THREADS) {
      const int which = c / (BLOCK_N * CHUNKS8), cc = c % (BLOCK_N * CHUNKS8);
      const int r = cc / CHUNKS8, col = (cc % CHUNKS8) * 16;
      const int4 raw = *reinterpret_cast<const int4*>((which ? cV8 : cK8) + r * D + col);
      const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
      uint32_t w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) w[i] = pack2<T>(to_float(e[2 * i]), to_float(e[2 * i + 1]));
      T* dst = (which ? sV : sK) + r * LD + col;
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<uint4*>(dst + 8) = make_uint4(w[4], w[5], w[6], w[7]);
    }
  };

  load_kv(0, 0);

  // Q tile, scaled in the storage dtype: (q * scale).astype(q.dtype)
  for (int c = tid; c < BLOCK_M * CHUNKS; c += NUM_THREADS) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * VEC;
    const int row = q0 + r;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (row < a.C) raw = *reinterpret_cast<const uint4*>(qb + (long long)row * a.q_c + col);
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_float<T>(to_float(e[i]) * a.scale);
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
    if constexpr (Q8) {
      convert_kv(buf);
      __syncthreads();
    }
    const T* cK = sK + (Q8 ? 0 : buf) * BLOCK_N * LD;
    const T* cV = sV + (Q8 ? 0 : buf) * BLOCK_N * LD;

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

    if constexpr (Q8) {   // S = Qs . (scale_k * K_int)^T
      const float* ksc = sKs + buf * BLOCK_N;
#pragma unroll
      for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] *= ksc[nt * 8 + 2 * t4 + (e & 1)];
      }
    }

    const int k0 = j * BLOCK_N;
    if (k0 + BLOCK_N - 1 > a.start + q0 || k0 + BLOCK_N > span) {
#pragma unroll
      for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + nt * 8 + 2 * t4 + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          if (col >= span || col > a.start + row) s[nt][e] = -INFINITY;
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
      float p0 = __expf(s[nt][0] - base[0]), p1 = __expf(s[nt][1] - base[0]);
      float p2 = __expf(s[nt][2] - base[1]), p3 = __expf(s[nt][3] - base[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      if constexpr (Q8) {   // O += (P * scale_v) . V_int; l keeps the unscaled P
        const float* vsc = sVs + buf * BLOCK_N + nt * 8 + 2 * t4;
        p0 *= vsc[0];
        p1 *= vsc[1];
        p2 *= vsc[0];
        p3 *= vsc[1];
      }
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
  T* ob = o + h * a.o_h;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int d = i * 8 + 2 * t4;
    if (row_a < a.C)
      *reinterpret_cast<uint32_t*>(ob + (long long)row_a * a.o_c + d) =
          pack2<T>(acc[i][0] / fmaxf(l_r[0], 1e-30f), acc[i][1] / fmaxf(l_r[0], 1e-30f));
    if (row_b < a.C)
      *reinterpret_cast<uint32_t*>(ob + (long long)row_b * a.o_c + d) =
          pack2<T>(acc[i][2] / fmaxf(l_r[1], 1e-30f), acc[i][3] / fmaxf(l_r[1], 1e-30f));
  }
}

// float32: one warp per query row, each lane holding D/32 columns
template <int D, bool Q8>
__global__ void __launch_bounds__(NUM_THREADS)
paged_chunk_f32_kernel(const float* __restrict__ q, const void* __restrict__ kp_,
                       const void* __restrict__ vp_, float* __restrict__ o, Args a) {
  using KV = std::conditional_t<Q8, int8_t, float>;
  const KV* kp = static_cast<const KV*>(kp_);
  const KV* vp = static_cast<const KV*>(vp_);
  constexpr int E = D / 32;
  const int row = blockIdx.x * NUM_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y;
  if (row >= a.C) return;
  const int kh = h / (a.H / a.KH);
  const float* qr = q + (long long)row * a.q_c + h * a.q_h;
  const KV* kb = kp + kh * a.k_h;
  const KV* vb = vp + kh * a.v_h;
  float qv[E], acc[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    qv[i] = qr[lane + 32 * i] * a.scale;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const int n_keys = min(a.start + row + 1, a.MB * a.BS);
  for (int c = 0; c < n_keys; ++c) {
    const long long blk = pool_block(a, c), off = c % a.BS;
    const KV* kr = kb + blk * a.k_n + off * a.k_b;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) s = fmaf(qv[i], to_float(kr[lane + 32 * i]), s);
#pragma unroll
    for (int sh = 16; sh > 0; sh /= 2) s += __shfl_xor_sync(0xffffffffu, s, sh);
    if constexpr (Q8) s *= a.ks[blk * a.ks_n + kh * a.ks_h + off];
    const float mn = fmaxf(m, s);
    const float alpha = __expf(m - mn), p = __expf(s - mn);
    l = l * alpha + p;
    float pv = p;
    if constexpr (Q8) pv *= a.vs[blk * a.vs_n + kh * a.vs_h + off];
    const KV* vr = vb + blk * a.v_n + off * a.v_b;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[i] = fmaf(pv, to_float(vr[lane + 32 * i]), acc[i] * alpha);
    m = mn;
  }
  float* orow = o + (long long)row * a.o_c + h * a.o_h;
#pragma unroll
  for (int i = 0; i < E; ++i) orow[lane + 32 * i] = acc[i] / fmaxf(l, 1e-30f);
}

template <typename T, int D, bool Q8>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       const Args& a, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<T, D, Q8>();
  // per device, so it is set on every launch (a host-side call, no sync)
  cudaError_t e = cudaFuncSetAttribute(paged_chunk_mma_kernel<T, D, Q8>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.C + BLOCK_M - 1) / BLOCK_M, a.H);
  paged_chunk_mma_kernel<T, D, Q8><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const T*>(q), k, v, static_cast<T*>(o), a);
  return cudaGetLastError();
}

template <int D, bool Q8>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       const Args& a, cudaStream_t stream) {
  dim3 grid((a.C + NUM_WARPS - 1) / NUM_WARPS, a.H);
  paged_chunk_f32_kernel<D, Q8><<<grid, NUM_THREADS, 0, stream>>>(
      static_cast<const float*>(q), k, v, static_cast<float*>(o), a);
  return cudaGetLastError();
}

template <bool Q8>
int dispatch(int dtype, int D, const void* q, const void* k, const void* v,
             void* o, const Args& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 2 && D == 64) return (int)launch_mma<__nv_bfloat16, 64, Q8>(q, k, v, o, a, s);
  if (dtype == 2 && D == 128) return (int)launch_mma<__nv_bfloat16, 128, Q8>(q, k, v, o, a, s);
  if (dtype == 1 && D == 64) return (int)launch_mma<__half, 64, Q8>(q, k, v, o, a, s);
  if (dtype == 1 && D == 128) return (int)launch_mma<__half, 128, Q8>(q, k, v, o, a, s);
  if (dtype == 0 && D == 64) return (int)launch_f32<64, Q8>(q, k, v, o, a, s);
  if (dtype == 0 && D == 128) return (int)launch_f32<128, Q8>(q, k, v, o, a, s);
  return (int)cudaErrorInvalidValue;
}

Args make_args(const void* table, int C, int H, int KH, int NB, int BS, int MB,
               int start, long long q_c, long long q_h, long long k_n,
               long long k_b, long long k_h, long long v_n, long long v_b,
               long long v_h, long long o_c, long long o_h, float scale) {
  Args a{};
  a.table = static_cast<const int*>(table);
  a.C = C; a.H = H; a.KH = KH; a.NB = NB; a.BS = BS; a.MB = MB; a.start = start;
  a.q_c = q_c; a.q_h = q_h;
  a.k_n = k_n; a.k_b = k_b; a.k_h = k_h;
  a.v_n = v_n; a.v_b = v_b; a.v_h = v_h;
  a.o_c = o_c; a.o_h = o_h;
  a.scale = scale;
  return a;
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16. Strides are in elements, the
// head dim contiguous. q and o [C, H, D]; pools [NB, BS, KH, D] by
// (k_n, k_b, k_h); table [MB] int32 (the slot's block-table row); start is
// the chunk's first absolute position.
extern "C" int dstt_paged_chunk_attention(
    const void* q, const void* k, const void* v, const void* table, void* o,
    int C, int H, int KH, int D, int NB, int BS, int MB, int start,
    long long q_c, long long q_h, long long k_n, long long k_b, long long k_h,
    long long v_n, long long v_b, long long v_h, long long o_c, long long o_h,
    float scale, int dtype, void* stream) {
  if (C <= 0 || H <= 0 || KH <= 0 || H % KH || NB <= 0 || BS <= 0 || MB <= 0 || start < 0)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(table, C, H, KH, NB, BS, MB, start, q_c, q_h, k_n, k_b,
                           k_h, v_n, v_b, v_h, o_c, o_h, scale);
  return dispatch<false>(dtype, D, q, k, v, o, a, stream);
}

// int8 pools: k, v int8 [NB, BS, KH, D]; ks, vs f32 scale tiles [NB, KH, BS]
// by (ks_n, ks_h), the block dim contiguous. dtype is q's and o's.
extern "C" int dstt_paged_chunk_attention_int8(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* table, void* o, int C, int H, int KH, int D,
    int NB, int BS, int MB, int start, long long q_c, long long q_h,
    long long k_n, long long k_b, long long k_h, long long v_n, long long v_b,
    long long v_h, long long ks_n, long long ks_h, long long vs_n,
    long long vs_h, long long o_c, long long o_h, float scale, int dtype,
    void* stream) {
  if (C <= 0 || H <= 0 || KH <= 0 || H % KH || NB <= 0 || BS <= 0 || MB <= 0 || start < 0)
    return (int)cudaErrorInvalidValue;
  Args a = make_args(table, C, H, KH, NB, BS, MB, start, q_c, q_h, k_n, k_b, k_h,
                     v_n, v_b, v_h, o_c, o_h, scale);
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.ks_n = ks_n; a.ks_h = ks_h; a.vs_n = vs_n; a.vs_h = vs_h;
  return dispatch<true>(dtype, D, q, k, v, o, a, stream);
}

extern "C" const char* dstt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
