// Block-sparse attention for Hopper (sm_90a): kernel B8.
//
// Replaces the Pallas kernel `_kernel`
// (deepspeed_tpu/ops/pallas/block_sparse_attention.py:44, entry
// `block_sparse_attention` :91): for each (batch row, head, query block) an
// online softmax over only the key blocks that the block's LUT row lists,
// lut[h, qb, 0 .. counts[h, qb]), with an optional causal mask. Numerics
// follow the TPU kernel: S = dot(q, k) in f32, then times the scale (not
// folded into q); masked scores drop out; m, l and the accumulator are f32;
// P is rounded to the storage dtype before P.V; a row that sees no key
// (count 0, or every listed block causally masked) writes exactly 0.
//
// What bounds it on the H100: at the GPT-2 1.3B head geometry (16 heads of
// 128, bf16) with a Fixed layout of blocks of 64 at T = 4096, the
// 4.B.D.block^2 operations of the listed blocks and the bytes of q, k, v and
// o take a least time of the same order (989 TFLOP/s, 3.35 TB/s); every K/V
// block is read by several query blocks, so its bytes come from L2 after
// the first read.
//
// Design (a first, simple kernel; wgmma and TMA are later work):
//  * one block of BLOCK/16 warps per (query block, head, batch row); each
//    warp owns 16 query rows. It walks its LUT row and loads only the
//    listed K/V blocks, with cp.async, two buffers deep: the next listed
//    block loads while this one is multiplied. The TPU kernel instead pulls
//    the whole [T, D] K and V of the head into VMEM per program; that is
//    not carried over. Entries past the count are padding and are never
//    read; under the causal mask, listed blocks above the diagonal are
//    skipped without a load (they would add nothing).
//  * S = Q.K^T and O += P.V run on the tensor cores with mma.sync.m16n8k16
//    (bf16 or fp16 in, f32 out), as in flash_attention_fwd.cu: the S
//    accumulator's register layout is the A-operand layout of P.V, so P
//    never leaves registers. A block of 128 keys is taken as two sub-tiles
//    of 64, each with its own online-softmax step, to keep S in registers.
//  * Only the diagonal block of a causal row pays for the mask; a warp
//    skips a diagonal sub-tile that lies wholly above its rows.
//  * q, k, v and o are read and written through their (batch, head, time)
//    strides, so [B, T, H, D] views of a fused QKV projection need no
//    transpose copy.
//  * float32 inputs take a plain FMA kernel: one warp per query row.
//
// C interface (nvcc -shared, loaded with ctypes): the launch returns
// cudaGetLastError() so the Python wrapper can raise.

#include "attention_common.cuh"

namespace {

using namespace dstt;

struct Strides {
  long long q_b, q_h, q_t, k_b, k_h, k_t, v_b, v_h, v_t, o_b, o_h, o_t;
};

// next listed entry at or after j that the kernel must visit: inside the
// LUT row, a valid block index, and (causal) not above the diagonal
__device__ __forceinline__ int next_entry(const int* lrow, int j, int count,
                                          int nb, int qb, int causal) {
  for (; j < count; ++j) {
    const int kb = __ldg(lrow + j);
    if (kb >= 0 && kb < nb && !(causal && kb > qb)) break;
  }
  return j;
}

template <typename T, int D, int BLOCK>
__global__ void __launch_bounds__(BLOCK * 2)
bsa_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               const int* __restrict__ lut, const int* __restrict__ counts,
               int nb, int max_active, Strides st, float scale, int causal) {
  constexpr int NUM_THREADS = BLOCK * 2;   // BLOCK / 16 warps
  constexpr int KN = BLOCK < 64 ? BLOCK : 64;   // keys per softmax step
  constexpr int LD = D + 8;                // padded shared row, in elements
  constexpr int VEC = 8;                   // elements per 16-byte chunk
  constexpr int CHUNKS = D / VEC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);   // [BLOCK][LD]
  T* sK = sQ + BLOCK * LD;                  // [2][BLOCK][LD]
  T* sV = sK + 2 * BLOCK * LD;              // [2][BLOCK][LD]

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* qp = q + b * st.q_b + h * st.q_h + (long long)qb * BLOCK * st.q_t;
  const T* kbase = k + b * st.k_b + h * st.k_h;
  const T* vbase = v + b * st.v_b + h * st.v_h;
  const int* lrow = lut + ((long long)h * nb + qb) * max_active;
  const int count = min(__ldg(counts + (long long)h * nb + qb), max_active);

  auto load_kv = [&](int kb, int buf) {
    T* dK = sK + buf * BLOCK * LD;
    T* dV = sV + buf * BLOCK * LD;
    const T* ks = kbase + (long long)kb * BLOCK * st.k_t;
    const T* vs = vbase + (long long)kb * BLOCK * st.v_t;
    for (int c = tid; c < BLOCK * CHUNKS; c += NUM_THREADS) {
      const int r = c / CHUNKS, col = (c % CHUNKS) * VEC;
      cp_async16(dK + r * LD + col, ks + (long long)r * st.k_t + col, true);
      cp_async16(dV + r * LD + col, vs + (long long)r * st.v_t + col, true);
    }
    cp_async_commit();
  };

  int j = next_entry(lrow, 0, count, nb, qb, causal);
  if (j < count) load_kv(__ldg(lrow + j), 0);

  for (int c = tid; c < BLOCK * CHUNKS; c += NUM_THREADS) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * VEC;
    *reinterpret_cast<uint4*>(sQ + r * LD + col) =
        *reinterpret_cast<const uint4*>(qp + (long long)r * st.q_t + col);
  }
  __syncthreads();

  const int wr = warp * 16;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], sQ + (wr + (lane % 8) + ((lane / 8) % 2) * 8) * LD + kk * 16 + (lane / 16) * 8);

  const int g = lane / 4, t4 = lane % 4;
  const int row_a = wr + g, row_b = row_a + 8;   // rows within the block
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};   // per-thread partial row sums, reduced at the end
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  int buf = 0;
  while (j < count) {
    const int kb = __ldg(lrow + j);
    const int jn = next_entry(lrow, j + 1, count, nb, qb, causal);
    if (jn < count) {
      load_kv(__ldg(lrow + jn), buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* cK = sK + buf * BLOCK * LD;
    const T* cV = sV + buf * BLOCK * LD;
    const bool diag = causal && kb == qb;

#pragma unroll
    for (int n0 = 0; n0 < BLOCK; n0 += KN) {
      if (diag && n0 > wr + 15) continue;   // wholly above this warp's rows

      // S = Q . K^T over KN keys, 16 x KN per warp, then times the scale
      float s[KN / 8][4];
#pragma unroll
      for (int i = 0; i < KN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < KN / 16; ++np) {
          uint32_t bf[4];
          ldmatrix_x4(bf, cK + (n0 + np * 16 + (lane / 16) * 8 + (lane % 8)) * LD + kk * 16 + ((lane / 8) % 2) * 8);
          mma16816<T>(s[2 * np], qf[kk], bf);
          mma16816<T>(s[2 * np + 1], qf[kk], bf + 2);
        }
      }
#pragma unroll
      for (int nt = 0; nt < KN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] *= scale;
          // the diagonal block: key kb*BLOCK+col against query qb*BLOCK+row
          if (diag && n0 + nt * 8 + 2 * t4 + (e & 1) > (e < 2 ? row_a : row_b)) s[nt][e] = -INFINITY;
        }
      }

      // online softmax: new running max, rescale factor, P in registers
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int nt = 0; nt < KN / 8; ++nt) {
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
      uint32_t pf[KN / 16][4];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < KN / 8; ++nt) {
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
      for (int kk = 0; kk < KN / 16; ++kk) {
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, cV + (n0 + kk * 16 + ((lane / 8) % 2) * 8 + (lane % 8)) * LD + dp * 16 + (lane / 16) * 8);
          mma16816<T>(acc[2 * dp], pf[kk], bf);
          mma16816<T>(acc[2 * dp + 1], pf[kk], bf + 2);
        }
      }
    }
    __syncthreads();   // this buffer is refilled by the next prefetch
    j = jn;
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
  // a row whose running max never rose above -inf saw no key: exactly 0
  const float inv_a = m_r[0] == -INFINITY ? 0.f : 1.f / l_r[0];
  const float inv_b = m_r[1] == -INFINITY ? 0.f : 1.f / l_r[1];
  T* ob = o + b * st.o_b + h * st.o_h + (long long)qb * BLOCK * st.o_t;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int d = i * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(ob + (long long)row_a * st.o_t + d) =
        pack2<T>(acc[i][0] * inv_a, acc[i][1] * inv_a);
    *reinterpret_cast<uint32_t*>(ob + (long long)row_b * st.o_t + d) =
        pack2<T>(acc[i][2] * inv_b, acc[i][3] * inv_b);
  }
}

constexpr int F32_WARPS = 4;

// float32: one warp per query row, each lane holding D/32 columns
template <int D>
__global__ void __launch_bounds__(F32_WARPS * 32)
bsa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               const int* __restrict__ lut, const int* __restrict__ counts,
               int nb, int max_active, int block, Strides st, float scale,
               int causal) {
  constexpr int E = D / 32;
  const int row = blockIdx.x * F32_WARPS + threadIdx.x / 32;   // < T: T % 4 == 0
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int qb = row / block;
  const int* lrow = lut + ((long long)h * nb + qb) * max_active;
  const int count = min(__ldg(counts + (long long)h * nb + qb), max_active);
  const float* qr = q + b * st.q_b + h * st.q_h + (long long)row * st.q_t;
  const float* kb_ = k + b * st.k_b + h * st.k_h;
  const float* vb_ = v + b * st.v_b + h * st.v_h;
  float qv[E], acc[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    qv[i] = qr[lane + 32 * i];
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int j = next_entry(lrow, 0, count, nb, qb, causal); j < count;
       j = next_entry(lrow, j + 1, count, nb, qb, causal)) {
    const int kb = __ldg(lrow + j);
    const int n_keys = (causal && kb == qb) ? row - qb * block + 1 : block;
    for (int c = 0; c < n_keys; ++c) {
      const long long key = (long long)kb * block + c;
      const float* kr = kb_ + key * st.k_t;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < E; ++i) s = fmaf(qv[i], kr[lane + 32 * i], s);
#pragma unroll
      for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
      s *= scale;
      const float mn = fmaxf(m, s);
      const float alpha = expf(m - mn), p = expf(s - mn);
      l = l * alpha + p;
      const float* vr = vb_ + key * st.v_t;
#pragma unroll
      for (int i = 0; i < E; ++i) acc[i] = fmaf(p, vr[lane + 32 * i], acc[i] * alpha);
      m = mn;
    }
  }
  const float inv = m == -INFINITY ? 0.f : 1.f / l;
  float* orow = o + b * st.o_b + h * st.o_h + (long long)row * st.o_t;
#pragma unroll
  for (int i = 0; i < E; ++i) orow[lane + 32 * i] = acc[i] * inv;
}

template <typename T, int D, int BLOCK>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       const int* lut, const int* counts, int B, int H, int nb,
                       int max_active, const Strides& st, float scale,
                       int causal, cudaStream_t stream) {
  const size_t smem = (size_t)5 * BLOCK * (D + 8) * sizeof(T);   // Q + 2 x (K, V)
  // per device, so it is set on every launch (a host-side call, no sync)
  cudaError_t e = cudaFuncSetAttribute(bsa_mma_kernel<T, D, BLOCK>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(nb, H, B);
  bsa_mma_kernel<T, D, BLOCK><<<grid, BLOCK * 2, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lut, counts, nb, max_active, st, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_block(int block, const void* q, const void* k, const void* v,
                         void* o, const int* lut, const int* counts, int B,
                         int H, int nb, int max_active, const Strides& st,
                         float scale, int causal, cudaStream_t s) {
  switch (block) {
    case 16: return launch_mma<T, D, 16>(q, k, v, o, lut, counts, B, H, nb, max_active, st, scale, causal, s);
    case 32: return launch_mma<T, D, 32>(q, k, v, o, lut, counts, B, H, nb, max_active, st, scale, causal, s);
    case 64: return launch_mma<T, D, 64>(q, k, v, o, lut, counts, B, H, nb, max_active, st, scale, causal, s);
    case 128: return launch_mma<T, D, 128>(q, k, v, o, lut, counts, B, H, nb, max_active, st, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int D>
cudaError_t launch_f32(int block, const void* q, const void* k, const void* v,
                       void* o, const int* lut, const int* counts, int B,
                       int H, int nb, int max_active, const Strides& st,
                       float scale, int causal, cudaStream_t s) {
  dim3 grid(nb * block / F32_WARPS, H, B);
  bsa_f32_kernel<D><<<grid, F32_WARPS * 32, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lut, counts, nb,
      max_active, block, st, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: [B, H, T, D] through (batch, head, time) strides in elements,
// head dim contiguous. lut [H, nb, max_active] and counts [H, nb] int32,
// contiguous. dtype: 0 float32, 1 float16, 2 bfloat16. block in
// {16, 32, 64, 128}, T = nb * block, D in {64, 128}.
extern "C" int dstt_block_sparse_attention(
    const void* q, const void* k, const void* v, void* o, const void* lut,
    const void* counts, int B, int H, int T_len, int D, int block,
    int max_active, long long q_b, long long q_h, long long q_t, long long k_b,
    long long k_h, long long k_t, long long v_b, long long v_h, long long v_t,
    long long o_b, long long o_h, long long o_t, float scale, int causal,
    int dtype, void* stream) {
  const Strides st{q_b, q_h, q_t, k_b, k_h, k_t, v_b, v_h, v_t, o_b, o_h, o_t};
  const int* l = static_cast<const int*>(lut);
  const int* c = static_cast<const int*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || block <= 0 || T_len <= 0 || T_len % block || max_active <= 0)
    return (int)cudaErrorInvalidValue;
  const int nb = T_len / block;
  if (dtype == 2 && D == 64) return (int)launch_block<__nv_bfloat16, 64>(block, q, k, v, o, l, c, B, H, nb, max_active, st, scale, causal, s);
  if (dtype == 2 && D == 128) return (int)launch_block<__nv_bfloat16, 128>(block, q, k, v, o, l, c, B, H, nb, max_active, st, scale, causal, s);
  if (dtype == 1 && D == 64) return (int)launch_block<__half, 64>(block, q, k, v, o, l, c, B, H, nb, max_active, st, scale, causal, s);
  if (dtype == 1 && D == 128) return (int)launch_block<__half, 128>(block, q, k, v, o, l, c, B, H, nb, max_active, st, scale, causal, s);
  if (block != 16 && block != 32 && block != 64 && block != 128) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 64) return (int)launch_f32<64>(block, q, k, v, o, l, c, B, H, nb, max_active, st, scale, causal, s);
  if (dtype == 0 && D == 128) return (int)launch_f32<128>(block, q, k, v, o, l, c, B, H, nb, max_active, st, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dstt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
