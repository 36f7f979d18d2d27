// Tiles of 64 keys of a paged K/V pool in shared memory and the mma.sync
// m16n8k16 fragments built from them, shared by the paged verify kernel
// (paged_attention.cu) and the paged chunk kernel (paged_chunk_attention.cu).
// Header only; the builder hashes it with every source.
//
// A tile holds 64 key rows of one kv head, copied from the pool
// [NB, BS, KH, Dv] row by row through the block table with 16-byte cp.async
// (a row of a 64-key tile may lie in any page, so any BS works). D is the
// kernel width (64, 128 or 256); the chunks of a row past the true head dim
// Dv are zero-filled, not read, so they add nothing to q.k or P.V.
//  * 16-bit pools (q's dtype): rows of D + 8 elements (the padding keeps
//    ldmatrix conflict-free); fragments by ldmatrix.
//  * int8 pools: rows of D bytes, their 16-byte chunks XOR-swizzled
//    (chunk c of row r at c ^ swz(r)), and the key rows of an n8 tile
//    permuted (logical key n in row pk(n)); with both, every fragment load
//    below is free of bank conflicts (a search over all thread patterns).
//    The int8 values are widened to q's dtype in registers as each
//    fragment is built (exact: |x| <= 127 has at most 7 significant
//    bits), never in a shared-memory pass. The head dim is consumed in a
//    permuted order that both operands share (a sum over it does not care):
//    thread t4's 16-byte chunk 4i + t4 of a K row holds k-steps 4i..4i+3,
//    four dims each, as the fragment's k = {2t4, 2t4+1, 2t4+8, 2t4+9}; and
//    the n8 output tiles of P.V take dims P*n + j (P = D / 8) so that a V
//    row's chunk serves every tile at once.
//    Each tile carries its 64 f32 scales of K and of V after its rows.
// The A fragments of q come from the caller (`qk_rows16`'s `qa`): from
// registers at D = 64 and 128, and at D = 256, where a warp's q fragments
// (64 registers) beside its 16 x 256 f32 accumulator (128) would spill,
// from a q tile in shared memory (`QTile`) by ldmatrix.
#pragma once

#include <type_traits>

#include "attention_common.cuh"

namespace dstt {

constexpr int TILE_KEYS = 64;

template <typename KV, int D>
struct KVTile {
  static constexpr bool Q8 = std::is_same<KV, int8_t>::value;
  static constexpr int ROW = Q8 ? D : (D + 8) * (int)sizeof(KV);   // bytes a key row
  static constexpr int CH = D * (int)sizeof(KV) / 16;              // 16-byte chunks a row
  static constexpr int E = 16 / (int)sizeof(KV);                   // elements a chunk
  static constexpr int BYTES = TILE_KEYS * ROW;                    // rows of one tile
  // a stage: the K tile, the V tile, and for int8 the K and V scales
  static constexpr int STAGE = 2 * BYTES + (Q8 ? 2 * TILE_KEYS * 4 : 0);
  static_assert(CH >= 4 && CH % 4 == 0, "head dim 64, 128 or 256");

  __device__ static __forceinline__ int swz(int r) {
    return Q8 ? (((r & 1) << 2) ^ (((r >> 2) & 1) << 1)) : 0;
  }
  __device__ static __forceinline__ int pk(int n) { return Q8 ? n ^ ((n >> 1) & 1) : n; }
  // byte offset of chunk c of row r
  __device__ static __forceinline__ int off(int r, int c) {
    return r * ROW + ((c ^ swz(r)) & (CH - 1)) * 16;
  }
  // the output dim of element e (0, 1) of n8 tile j of P.V for thread t4
  __device__ static __forceinline__ int dim(int j, int e, int t4) {
    return Q8 ? (D / 8) * (2 * t4 + e) + j : 8 * j + 2 * t4 + e;
  }
  // the q dims of fragment registers a0 (lo) and a2 (hi) of k-step kk
  __device__ static __forceinline__ int qdim(int kk, int t4, int hi) {
    return Q8 ? ((kk / 4) * 4 + t4) * 16 + (kk % 4) * 4 + 2 * hi
              : kk * 16 + 2 * t4 + 8 * hi;
  }
};

// ---------------------------------------------------------- int8 widening
// x holds four int8 values XOR 0x80 (b + 128, unsigned). bf16: the byte in
// the mantissa of 2^23 gives 2^23 + b + 128 as f32, minus 2^23 + 128 is b
// exactly, and the upper half of that f32 is the exact bf16. fp16: the
// byte under 0x64 gives 1024 + b + 128, minus 1152.
__device__ __forceinline__ float biased_byte(uint32_t x, int j) {
  return __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650 + j)) - 8388736.f;
}

// byte ja of xa (lo) and byte jb of xb (hi) as two values of T
template <typename T>
__device__ __forceinline__ uint32_t widen2(uint32_t xa, int ja, uint32_t xb, int jb) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __byte_perm(__float_as_uint(biased_byte(xa, ja)),
                       __float_as_uint(biased_byte(xb, jb)), 0x7632);
  } else {
    // selector nibble 2 (bits 8..11) picks result byte 2: byte jb of xb
    const uint32_t t = (__byte_perm(xa, xb, ja | ((4 + jb) << 8)) & 0x00FF00FFu) | 0x64006400u;
    const __half2 h = __hsub2(*reinterpret_cast<const __half2*>(&t),
                              __halves2half2(__ushort_as_half(0x6480), __ushort_as_half(0x6480)));
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}

// ------------------------------------------------------------- the copies

// cp.async of tile rows [0, 64) of one stage by THREADS threads (tid: this
// thread's index among them): row r is pool position p0 + r, valid below
// `end` (else zero-filled), its block id from blk[i] for this thread's
// copy i (tile row row(i, tid)); with PARTIAL, a chunk past the head dim
// dv is zero-filled (without, every chunk is copied and dv is not read).
// K and V share the ids; kb, vb (and ks, vs) point at the kv head already.
template <typename KV, int D, int THREADS>
struct TileCopy {
  using TL = KVTile<KV, D>;
  static constexpr int N = TILE_KEYS * TL::CH;            // 16-byte copies a tile
  static constexpr int CPT = (N + THREADS - 1) / THREADS;  // a thread, at most
  static_assert(N % THREADS == 0 || THREADS % N == 0, "whole copies");
  // the tile row of this thread's copy i
  __device__ static __forceinline__ int row(int i, int tid) { return (tid + i * THREADS) / TL::CH; }
  template <bool PARTIAL>
  __device__ static __forceinline__ void issue(unsigned char* stage, const KV* kb, const KV* vb,
                                               const int (&blk)[CPT], int p0, int end, int BS,
                                               long long k_n, long long k_b, long long v_n,
                                               long long v_b, int dv, int tid) {
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int cc = tid + i * THREADS;
      if (N < THREADS && cc >= N) break;
      const int r = cc / TL::CH, c = cc % TL::CH;
      const int pos = p0 + r;
      const bool ok = pos < end && (!PARTIAL || c * TL::E < dv);
      const long long o = ok ? pos % BS : 0;
      // a copy that reads nothing still takes an address inside the pool
      const int e = PARTIAL && !ok ? 0 : c * TL::E;
      cp_async16(stage + TL::off(r, c), kb + blk[i] * k_n + o * k_b + e, ok);
      cp_async16(stage + TL::BYTES + TL::off(r, c), vb + blk[i] * v_n + o * v_b + e, ok);
    }
  }
  // int8 pools: the scales of the stage's rows (threads 0..63 K, 64..127 V;
  // sblk: the block id of row tid % 64)
  __device__ static __forceinline__ void issue_scales(unsigned char* stage, const float* ks,
                                                      const float* vs, int sblk, int p0, int end,
                                                      int BS, long long ks_n, long long vs_n,
                                                      int tid) {
    if (tid < 2 * TILE_KEYS) {
      const int r = tid % TILE_KEYS;
      const bool v = tid >= TILE_KEYS;
      const int pos = p0 + r;
      const bool ok = pos < end;
      const long long o = ok ? pos % BS : 0;
      float* dst = reinterpret_cast<float*>(stage + 2 * TL::BYTES) + tid;
      cp_async4(dst, v ? vs + sblk * vs_n + o : ks + sblk * ks_n + o, ok);
    }
  }
};

// wait until at most n (0..3) of this thread's cp.async groups are pending
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// ------------------------------------------------------------ the products

// A q tile of ROWS rows in shared memory for ldmatrix: rows of D + 8 values
// of T (the padding keeps ldmatrix conflict-free), each row's values in
// fragment order: position 16 kk + 2 t4 + 8 h (+1) holds q's dims qdim(kk,
// t4, h) (+1), so a plain ldmatrix_x4 gives the fragments the K tile's
// layout wants (the identity for 16-bit pools).
template <typename T, typename KV, int D, int ROWS>
struct QTile {
  static constexpr int ROW = D + 8;                          // values a row
  static constexpr int BYTES = ROWS * ROW * (int)sizeof(T);
  // the q dim that position c (even) of a row holds
  __device__ static __forceinline__ int dim_at(int c) {
    return KVTile<KV, D>::qdim(c / 16, (c % 8) / 2, (c % 16) / 8);
  }
  // the A fragment of k-step kk of tile rows r0..r0+15
  __device__ static __forceinline__ void frag(uint32_t (&a)[4], const T* qs, int r0, int kk,
                                              int lane) {
    ldmatrix_x4(a, qs + (r0 + ((lane / 8) % 2) * 8 + lane % 8) * ROW + kk * 16 + (lane / 16) * 8);
  }
};

// S (16 x 16, f32: two n8 tiles) += Q (16 rows) . K^T over tile rows
// r0..r0+15 (r0 a multiple of 16), every k-step; qa(kk, a) gives the A
// fragment of k-step kk
template <typename T, typename KV, int D, typename QA>
__device__ __forceinline__ void qk_rows16(float (&s)[2][4], QA&& qa, const unsigned char* kt,
                                          int r0, int lane) {
  using TL = KVTile<KV, D>;
  const int g = lane / 4, t4 = lane % 4;
  if constexpr (TL::Q8) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int i = 0; i < TL::CH / 4; ++i) {
        const uint4 w = *reinterpret_cast<const uint4*>(kt + TL::off(r0 + 8 * t + TL::pk(g), 4 * i + t4));
        const uint32_t x[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u, w.z ^ 0x80808080u,
                               w.w ^ 0x80808080u};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const uint32_t b[2] = {widen2<T>(x[h], 0, x[h], 1), widen2<T>(x[h], 2, x[h], 3)};
          uint32_t a[4];
          qa(4 * i + h, a);
          mma16816<T>(s[t], a, b);
        }
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b[4];
      ldmatrix_x4(b, reinterpret_cast<const T*>(kt) +
                         (r0 + (lane / 16) * 8 + (lane % 8)) * (D + 8) + kk * 16 +
                         ((lane / 8) % 2) * 8);
      uint32_t a[4];
      qa(kk, a);
      mma16816<T>(s[0], a, b);
      mma16816<T>(s[1], a, b + 2);
    }
  }
}

// O (16 x D) += P (16 rows x tile rows r0..r0+15) . V, P given as the sum
// of NP fragments (a 16-bit value and its remainders: NP = 3 carries an
// f32 P through bf16 products without loss)
template <typename T, typename KV, int D, int NP>
__device__ __forceinline__ void pv_step(float (&acc)[D / 8][4], const uint32_t (&pf)[NP][4],
                                        const unsigned char* vt, int r0, int lane) {
  using TL = KVTile<KV, D>;
  const int g = lane / 4, t4 = lane % 4;
  if constexpr (TL::Q8) {
    // rows of keys 2t4, 2t4+1 (b0) and 8 + the same (b1); each row's
    // D/8 bytes at dims (D/8) * g .. serve every n8 tile j
    constexpr int W = D / 32;   // words a row
    uint32_t x[4][W];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = r0 + (k / 2) * 8 + TL::pk(2 * t4 + k % 2);
      if constexpr (W == 2) {
        const uint2 w = *reinterpret_cast<const uint2*>(vt + TL::off(r, g >> 1) + (g & 1) * 8);
        x[k][0] = w.x ^ 0x80808080u;
        x[k][1] = w.y ^ 0x80808080u;
      } else {
        // chunks (W / 4) g .. of the row: one at D = 128, two at 256
#pragma unroll
        for (int c = 0; c < W / 4; ++c) {
          const uint4 w = *reinterpret_cast<const uint4*>(vt + TL::off(r, (W / 4) * g + c));
          x[k][4 * c] = w.x ^ 0x80808080u;
          x[k][4 * c + 1] = w.y ^ 0x80808080u;
          x[k][4 * c + 2] = w.z ^ 0x80808080u;
          x[k][4 * c + 3] = w.w ^ 0x80808080u;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const uint32_t b[2] = {widen2<T>(x[0][j / 4], j % 4, x[1][j / 4], j % 4),
                             widen2<T>(x[2][j / 4], j % 4, x[3][j / 4], j % 4)};
#pragma unroll
      for (int n = 0; n < NP; ++n) mma16816<T>(acc[j], pf[n], b);
    }
  } else {
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, reinterpret_cast<const T*>(vt) +
                               (r0 + ((lane / 8) % 2) * 8 + (lane % 8)) * (D + 8) + dp * 16 +
                               (lane / 16) * 8);
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        mma16816<T>(acc[2 * dp], pf[n], b);
        mma16816<T>(acc[2 * dp + 1], pf[n], b + 2);
      }
    }
  }
}

// P's A fragment registers (rows g, g+8 of two n8 tiles of S, as pe[t][e])
// as NP terms of T: term 0 is P rounded, each next one the remainder of the
// ones before it rounded
template <typename T, int NP>
__device__ __forceinline__ void p_frags(uint32_t (&pf)[NP][4], const float (&pe)[2][4]) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    float rem[4] = {pe[t][0], pe[t][1], pe[t][2], pe[t][3]};
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = to_float(from_float<T>(rem[e]));
        rem[e] -= v[e];
      }
      pf[n][2 * t] = pack2<T>(v[0], v[1]);
      pf[n][2 * t + 1] = pack2<T>(v[2], v[3]);
    }
  }
}

// The key row (tile row) of element e of n8 tile t of S for thread t4: the
// scale to apply and the position to mask
template <typename KV, int D>
__device__ __forceinline__ int s_row(int t, int e, int t4) {
  return 8 * t + KVTile<KV, D>::pk(2 * t4 + (e & 1));
}

// ------------------------------------------------------------------- host

// allow KERNEL `bytes` of dynamic shared memory, once per device
template <auto KERNEL>
inline cudaError_t allow_smem(int bytes) {
  static int allowed[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && allowed[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < 64) allowed[dev] = bytes;
  return e;
}

}  // namespace dstt
