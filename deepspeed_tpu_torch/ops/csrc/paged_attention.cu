// Paged decode and paged verify attention for Hopper (sm_90a).
//
// Replaces two Pallas kernels of deepspeed_tpu/ops/pallas/decode_attention.py:
//  * `_paged_decode_kernel` (:164, entry `paged_decode_attention` :217):
//    one query token per slot attends that slot's keys through its block
//    table; key position `col` is visible iff col < lengths[s];
//  * `_paged_verify_kernel` (:421, entry `paged_verify_attention` :479):
//    every slot's K candidate tokens at positions lengths[s]..lengths[s]+K-1
//    attend the slot's keys; query k sees col <= lengths[s] + k.
// Each in two variants: full-precision pools (the pool dtype is q's), and
// int8 pools with f32 scale tiles [NB, KH, BS] (the kernels' int8 branch,
// `_deq_tile` :46, which dequantizes each tile in VMEM).
// The pools are [NB, BS, KH, D] (the layer view of the server's
// [L, NB, BS, KH, D] pool, read through its strides) and block-table entry
// j of slot s covers positions j*BS .. (j+1)*BS-1. Scale folded into q in
// f32, all softmax math in f32, output acc / max(l, 1e-30): a slot with no
// visible key gives zeros, as the TPU kernel does.
//
// What bounds them on the H100: bytes. Each visible key row is read once
// per (slot, kv head) and there are only 4 flops per key element and query
// row, so the least time is the live K/V bytes (and scales) over 3.35 TB/s.
// An int8 pool halves the K/V bytes of a bf16 one at D=64 (64 + 4 scale
// bytes against 128 a row and head).
//
// Design: the two share one body, the dense decode kernel
// (decode_attention.cu) with one table lookup per key:
//  * one block of 8 warps per (kv head, slot, group of <= 8 query rows).
//    A (slot, kv head) owns K*R query rows (R = H/KH query heads per kv
//    head, K = 1 for decode); up to 8 of them share one block, so the
//    slot's keys stream once for the whole GQA group (and for the whole
//    verify chunk when K*R <= 8).
//  * the TPU's sequential table-entry grid axis becomes a loop inside the
//    block over positions below the block's largest visible bound: entries
//    past it (dead blocks, the null block) are never read. Lengths and
//    tables are read on the device (no host sync).
//  * each key row is read with vector loads by D/VEC neighbouring lanes
//    after one lookup tables[s][pos / BS] (16 bytes a lane; int8 rows at 8
//    bytes a lane once a block holds more than 2 query rows, which keeps
//    q and the accumulators at 8 floats a row and lane); a warp issues
//    UNROLL steps of loads before it uses any. Every lane group keeps an
//    f32 online softmax per query row; the groups merge by shuffles, the
//    warps through shared memory at the end.
//  * int8: the scales are folded, not applied per element: the score of
//    key j is scale_k[j] * (q . k_int[j]) and the accumulator takes
//    (p_j * scale_v[j]) * v_int[j] while l sums the unscaled p_j — the
//    TPU kernel's function up to the order of f32 sums. One f32 scale per
//    (key, head) is read by the key's lane group.
//  * a table entry is clamped into [0, NB) before use, so a corrupt table
//    cannot read outside the pool.

#include <type_traits>

#include "attention_common.cuh"

namespace {

using namespace dstt;

constexpr int NUM_WARPS = 8;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int UNROLL = 4;

template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };

struct Args {
  const int* tables;   // [S, MB], row stride t_s
  const int* lengths;  // [S]
  const float* ks;     // int8 pools: scale tiles [NB, KH, BS] by (ks_n, ks_h)
  const float* vs;
  int NB, BS, MB;
  int R;               // query heads per kv head
  int nrows;           // query rows per (slot, kv head): K * R
  int extra;           // row j sees col < lengths[s] + extra + j / R
  long long q_s, q_k, q_h, k_n, k_b, k_h, v_n, v_b, v_h, t_s, o_s, o_k, o_h;
  long long ks_n, ks_h, vs_n, vs_h;
  float scale;
};

template <typename T, typename KV, int D, int ROWS>
__global__ void __launch_bounds__(NUM_THREADS)
paged_rows_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                  const KV* __restrict__ vp, T* __restrict__ o, Args a) {
  constexpr bool Q8 = std::is_same<KV, int8_t>::value;
  constexpr int VEC = Q8 ? (ROWS <= 2 ? 16 : 8) : 16 / sizeof(KV);  // per lane
  using KRaw = typename Raw<VEC * sizeof(KV)>::type;
  constexpr int QCH = VEC * sizeof(T) / 16;   // 16-byte loads of q per lane
  constexpr int LPK = D / VEC;          // lanes per key row
  constexpr int KPW = 32 / LPK;         // keys per warp per step
  constexpr int STEP = NUM_WARPS * KPW; // keys per block per step
  static_assert(D % VEC == 0 && 32 % LPK == 0, "unsupported head dim");
  static_assert(QCH >= 1 && QCH * 16 == VEC * sizeof(T), "unsupported q vector");

  __shared__ float sm_m[NUM_WARPS][ROWS];
  __shared__ float sm_l[NUM_WARPS][ROWS];
  __shared__ float sm_acc[NUM_WARPS][ROWS][D];

  const int kh = blockIdx.x, s = blockIdx.y, row0 = blockIdx.z * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LPK, d0 = (lane % LPK) * VEC;
  const int len = a.lengths[s];
  const int span = a.MB * a.BS;
  const int* table = a.tables + s * a.t_s;

  // per-row exclusive bound on visible positions; the loop runs to the
  // largest of them (uniform across the block)
  int lim[ROWS];
  int hi = 0;
  float qv[ROWS][VEC], acc[ROWS][VEC], m[ROWS], l[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int j = row0 + r;
    lim[r] = j < a.nrows ? max(0, min(len + a.extra + j / a.R, span)) : 0;
    hi = max(hi, lim[r]);
    uint4 raw[QCH];
#pragma unroll
    for (int c = 0; c < QCH; ++c) {
      raw[c] = make_uint4(0, 0, 0, 0);
      if (j < a.nrows)
        raw[c] = *reinterpret_cast<const uint4*>(q + s * a.q_s + (j / a.R) * a.q_k + (kh * a.R + j % a.R) * a.q_h + d0 + c * (16 / sizeof(T)));
    }
    const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      qv[r][i] = to_float(e[i]) * a.scale;
      acc[r][i] = 0.f;
    }
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  const KV* kb = kp + kh * a.k_h + d0;
  const KV* vb = vp + kh * a.v_h + d0;
  // the loop bound is uniform across the warp, so the shuffles below always
  // run with all 32 lanes; positions past a row's bound are masked instead
  for (int base = warp * KPW; base < hi; base += STEP * UNROLL) {
    KRaw kr[UNROLL], vr[UNROLL];
    float ksc[UNROLL], vsc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int pos = base + u * STEP + grp;
      kr[u] = vr[u] = KRaw{};
      ksc[u] = vsc[u] = 0.f;
      if (pos < hi) {
        const long long blk = min(max(table[pos / a.BS], 0), a.NB - 1);
        const long long off = pos % a.BS;
        kr[u] = *reinterpret_cast<const KRaw*>(kb + blk * a.k_n + off * a.k_b);
        vr[u] = *reinterpret_cast<const KRaw*>(vb + blk * a.v_n + off * a.v_b);
        if constexpr (Q8) {
          ksc[u] = a.ks[blk * a.ks_n + kh * a.ks_h + off];
          vsc[u] = a.vs[blk * a.vs_n + kh * a.vs_h + off];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float sc[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const KV* ke = reinterpret_cast<const KV*>(&kr[u]);
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) dot = fmaf(qv[r][i], to_float(ke[i]), dot);
#pragma unroll
        for (int off = LPK / 2; off > 0; off /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if constexpr (Q8) dot *= ksc[u];
        sc[u] = base + u * STEP + grp < lim[r] ? dot : -INFINITY;
      }
      float mn = m[r];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) mn = fmaxf(mn, sc[u]);
      const float ref = mn == -INFINITY ? 0.f : mn;
      const float alpha = __expf(m[r] - ref);
      l[r] *= alpha;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[r][i] *= alpha;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float p = __expf(sc[u] - ref);
        const float pv = Q8 ? p * vsc[u] : p;
        const KV* ve = reinterpret_cast<const KV*>(&vr[u]);
        l[r] += p;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[r][i] = fmaf(pv, to_float(ve[i]), acc[r][i]);
      }
      m[r] = mn;
    }
  }

  // merge the lane groups of this warp (lanes that differ by multiples of LPK)
#pragma unroll
  for (int off = LPK; off < 32; off *= 2) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mn = fmaxf(m[r], mo);
      const float ref = mn == -INFINITY ? 0.f : mn;
      const float ca = __expf(m[r] - ref), cb = __expf(mo - ref);
      l[r] = l[r] * ca + lo * cb;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][i], off);
        acc[r][i] = acc[r][i] * ca + ao * cb;
      }
      m[r] = mn;
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (d0 == 0) {
        sm_m[warp][r] = m[r];
        sm_l[warp][r] = l[r];
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) sm_acc[warp][r][d0 + i] = acc[r][i];
    }
  }
  __syncthreads();

  // merge the warps: one thread per (row, column)
  for (int idx = threadIdx.x; idx < ROWS * D; idx += NUM_THREADS) {
    const int r = idx / D, d = idx % D;
    const int j = row0 + r;
    if (j >= a.nrows) continue;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NUM_WARPS; ++w) mx = fmaxf(mx, sm_m[w][r]);
    const float ref = mx == -INFINITY ? 0.f : mx;
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < NUM_WARPS; ++w) {
      const float f = __expf(sm_m[w][r] - ref);
      lt += sm_l[w][r] * f;
      at += sm_acc[w][r][d] * f;
    }
    o[s * a.o_s + (j / a.R) * a.o_k + (kh * a.R + j % a.R) * a.o_h + d] = from_float<T>(at / fmaxf(lt, 1e-30f));
  }
}

template <typename T, typename KV, int D, int ROWS>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int S, int KH, const Args& a, cudaStream_t stream) {
  dim3 grid(KH, S, (a.nrows + ROWS - 1) / ROWS);
  paged_rows_kernel<T, KV, D, ROWS><<<grid, NUM_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<T*>(o), a);
  return cudaGetLastError();
}

// rows per block: the smallest power of two >= K*R, at most 8
template <typename T, typename KV, int D>
cudaError_t launch_rows(const void* q, const void* k, const void* v, void* o,
                        int S, int KH, const Args& a, cudaStream_t stream) {
  if (a.nrows <= 1) return launch<T, KV, D, 1>(q, k, v, o, S, KH, a, stream);
  if (a.nrows <= 2) return launch<T, KV, D, 2>(q, k, v, o, S, KH, a, stream);
  if (a.nrows <= 4) return launch<T, KV, D, 4>(q, k, v, o, S, KH, a, stream);
  return launch<T, KV, D, 8>(q, k, v, o, S, KH, a, stream);
}

template <typename T, typename KV>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* o, int S, int KH, const Args& a,
                     cudaStream_t stream) {
  if (D == 64) return launch_rows<T, KV, 64>(q, k, v, o, S, KH, a, stream);
  if (D == 128) return launch_rows<T, KV, 128>(q, k, v, o, S, KH, a, stream);
  return cudaErrorInvalidValue;
}

// Q8: int8 pools (with a.ks / a.vs); else the pools have q's dtype
template <bool Q8>
int dispatch(int dtype, int D, const void* q, const void* k, const void* v,
             void* o, int S, int KH, const Args& a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_d<float, std::conditional_t<Q8, int8_t, float>>(D, q, k, v, o, S, KH, a, st);
    case 1: return (int)launch_d<__half, std::conditional_t<Q8, int8_t, __half>>(D, q, k, v, o, S, KH, a, st);
    case 2: return (int)launch_d<__nv_bfloat16, std::conditional_t<Q8, int8_t, __nv_bfloat16>>(D, q, k, v, o, S, KH, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

Args make_args(const void* tables, const void* lengths, int NB, int BS,
               int MB, int R, int nrows, int extra, long long q_s,
               long long q_k, long long q_h, long long k_n, long long k_b,
               long long k_h, long long v_n, long long v_b, long long v_h,
               long long t_s, long long o_s, long long o_k, long long o_h,
               float scale) {
  Args a{};
  a.tables = static_cast<const int*>(tables);
  a.lengths = static_cast<const int*>(lengths);
  a.NB = NB; a.BS = BS; a.MB = MB; a.R = R; a.nrows = nrows; a.extra = extra;
  a.q_s = q_s; a.q_k = q_k; a.q_h = q_h;
  a.k_n = k_n; a.k_b = k_b; a.k_h = k_h;
  a.v_n = v_n; a.v_b = v_b; a.v_h = v_h;
  a.t_s = t_s; a.o_s = o_s; a.o_k = o_k; a.o_h = o_h;
  a.scale = scale;
  return a;
}

void set_scales(Args& a, const void* ks, const void* vs, long long ks_n,
                long long ks_h, long long vs_n, long long vs_h) {
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.ks_n = ks_n; a.ks_h = ks_h; a.vs_n = vs_n; a.vs_h = vs_h;
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16. Strides are in elements, the
// head dim contiguous. q and o [S, H, D]; pools [NB, BS, KH, D] by
// (k_n, k_b, k_h); tables [S, MB] int32 with row stride t_s; lengths [S]
// int32; all on the device.
extern "C" int dstt_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* tables,
    const void* lengths, void* o, int S, int H, int KH, int D, int NB, int BS,
    int MB, long long q_s, long long q_h, long long k_n, long long k_b,
    long long k_h, long long v_n, long long v_b, long long v_h, long long t_s,
    long long o_s, long long o_h, float scale, int dtype, void* stream) {
  if (S <= 0 || KH <= 0 || H % KH || NB <= 0 || BS <= 0 || MB <= 0) return (int)cudaErrorInvalidValue;
  const Args a = make_args(tables, lengths, NB, BS, MB, H / KH, H / KH, 0, q_s, 0, q_h,
                           k_n, k_b, k_h, v_n, v_b, v_h, t_s, o_s, 0, o_h, scale);
  return dispatch<false>(dtype, D, q, k, v, o, S, KH, a, stream);
}

// As above with q and o [S, K, H, D] by (q_s, q_k, q_h) and (o_s, o_k, o_h).
extern "C" int dstt_paged_verify_attention(
    const void* q, const void* k, const void* v, const void* tables,
    const void* lengths, void* o, int S, int K, int H, int KH, int D, int NB,
    int BS, int MB, long long q_s, long long q_k, long long q_h, long long k_n,
    long long k_b, long long k_h, long long v_n, long long v_b, long long v_h,
    long long t_s, long long o_s, long long o_k, long long o_h, float scale,
    int dtype, void* stream) {
  if (S <= 0 || K <= 0 || KH <= 0 || H % KH || NB <= 0 || BS <= 0 || MB <= 0) return (int)cudaErrorInvalidValue;
  const Args a = make_args(tables, lengths, NB, BS, MB, H / KH, K * (H / KH), 1, q_s, q_k, q_h,
                           k_n, k_b, k_h, v_n, v_b, v_h, t_s, o_s, o_k, o_h, scale);
  return dispatch<false>(dtype, D, q, k, v, o, S, KH, a, stream);
}

// int8 pools: k, v int8 [NB, BS, KH, D]; ks, vs f32 scale tiles [NB, KH, BS]
// by (ks_n, ks_h), the block dim contiguous. dtype is q's and o's.
extern "C" int dstt_paged_decode_attention_int8(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* tables, const void* lengths, void* o, int S,
    int H, int KH, int D, int NB, int BS, int MB, long long q_s, long long q_h,
    long long k_n, long long k_b, long long k_h, long long v_n, long long v_b,
    long long v_h, long long ks_n, long long ks_h, long long vs_n,
    long long vs_h, long long t_s, long long o_s, long long o_h, float scale,
    int dtype, void* stream) {
  if (S <= 0 || KH <= 0 || H % KH || NB <= 0 || BS <= 0 || MB <= 0) return (int)cudaErrorInvalidValue;
  Args a = make_args(tables, lengths, NB, BS, MB, H / KH, H / KH, 0, q_s, 0, q_h,
                     k_n, k_b, k_h, v_n, v_b, v_h, t_s, o_s, 0, o_h, scale);
  set_scales(a, ks, vs, ks_n, ks_h, vs_n, vs_h);
  return dispatch<true>(dtype, D, q, k, v, o, S, KH, a, stream);
}

extern "C" int dstt_paged_verify_attention_int8(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* tables, const void* lengths, void* o, int S,
    int K, int H, int KH, int D, int NB, int BS, int MB, long long q_s,
    long long q_k, long long q_h, long long k_n, long long k_b, long long k_h,
    long long v_n, long long v_b, long long v_h, long long ks_n,
    long long ks_h, long long vs_n, long long vs_h, long long t_s,
    long long o_s, long long o_k, long long o_h, float scale, int dtype,
    void* stream) {
  if (S <= 0 || K <= 0 || KH <= 0 || H % KH || NB <= 0 || BS <= 0 || MB <= 0) return (int)cudaErrorInvalidValue;
  Args a = make_args(tables, lengths, NB, BS, MB, H / KH, K * (H / KH), 1, q_s, q_k, q_h,
                     k_n, k_b, k_h, v_n, v_b, v_h, t_s, o_s, o_k, o_h, scale);
  set_scales(a, ks, vs, ks_n, ks_h, vs_n, vs_h);
  return dispatch<true>(dtype, D, q, k, v, o, S, KH, a, stream);
}

extern "C" const char* dstt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
