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
// and the accumulator), output acc / max(l, 1e-30). On the tensor cores
// q.scale and P are rounded to the storage dtype before their products, as
// in the flash kernel.
//
// What bounds it on the H100: at the main path's shape (C = 256, D = 64, up
// to 768 keys) the least time is ~1.5 us of bytes, far below a launch's
// fixed cost, so the kernel is bound by latency: the first K/V tile's
// arrival, then each 64-key tile's products in series (~1.3 us a tile for
// 4 warps on an H100 SM). Its design (`paged_chunk_mma_kernel`, 16-bit
// queries):
//  * one block per (64-row q tile, kv head). The rows of a kv head are its
//    R query heads stacked as (position c, head r), row c*R + r, as the
//    Pallas kernel's (KH, C*R, D) block: a K/V tile is read once per kv
//    head, not once per q head.
//  * two warp groups of 4 warps, each warp owning 16 rows; group g takes
//    the tile's 64-key stages g, g + 2, ..., copies them itself and waits
//    at its own named barrier, so the groups run apart and a q tile's
//    chain of tiles is half as long; group 1's partial merges into group
//    0's through shared memory at the end, register by register.
//  * no key split across blocks: a tile's whole visible range is one
//    block's, so the grid does not depend on start and a key is summed in
//    the same place whatever the pool's geometry. Splits of 256 keys
//    merged through device memory by arrival tickets were measured on the
//    H100: slower at C=256 (0.0258 against 0.0198 ms at start 256), and at
//    C=64 and 128, where the q tiles leave most SMs idle, faster only at
//    C=64 over 960 keys (by 7-11%) and up to 2x slower elsewhere
//    (scripts/compare_paged_decode.py against a checkout with the split).
//  * a ring of 2 stages a group filled by 16-byte cp.async through the
//    table (paged_tiles.cuh): one computed, the next in flight. q's loads
//    are issued before the copies and used only after them (used right
//    after, each stalled its thread: the first tile landed ~3 us later on
//    the H100).
//  * mma.sync m16n8k16 rather than wgmma: a warp's 16 rows are a small
//    product that waits on latency, and the int8 path needs B operands from
//    registers (wgmma reads B from shared memory only, which would bring
//    back a shared-memory conversion pass). S = Q.K^T and O += P.V with P
//    in registers; only tiles that reach a row's causal bound (or the
//    table's end) pay for the mask.
//  * int8 pools: the tiles stay int8 in shared memory and are widened to
//    q's dtype in registers as the fragments are built (paged_tiles.cuh);
//    scale_k per key column to S in f32 after Q.K^T, scale_v per key to P
//    before it is rounded for P.V, while l sums the unscaled P.
//  * float32 inputs take a plain FMA kernel: one warp per query row (int8
//    pools fold the scales into the score and into P, as above).
// At D = 256 (GPT-J, Gemma), behind the template width: a 16-bit stage of
// 64 keys is 66 KB, so a group keeps one stage (its copy no longer overlaps
// its own products, only the other group's: 132 KB; int8 stages, 33 KB,
// keep two), and q's A fragments (64 registers a thread beside the 128 of
// the accumulator and S's 32) sit in shared memory in fragment order
// (paged_tiles.cuh's QTile, 33 KB), loaded by ldmatrix at each k-step.
// Head dims: the kernels are instantiated at DK = 64, 128 and 256 and take
// any true head dim Dv <= DK whose rows are whole 16-byte chunks (a.Dv): q's
// words and the tiles' chunks past Dv are zero (paged_tiles.cuh), and the
// stores stop at Dv. The tensor-core kernel takes those tests as a
// template flag (PARTIAL), so Dv = D runs the code it ran before them
// (with them it measured 6-10% slower at D = 64 and 128: PERF.md §6).
// The f32 kernel reads clamped columns times a zero q.

#include <algorithm>
#include <type_traits>

#include "attention_common.cuh"
#include "hopper.cuh"
#include "paged_tiles.cuh"

namespace {

using namespace dstt;

constexpr int BLOCK_M = 64;   // query rows per block (4 warps x 16)
constexpr int NUM_WARPS = 4;             // warps of a group (the f32 kernel: a block)
constexpr int NUM_THREADS = NUM_WARPS * 32;

// The mma kernel's warp groups of 4 warps (one 16-row warp each), each
// taking every other stage of the keys. Four (at D=64, 128 registers a
// thread: 20 bytes spilled) were slower on the H100.
constexpr int G = 2;

struct Args {
  const int* table;    // [MB] block ids of the slot
  const float* ks;     // int8 pools: scale tiles [NB, KH, BS] by (ks_n, ks_h)
  const float* vs;
  int C, H, KH, NB, BS, MB, start;
  int Dv;   // the true head dim, <= the kernel width D
  long long q_c, q_h, k_n, k_b, k_h, v_n, v_b, v_h, o_c, o_h;
  long long ks_n, ks_h, vs_n, vs_h;
  float scale;
};

// pool row of key position pos (clamped into the pool)
__device__ __forceinline__ long long pool_block(const Args& a, int pos) {
  return min(max(a.table[min(pos / a.BS, a.MB - 1)], 0), a.NB - 1);
}

// grid (q tiles, KH); the design is in the note at the top. PARTIAL: the
// true head dim a.Dv is below D.
template <typename T, typename KV, int D, bool PARTIAL>
__global__ void __launch_bounds__(G * NUM_THREADS, 1)
paged_chunk_mma_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                       const KV* __restrict__ vp, T* __restrict__ o, Args a) {
  using TL = KVTile<KV, D>;
  using CP = TileCopy<KV, D, NUM_THREADS>;   // a group copies its own stages
  constexpr bool Q8 = TL::Q8;
  constexpr int CPT = CP::CPT;
  // D = 256: q's fragments from a tile in shared memory after the ring, and
  // one 16-bit stage a group
  constexpr bool QS = D > 128;
  constexpr int SLOTS = QS && !Q8 ? 1 : 2;   // ring slots a group
  using QT = QTile<T, KV, D, BLOCK_M>;
  extern __shared__ __align__(16) unsigned char smem[];

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int kh = blockIdx.y;
  // warp group gr takes the tile's stages gr, gr + G, ...; warp w of a
  // group owns rows 16w..16w+15 of the q tile
  const int gr = threadIdx.x / NUM_THREADS, warp = threadIdx.x / 32 % NUM_WARPS;
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int R = a.H / a.KH, rows = a.C * R;
  const int span = a.MB * a.BS;
  DSTT_STAMP(0);

  // exclusive bound on the keys row `row` (= c * R + r) sees; rows past the
  // chunk take the last one's (they are never written)
  auto lim_of = [&](int row) { return min(a.start + min(row, rows - 1) / R + 1, span); };
  const int q0 = qt * BLOCK_M;
  const int end = lim_of(q0 + BLOCK_M - 1);   // the tile's keys [0, end), end >= 1
  const int nstages = (end + TILE_KEYS - 1) / TILE_KEYS;

  // this thread's rows, their bounds, and q's words for the A fragments
  // (rows past the chunk zero): all loads issued ahead of the copies, and
  // none used before the copies are issued (a use would stall the thread
  // on its first load and serialise the rest)
  const int wr = q0 + warp * 16;
  const int ra = wr + g, rb = ra + 8;
  const int lim_a = lim_of(ra), lim_b = lim_of(rb), lo = lim_of(wr);
  const T* qa = q + (long long)(min(ra, rows - 1) / R) * a.q_c + (kh * R + ra % R) * a.q_h;
  const T* qb = q + (long long)(min(rb, rows - 1) / R) * a.q_c + (kh * R + rb % R) * a.q_h;
  uint32_t qf[QS ? 1 : D / 16][4];
  if constexpr (!QS) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = TL::qdim(kk, t4, h);
        const bool live = !PARTIAL || d < a.Dv;   // zero past the head dim
        qf[kk][2 * h] = live ? *reinterpret_cast<const uint32_t*>(qa + d) : 0u;
        qf[kk][2 * h + 1] = live ? *reinterpret_cast<const uint32_t*>(qb + d) : 0u;
      }
    }
  }

  const KV* kb = kp + kh * a.k_h;
  const KV* vb = vp + kh * a.v_h;
  // group gr's i-th stage is the tile's stage gr + G*i, in ring slot
  // 2gr + i % 2; the group's threads copy it (tid: a thread's index in its
  // group)
  const int tid = threadIdx.x % NUM_THREADS;
  auto issue = [&](int i) {
    unsigned char* stage = smem + (SLOTS * gr + i % SLOTS) * TL::STAGE;
    const int p0 = (gr + G * i) * TILE_KEYS;
    int blk[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) blk[c] = pool_block(a, min(p0 + CP::row(c, tid), end - 1));
    CP::template issue<PARTIAL>(stage, kb, vb, blk, p0, end, a.BS, a.k_n, a.k_b, a.v_n, a.v_b,
                                a.Dv, tid);
    if constexpr (Q8)
      CP::issue_scales(stage, a.ks + kh * a.ks_h, a.vs + kh * a.vs_h,
                       pool_block(a, min(p0 + tid % TILE_KEYS, end - 1)), p0, end, a.BS,
                       a.ks_n, a.vs_n, tid);
  };
  // a group's stages: one computed, the next one in flight (a third slot a
  // group measured the same on the H100: a stage's product takes longer
  // than its copy)
  const int nmine = nstages > gr ? (nstages - gr + G - 1) / G : 0;   // this group's
  if (nmine > 0) issue(0);
  cp_async_commit();

  // the A fragments: q.scale rounded to q's dtype, as the flash kernel
  T* qs = reinterpret_cast<T*>(smem + G * SLOTS * TL::STAGE);   // QS: the q tile
  if constexpr (QS) {
    // the tile's rows (rows past the chunk zero), filled by both groups
    // while their first stages are in flight
    for (int i = threadIdx.x; i < BLOCK_M * D / 2; i += G * NUM_THREADS) {
      const int r = i / (D / 2), c = 2 * (i % (D / 2)), row = q0 + r, d = QT::dim_at(c);
      uint32_t w = 0u;
      if (row < rows && (!PARTIAL || d < a.Dv)) {
        const T* e = q + (long long)(row / R) * a.q_c + (kh * R + row % R) * a.q_h + d;
        w = pack2<T>(to_float(e[0]) * a.scale, to_float(e[1]) * a.scale);
      }
      *reinterpret_cast<uint32_t*>(qs + r * QT::ROW + c) = w;
    }
    __syncthreads();
  } else {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const T* e = reinterpret_cast<const T*>(&qf[kk][i]);
        const bool live_row = (i % 2 ? rb : ra) < rows;
        qf[kk][i] = live_row ? pack2<T>(to_float(e[0]) * a.scale, to_float(e[1]) * a.scale) : 0u;
      }
    }
  }
  auto qfrag = [&](int kk, uint32_t (&f)[4]) {
    if constexpr (QS) {
      QT::frag(f, qs, warp * 16, kk, lane);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) f[i] = qf[kk][i];
    }
  };

  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};   // per-thread partial row sums, reduced at the end
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // the groups run apart: each waits on its own copies at its own barrier
  for (int i = 0; i < nmine; ++i) {
    if (SLOTS == 2 && i + 1 < nmine) {   // the group's next stage into its other slot
      issue(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    named_barrier(1 + gr, NUM_THREADS);   // the stage landed for the group's copies
    if (i == 0) DSTT_STAMP(1);
    const int st = gr + G * i;
    {
      const unsigned char* kt = smem + (SLOTS * gr + i % SLOTS) * TL::STAGE;
      const unsigned char* vt = kt + TL::BYTES;
      const float* sc = reinterpret_cast<const float*>(vt + TL::BYTES);   // int8: K, V scales
      const int p0 = st * TILE_KEYS;

      // S = Qs . K^T, 16 x 64 per warp: four groups of 16 keys
      float s[4][2][4];
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
#pragma unroll
        for (int t = 0; t < 2; ++t) s[kq][t][0] = s[kq][t][1] = s[kq][t][2] = s[kq][t][3] = 0.f;
        qk_rows16<T, KV, D>(s[kq], qfrag, kt, 16 * kq, lane);
      }
      if constexpr (Q8) {   // S = Qs . (scale_k * K_int)^T
#pragma unroll
        for (int kq = 0; kq < 4; ++kq)
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[kq][t][e] *= sc[16 * kq + s_row<KV, D>(t, e, t4)];
      }
      if (p0 + TILE_KEYS > lo) {   // some key at or past a row's bound
#pragma unroll
        for (int kq = 0; kq < 4; ++kq)
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (p0 + 16 * kq + s_row<KV, D>(t, e, t4) >= (e < 2 ? lim_a : lim_b))
                s[kq][t][e] = -INFINITY;
      }

      // online softmax: new running max, rescale factor, P in registers
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int kq = 0; kq < 4; ++kq)
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          mx[0] = fmaxf(mx[0], fmaxf(s[kq][t][0], s[kq][t][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[kq][t][2], s[kq][t][3]));
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
      uint32_t pf[4][1][4];   // P rounded to q's dtype, as the flash kernel
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int kq = 0; kq < 4; ++kq)
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          float pe[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pe[e] = __expf(s[kq][t][e] - base[e / 2]);
            rs[e / 2] += pe[e];
            // O += (P * scale_v) . V_int; l keeps the unscaled P
            if constexpr (Q8) pe[e] *= sc[TILE_KEYS + 16 * kq + s_row<KV, D>(t, e, t4)];
          }
          pf[kq][0][2 * t] = pack2<T>(pe[0], pe[1]);
          pf[kq][0][2 * t + 1] = pack2<T>(pe[2], pe[3]);
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * alpha[i] + rs[i];
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc[i][0] *= alpha[0];
        acc[i][1] *= alpha[0];
        acc[i][2] *= alpha[1];
        acc[i][3] *= alpha[1];
      }

      // O += P . V
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) pv_step<T, KV, D, 1>(acc, pf[kq], vt, 16 * kq, lane);
    }
    named_barrier(1 + gr, NUM_THREADS);   // the group is done with the slot
    if (SLOTS == 1 && i + 1 < nmine) {   // one slot: the next stage into it now
      issue(i + 1);
      cp_async_commit();
    }
  }
  __syncthreads();   // both groups are done with the ring
  DSTT_STAMP(2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }

  // group 1's partial into group 0's through shared memory, register by
  // register: thread t of group 1 holds the rows and dims thread t of group
  // 0 does, and a register's column of 128 threads is free of bank
  // conflicts (the ring is free: every warp passed the loop's last barrier)
  {
    float* x = reinterpret_cast<float*>(smem);   // [D / 2 + 4][128]
    const int t = threadIdx.x % NUM_THREADS;
    if (gr == 1) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) x[(4 * j + k) * NUM_THREADS + t] = acc[j][k];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        x[(D / 2 + h) * NUM_THREADS + t] = m_r[h];
        x[(D / 2 + 2 + h) * NUM_THREADS + t] = l_r[h];
      }
    }
    __syncthreads();
    if (gr == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m1 = x[(D / 2 + h) * NUM_THREADS + t], mx = fmaxf(m_r[h], m1);
        const float ref = mx == -INFINITY ? 0.f : mx;
        const float f0 = __expf(m_r[h] - ref), f1 = __expf(m1 - ref);
        l_r[h] = l_r[h] * f0 + x[(D / 2 + 2 + h) * NUM_THREADS + t] * f1;
        m_r[h] = mx;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            acc[j][2 * h + e] = acc[j][2 * h + e] * f0 + x[(4 * j + 2 * h + e) * NUM_THREADS + t] * f1;
      }
    }
  }

  auto out_row = [&](int row) -> T* {
    return o + (long long)(row / R) * a.o_c + (kh * R + row % R) * a.o_h;
  };
  if (gr) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? rb : ra;
    if (row >= rows) continue;
    T* orow = out_row(row);
    const float lv = fmaxf(l_r[h], 1e-30f);
    if constexpr (Q8) {   // dims (D/8) * n + j: pairs of neighbouring tiles
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int j = 0; j < D / 8; j += 2)
          if (!PARTIAL || TL::dim(j, e, t4) < a.Dv)
            *reinterpret_cast<uint32_t*>(orow + TL::dim(j, e, t4)) =
                pack2<T>(acc[j][2 * h + e] / lv, acc[j + 1][2 * h + e] / lv);
    } else {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        if (!PARTIAL || TL::dim(j, 0, t4) < a.Dv)
          *reinterpret_cast<uint32_t*>(orow + TL::dim(j, 0, t4)) =
              pack2<T>(acc[j][2 * h] / lv, acc[j][2 * h + 1] / lv);
    }
  }
  DSTT_STAMP(4);
}

// float32: one warp per query row, each lane holding D/32 columns; a column
// past Dv reads column Dv - 1 times a zero q and is not written
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
  int col[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    col[i] = min(lane + 32 * i, a.Dv - 1);
    qv[i] = lane + 32 * i < a.Dv ? qr[col[i]] * a.scale : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const int n_keys = min(a.start + row + 1, a.MB * a.BS);
  for (int c = 0; c < n_keys; ++c) {
    const long long blk = pool_block(a, c), off = c % a.BS;
    const KV* kr = kb + blk * a.k_n + off * a.k_b;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) s = fmaf(qv[i], to_float(kr[col[i]]), s);
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
    for (int i = 0; i < E; ++i) acc[i] = fmaf(pv, to_float(vr[col[i]]), acc[i] * alpha);
    m = mn;
  }
  float* orow = o + (long long)row * a.o_c + h * a.o_h;
#pragma unroll
  for (int i = 0; i < E; ++i)
    if (lane + 32 * i < a.Dv) orow[lane + 32 * i] = acc[i] / fmaxf(l, 1e-30f);
}

template <typename T, int D, bool Q8, bool PARTIAL>
cudaError_t launch_mma_kernel(const void* q, const void* k, const void* v, void* o,
                              const Args& a, cudaStream_t stream) {
  using KV = std::conditional_t<Q8, int8_t, T>;
  using TL = KVTile<KV, D>;
  // the ring (one 16-bit slot a group at D = 256) and the q tile, or the
  // groups' merge
  const int ring = (D > 128 && !Q8 ? 1 : 2) * G * TL::STAGE;
  const int qtile = D > 128 ? QTile<T, KV, D, BLOCK_M>::BYTES : 0;
  const int smem = std::max(ring + qtile, (D / 2 + 4) * NUM_THREADS * 4);
  const cudaError_t e = allow_smem<paged_chunk_mma_kernel<T, KV, D, PARTIAL>>(smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.C * (a.H / a.KH) + BLOCK_M - 1) / BLOCK_M, a.KH);
  paged_chunk_mma_kernel<T, KV, D, PARTIAL><<<grid, G * NUM_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<T*>(o), a);
  return cudaGetLastError();
}

template <typename T, int D, bool Q8>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, const Args& a,
                       cudaStream_t stream) {
  return a.Dv < D ? launch_mma_kernel<T, D, Q8, true>(q, k, v, o, a, stream)
                  : launch_mma_kernel<T, D, Q8, false>(q, k, v, o, a, stream);
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
  if (dtype == 2 && D == 256) return (int)launch_mma<__nv_bfloat16, 256, Q8>(q, k, v, o, a, s);
  if (dtype == 1 && D == 256) return (int)launch_mma<__half, 256, Q8>(q, k, v, o, a, s);
  if (dtype == 0 && D == 64) return (int)launch_f32<64, Q8>(q, k, v, o, a, s);
  if (dtype == 0 && D == 128) return (int)launch_f32<128, Q8>(q, k, v, o, a, s);
  if (dtype == 0 && D == 256) return (int)launch_f32<256, Q8>(q, k, v, o, a, s);
  return (int)cudaErrorInvalidValue;
}

Args make_args(const void* table, int C, int H, int KH, int Dv, int NB, int BS, int MB,
               int start, long long q_c, long long q_h, long long k_n,
               long long k_b, long long k_h, long long v_n, long long v_b,
               long long v_h, long long o_c, long long o_h, float scale) {
  Args a{};
  a.table = static_cast<const int*>(table);
  a.C = C; a.H = H; a.KH = KH; a.Dv = Dv; a.NB = NB; a.BS = BS; a.MB = MB; a.start = start;
  a.q_c = q_c; a.q_h = q_h;
  a.k_n = k_n; a.k_b = k_b; a.k_h = k_h;
  a.v_n = v_n; a.v_b = v_b; a.v_h = v_h;
  a.o_c = o_c; a.o_h = o_h;
  a.scale = scale;
  return a;
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16. D is the kernel width (64, 128
// or 256), Dv the true head dim (1 <= Dv <= D, rows of Dv elements whole
// 16-byte chunks) of q, o and the pools. Strides are in elements, the
// head dim contiguous. q and o [C, H, D]; pools [NB, BS, KH, D] by
// (k_n, k_b, k_h); table [MB] int32 (the slot's block-table row); start is
// the chunk's first absolute position.
extern "C" int dstt_paged_chunk_attention(
    const void* q, const void* k, const void* v, const void* table, void* o,
    int C, int H, int KH, int D, int Dv, int NB, int BS, int MB, int start,
    long long q_c, long long q_h, long long k_n, long long k_b, long long k_h,
    long long v_n, long long v_b, long long v_h, long long o_c, long long o_h,
    float scale, int dtype, void* stream) {
  if (C <= 0 || H <= 0 || KH <= 0 || H % KH || NB <= 0 || BS <= 0 || MB <= 0 || start < 0 ||
      Dv < 1 || Dv > D)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(table, C, H, KH, Dv, NB, BS, MB, start, q_c, q_h, k_n, k_b,
                           k_h, v_n, v_b, v_h, o_c, o_h, scale);
  return dispatch<false>(dtype, D, q, k, v, o, a, stream);
}

// int8 pools: k, v int8 [NB, BS, KH, D]; ks, vs f32 scale tiles [NB, KH, BS]
// by (ks_n, ks_h), the block dim contiguous. dtype is q's and o's.
extern "C" int dstt_paged_chunk_attention_int8(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* table, void* o, int C, int H, int KH, int D, int Dv,
    int NB, int BS, int MB, int start, long long q_c, long long q_h,
    long long k_n, long long k_b, long long k_h, long long v_n, long long v_b,
    long long v_h, long long ks_n, long long ks_h, long long vs_n,
    long long vs_h, long long o_c, long long o_h, float scale, int dtype,
    void* stream) {
  if (C <= 0 || H <= 0 || KH <= 0 || H % KH || NB <= 0 || BS <= 0 || MB <= 0 || start < 0 ||
      Dv < 1 || Dv > D)
    return (int)cudaErrorInvalidValue;
  Args a = make_args(table, C, H, KH, Dv, NB, BS, MB, start, q_c, q_h, k_n, k_b, k_h, v_n,
                     v_b, v_h, o_c, o_h, scale);
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.ks_n = ks_n; a.ks_h = ks_h; a.vs_n = vs_n; a.vs_h = vs_h;
  return dispatch<true>(dtype, D, q, k, v, o, a, stream);
}

extern "C" const char* dstt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
