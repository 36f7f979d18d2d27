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
// Design of the decode kernel (B5, B5i), flash-decoding over the table:
//  * the key range [0, MB*BS) of each unit, one (slot, kv head, group of
//    <= 8 query rows), is cut into `splits` (<= 16) contiguous ranges of
//    `chunk` keys, one block of 4 warps each, so the grid covers the SMs
//    although S * KH is small (200 units at GPT-2 XL, 64 at H=32/KH=8).
//    The plan comes from the wrapper (`paged_split_plan`), from static
//    sizes only: MB*BS, S, KH, H/KH and the SM count. Lengths stay on the
//    device (no host sync): a split past its unit's visible bound exits
//    right after reading the length. The grid runs splits slowest, so the
//    first splits of every unit, the ones most likely to have keys, are
//    scheduled first, kv heads fastest (neighbouring blocks read
//    neighbouring rows of the same pages).
//  * A slot's R = H/KH query heads of one kv head share a block, so its
//    keys stream once for the whole GQA group.
//  * copies: the block streams its range through a ring of 2 stages in
//    shared memory (8 KB of K and V rows a stage) with 16-byte cp.async,
//    one table lookup tables[s][pos / BS] per key row; the first stages'
//    lookups depend on the static range only and load beside the length,
//    so a block waits for two dependent reads (length and table, then
//    rows), not three. An int8 pool's f32 scales ride along by 4-byte
//    cp.async. Rows past the range are zero-filled, not read.
//  * compute: each key row is read from shared memory 8 elements a lane by
//    D/8 neighbouring lanes (16 bytes of bf16, 8 of int8 — the copy width
//    no longer sets the register cost of q and the accumulators; int8
//    widens by byte permutes, not I2F). Every lane group keeps an f32
//    online softmax per query row; the groups merge by shuffles, then the
//    warps through shared memory.
//  * merge, in the same launch and in a fixed order: a unit with one live
//    split writes its output directly. Otherwise each live split writes its
//    (m, l, acc) to a scratch slot and takes an arrival ticket; the last to
//    arrive merges the partials in split order, writes the output and
//    resets the ticket to zero for the next launch (no memset, no second
//    launch; the same bits on every run). A unit that sees no key gives
//    exact zeros.
//  * int8: the scales are folded, not applied per element: the score of
//    key j is scale_k[j] * (q . k_int[j]) and the accumulator takes
//    (p_j * scale_v[j]) * v_int[j] while l sums the unscaled p_j — the
//    TPU kernel's function up to the order of f32 sums.
//  * a table entry is clamped into [0, NB) before use, so a corrupt table
//    cannot read outside the pool.
// The verify kernel (B7, B7i) keeps its one-block-per-unit design (below):
// split the same way it was slower (an A/B in one process on the H100 at
// K=4: 0.0292 against 0.0255 ms at GPT-2 XL, 0.0960 against 0.0597 at
// H=32/KH=8, scripts/compare_paged_decode.py).

#include <algorithm>
#include <type_traits>

#include "attention_common.cuh"

namespace {

using namespace dstt;

constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int STAGES = 2;           // ring depth
constexpr int STAGE_BYTES = 8192;   // K and V rows of one stage
constexpr int MAX_SPLITS = 16;      // splits a unit, at most
constexpr int VERIFY_WARPS = 8;     // the verify kernel: warps a block
constexpr int VERIFY_THREADS = VERIFY_WARPS * 32;
constexpr int UNROLL = 4;           // its load steps in flight a warp

template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };

// The ring's geometry for key rows of D elements of KV
template <typename KV, int D>
struct Ring {
  static constexpr int ROWB = D * (int)sizeof(KV);     // bytes of a key row
  static constexpr int KS = STAGE_BYTES / (2 * ROWB);  // keys a stage
  static constexpr int CPR = ROWB / 16;                // 16-byte copies a row
  static constexpr int VEC = 8;                        // elements a lane reads
  static constexpr int LPK = D / VEC;                  // lanes a key
  static constexpr int G = 32 / LPK;                   // keys a warp, a step
  static constexpr int KPG = KS / (NUM_WARPS * G);     // keys a lane group, a stage
  static constexpr bool Q8 = std::is_same<KV, int8_t>::value;
  static constexpr int SCALE_BYTES = Q8 ? STAGES * 2 * KS * 4 : 0;
  static constexpr int SMEM = STAGES * STAGE_BYTES + SCALE_BYTES;
  static_assert(KPG >= 1 && KS % (NUM_WARPS * G) == 0 && 32 % LPK == 0, "ring shape");
  static_assert((KS * CPR) % NUM_THREADS == 0, "whole copies a thread");
};

struct Args {
  const int* tables;   // [S, MB], row stride t_s
  const int* lengths;  // [S]
  const float* ks;     // int8 pools: scale tiles [NB, KH, BS] by (ks_n, ks_h)
  const float* vs;
  int NB, BS, MB;
  int R;               // query heads per kv head
  int nrows;           // query rows per (slot, kv head): K * R
  int extra;           // row j sees col < lengths[s] + extra + j / R
  int chunk;           // keys a split
  int* tickets;        // [units] arrivals, zero between launches
  float* part;         // [units][splits][ROWS * (D + 2)] partials
  long long q_s, q_k, q_h, k_n, k_b, k_h, v_n, v_b, v_h, t_s, o_s, o_k, o_h;
  long long ks_n, ks_h, vs_n, vs_h;
  float scale;
};

// VEC elements of a key row in shared memory, as floats
template <typename KV, int VEC>
__device__ __forceinline__ void row_vec(const KV* p, float (&f)[VEC]) {
  constexpr int BYTES = VEC * (int)sizeof(KV);
  if constexpr (BYTES >= 16) {
    uint4 raw[BYTES / 16];
#pragma unroll
    for (int j = 0; j < BYTES / 16; ++j) raw[j] = reinterpret_cast<const uint4*>(p)[j];
    const KV* e = reinterpret_cast<const KV*>(raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = to_float(e[i]);
  } else {
    static_assert(BYTES == 8 && std::is_same<KV, int8_t>::value, "int8 rows");
    // 8 int8 by byte permutes, exactly: byte b + 128 into the mantissa of
    // 2^23 gives 2^23 + 128 + b (full-rate PRMT and FADD, not I2F)
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const uint32_t w[2] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      f[i] = __uint_as_float(__byte_perm(w[i / 4], 0x4B000000u, 0x7650 + i % 4)) - 8388736.f;
  }
}

// grid (splits, KH * row groups, S); unit = one (slot, kv head, row group)
template <typename T, typename KV, int D, int ROWS>
__global__ void __launch_bounds__(NUM_THREADS, ROWS <= 2 ? 8 : 16 / ROWS)
paged_split_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                   const KV* __restrict__ vp, T* __restrict__ o, Args a) {
  using RG = Ring<KV, D>;
  constexpr bool Q8 = RG::Q8;
  constexpr int VEC = RG::VEC, LPK = RG::LPK, G = RG::G, KS = RG::KS;
  constexpr int KPG = RG::KPG, CPR = RG::CPR, ROWB = RG::ROWB;
  constexpr int CPT = KS * CPR / NUM_THREADS;      // 16-byte copies a thread, a stage
  constexpr int QCH = VEC * (int)sizeof(T) / 16;   // 16-byte loads of q a lane
  static_assert(QCH >= 1 && QCH * 16 == VEC * (int)sizeof(T), "q vector");
  extern __shared__ __align__(16) unsigned char smem[];
  float* scales = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);
  __shared__ int is_last;

  const int split = blockIdx.z, nsplit = gridDim.z;
  const int groups = (a.nrows + ROWS - 1) / ROWS;
  const int kh = blockIdx.x / groups, row0 = (blockIdx.x % groups) * ROWS;
  const int s = blockIdx.y;
  const long long unit = (long long)s * gridDim.x + blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LPK, d0 = (lane % LPK) * VEC;
  const int span = a.MB * a.BS;
  const int* table = a.tables + s * a.t_s;
  const int beg = split * a.chunk;

  // table entry of position pos (clamped into the row: a position past the
  // range reads the last entry, which is never used) and block id (clamped
  // into [0, NB))
  auto block_of = [&](int pos) {
    return min(max(table[min(pos / a.BS, a.MB - 1)], 0), a.NB - 1);
  };
  // the first STAGES stages' table entries depend on the static range only:
  // they load beside the length, not after it
  const int len = a.lengths[s];
  int pblk[STAGES][CPT], sblk[STAGES];
#pragma unroll
  for (int st = 0; st < STAGES; ++st) {
#pragma unroll
    for (int i = 0; i < CPT; ++i)
      pblk[st][i] = block_of(beg + st * KS + (threadIdx.x + i * NUM_THREADS) / CPR);
    sblk[st] = Q8 ? block_of(beg + st * KS + threadIdx.x % KS) : 0;
  }

  // per-row exclusive bound on visible positions; this split's range is
  // [beg, end) below the largest of them (uniform across the block)
  int lim[ROWS];
  int hi = 0;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int j = row0 + r;
    lim[r] = j < a.nrows ? max(0, min(len + a.extra + j / a.R, span)) : 0;
    hi = max(hi, lim[r]);
  }
  // splits with keys; split 0 always runs (zeros for a unit that sees none)
  const int live = hi > 0 ? (hi + a.chunk - 1) / a.chunk : 1;
  if (split >= live) return;
  const int end = min(beg + a.chunk, hi);
  const int nstages = end > beg ? (end - beg + KS - 1) / KS : 0;

  // stage st: keys beg + st*KS .. into ring slot st % STAGES, through the
  // block ids blks (copies) and sb (this thread's scale)
  auto issue = [&](int st, const int (&blks)[CPT], int sb) {
    unsigned char* kbuf = smem + (st % STAGES) * STAGE_BYTES;
    unsigned char* vbuf = kbuf + KS * ROWB;
    const int p0 = beg + st * KS;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = threadIdx.x + i * NUM_THREADS;
      const int pos = p0 + c / CPR;
      const bool ok = pos < end;
      const long long off = ok ? pos % a.BS : 0;
      const int e0 = (c % CPR) * (16 / (int)sizeof(KV));
      cp_async16(kbuf + c * 16, kp + blks[i] * a.k_n + off * a.k_b + kh * a.k_h + e0, ok);
      cp_async16(vbuf + c * 16, vp + blks[i] * a.v_n + off * a.v_b + kh * a.v_h + e0, ok);
    }
    if constexpr (Q8) {
      if (threadIdx.x < KS) {
        float* sk = scales + (st % STAGES) * 2 * KS;
        const int pos = p0 + threadIdx.x;
        const bool ok = pos < end;
        const long long off = ok ? pos % a.BS : 0;
        cp_async4(sk + threadIdx.x, a.ks + sb * a.ks_n + kh * a.ks_h + off, ok);
        cp_async4(sk + KS + threadIdx.x, a.vs + sb * a.vs_n + kh * a.vs_h + off, ok);
      }
    }
  };

#pragma unroll
  for (int st = 0; st < STAGES; ++st) {
    if (st < nstages) issue(st, pblk[st], sblk[st]);
    cp_async_commit();
  }

  float qv[ROWS][VEC], acc[ROWS][VEC], m[ROWS], l[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int j = row0 + r;
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

  for (int st = 0; st < nstages; ++st) {
    cp_async_wait<STAGES - 1>();
    __syncthreads();   // stage st landed for every thread's copies
    const KV* kbuf = reinterpret_cast<const KV*>(smem + (st % STAGES) * STAGE_BYTES);
    const KV* vbuf = kbuf + KS * D;
    const float* sk = scales + (st % STAGES) * 2 * KS;
    const int p0 = beg + st * KS;
    float sc[ROWS][KPG];
#pragma unroll
    for (int u = 0; u < KPG; ++u) {
      const int key = (u * NUM_WARPS + warp) * G + grp;
      float kf[VEC];
      row_vec<KV, VEC>(kbuf + key * D + d0, kf);
      const float ksc = Q8 ? sk[key] : 1.f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) dot = fmaf(qv[r][i], kf[i], dot);
#pragma unroll
        for (int off = LPK / 2; off > 0; off /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if constexpr (Q8) dot *= ksc;
        sc[r][u] = p0 + key < lim[r] ? dot : -INFINITY;
      }
    }
    // rescale each row once a stage, then P.V with each V row read once
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float mn = m[r];
#pragma unroll
      for (int u = 0; u < KPG; ++u) mn = fmaxf(mn, sc[r][u]);
      const float ref = mn == -INFINITY ? 0.f : mn;
      const float alpha = __expf(m[r] - ref);
      l[r] *= alpha;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[r][i] *= alpha;
#pragma unroll
      for (int u = 0; u < KPG; ++u) {
        sc[r][u] = __expf(sc[r][u] - ref);
        l[r] += sc[r][u];
      }
      m[r] = mn;
    }
#pragma unroll
    for (int u = 0; u < KPG; ++u) {
      const int key = (u * NUM_WARPS + warp) * G + grp;
      float vf[VEC];
      row_vec<KV, VEC>(vbuf + key * D + d0, vf);
      const float vsc = Q8 ? sk[KS + key] : 1.f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float pv = Q8 ? sc[r][u] * vsc : sc[r][u];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[r][i] = fmaf(pv, vf[i], acc[r][i]);
      }
    }
    __syncthreads();   // every warp is done with the slot before it refills
    if (st + STAGES < nstages) {
      int nb[CPT];
#pragma unroll
      for (int i = 0; i < CPT; ++i)
        nb[i] = block_of(beg + (st + STAGES) * KS + (threadIdx.x + i * NUM_THREADS) / CPR);
      issue(st + STAGES, nb, Q8 ? block_of(beg + (st + STAGES) * KS + threadIdx.x % KS) : 0);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();

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
  // the ring and the scales are free now (the launch gives the block room
  // for whichever is larger): the warps' partials, then the block's
  float* wm = reinterpret_cast<float*>(smem);   // [NUM_WARPS][ROWS]
  float* wl = wm + NUM_WARPS * ROWS;            // [NUM_WARPS][ROWS]
  float* wacc = wl + NUM_WARPS * ROWS;          // [NUM_WARPS][ROWS][D]
  float* bm = wacc + NUM_WARPS * ROWS * D;      // [ROWS]; then bl [ROWS]
  float* bl = bm + ROWS;                        // and bacc [ROWS][D]: the
  float* bacc = bl + ROWS;                      // block's partial, contiguous
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (d0 == 0) {
        wm[warp * ROWS + r] = m[r];
        wl[warp * ROWS + r] = l[r];
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) wacc[(warp * ROWS + r) * D + d0 + i] = acc[r][i];
    }
  }
  __syncthreads();
  // merge the warps: one thread per (row, column)
  for (int idx = threadIdx.x; idx < ROWS * D; idx += NUM_THREADS) {
    const int r = idx / D, d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NUM_WARPS; ++w) mx = fmaxf(mx, wm[w * ROWS + r]);
    const float ref = mx == -INFINITY ? 0.f : mx;
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < NUM_WARPS; ++w) {
      const float f = __expf(wm[w * ROWS + r] - ref);
      lt += wl[w * ROWS + r] * f;
      at += wacc[(w * ROWS + r) * D + d] * f;
    }
    bacc[idx] = at;
    if (d == 0) {
      bm[r] = mx;
      bl[r] = lt;
    }
  }
  __syncthreads();
  auto out = [&](int r, int d) -> T& {
    const int j = row0 + r;
    return o[s * a.o_s + (j / a.R) * a.o_k + (kh * a.R + j % a.R) * a.o_h + d];
  };
  if (live == 1) {   // the unit's only split: its partial is the output
    for (int idx = threadIdx.x; idx < ROWS * D; idx += NUM_THREADS) {
      const int r = idx / D;
      if (row0 + r < a.nrows) out(r, idx % D) = from_float<T>(bacc[idx] / fmaxf(bl[r], 1e-30f));
    }
    return;
  }

  // publish the partial; the last split of the unit to arrive merges them
  // all in split order and resets the unit's ticket for the next launch
  constexpr int PART = ROWS * (D + 2);
  float* part = a.part + unit * nsplit * PART;
  for (int idx = threadIdx.x; idx < PART; idx += NUM_THREADS) part[split * PART + idx] = bm[idx];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(a.tickets + unit, 1) == live - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int idx = threadIdx.x; idx < ROWS * D; idx += NUM_THREADS) {
    const int r = idx / D;
    if (row0 + r >= a.nrows) continue;
    float ms[MAX_SPLITS], ls[MAX_SPLITS], av[MAX_SPLITS];
    float mx = -INFINITY;
#pragma unroll
    for (int p = 0; p < MAX_SPLITS; ++p) {
      ms[p] = -INFINITY;
      ls[p] = av[p] = 0.f;
      if (p < live) {
        ms[p] = __ldcg(part + p * PART + r);
        ls[p] = __ldcg(part + p * PART + ROWS + r);
        av[p] = __ldcg(part + p * PART + 2 * ROWS + idx);
      }
      mx = fmaxf(mx, ms[p]);
    }
    const float ref = mx == -INFINITY ? 0.f : mx;
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int p = 0; p < MAX_SPLITS; ++p) {
      const float f = __expf(ms[p] - ref);
      lt += ls[p] * f;
      at += av[p] * f;
    }
    out(r, idx % D) = from_float<T>(at / fmaxf(lt, 1e-30f));
  }
  if (threadIdx.x == 0) a.tickets[unit] = 0;
}

// The verify kernel (B7, B7i): one block of 8 warps per (kv head, slot,
// group of <= 8 query rows) walks the whole key range, each key row read
// with vector loads by D/VEC neighbouring lanes (16 bytes a lane; int8 rows
// at 8 bytes once a block holds more than 2 query rows), UNROLL steps of
// loads issued before any is used; lane groups merge by shuffles, warps
// through shared memory. Same numerics as the split kernel.
template <typename T, typename KV, int D, int ROWS>
__global__ void __launch_bounds__(VERIFY_THREADS)
paged_verify_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                  const KV* __restrict__ vp, T* __restrict__ o, Args a) {
  constexpr bool Q8 = std::is_same<KV, int8_t>::value;
  constexpr int VEC = Q8 ? (ROWS <= 2 ? 16 : 8) : 16 / sizeof(KV);  // per lane
  using KRaw = typename Raw<VEC * sizeof(KV)>::type;
  constexpr int QCH = VEC * sizeof(T) / 16;   // 16-byte loads of q per lane
  constexpr int LPK = D / VEC;          // lanes per key row
  constexpr int KPW = 32 / LPK;         // keys per warp per step
  constexpr int STEP = VERIFY_WARPS * KPW; // keys per block per step
  static_assert(D % VEC == 0 && 32 % LPK == 0, "unsupported head dim");
  static_assert(QCH >= 1 && QCH * 16 == VEC * sizeof(T), "unsupported q vector");

  __shared__ float sm_m[VERIFY_WARPS][ROWS];
  __shared__ float sm_l[VERIFY_WARPS][ROWS];
  __shared__ float sm_acc[VERIFY_WARPS][ROWS][D];

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
  for (int idx = threadIdx.x; idx < ROWS * D; idx += VERIFY_THREADS) {
    const int r = idx / D, d = idx % D;
    const int j = row0 + r;
    if (j >= a.nrows) continue;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < VERIFY_WARPS; ++w) mx = fmaxf(mx, sm_m[w][r]);
    const float ref = mx == -INFINITY ? 0.f : mx;
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < VERIFY_WARPS; ++w) {
      const float f = __expf(sm_m[w][r] - ref);
      lt += sm_l[w][r] * f;
      at += sm_acc[w][r][d] * f;
    }
    o[s * a.o_s + (j / a.R) * a.o_k + (kh * a.R + j % a.R) * a.o_h + d] = from_float<T>(at / fmaxf(lt, 1e-30f));
  }
}

template <typename T, typename KV, int D, int ROWS>
cudaError_t launch_split(const void* q, const void* k, const void* v, void* o,
                         int S, int KH, int splits, const Args& a,
                         cudaStream_t stream) {
  dim3 grid(KH * ((a.nrows + ROWS - 1) / ROWS), S, splits);
  const int smem = std::max(Ring<KV, D>::SMEM, (NUM_WARPS * ROWS * (D + 2) + ROWS * (D + 2)) * 4);
  paged_split_kernel<T, KV, D, ROWS><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<T*>(o), a);
  return cudaGetLastError();
}

template <typename T, typename KV, int D, int ROWS>
cudaError_t launch_verify(const void* q, const void* k, const void* v,
                          void* o, int S, int KH, int, const Args& a,
                          cudaStream_t stream) {
  dim3 grid(KH, S, (a.nrows + ROWS - 1) / ROWS);
  paged_verify_kernel<T, KV, D, ROWS><<<grid, VERIFY_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<T*>(o), a);
  return cudaGetLastError();
}

template <bool SPLIT, typename T, typename KV, int D, int ROWS>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int S, int KH, int splits, const Args& a,
                   cudaStream_t stream) {
  if constexpr (SPLIT) return launch_split<T, KV, D, ROWS>(q, k, v, o, S, KH, splits, a, stream);
  else return launch_verify<T, KV, D, ROWS>(q, k, v, o, S, KH, splits, a, stream);
}

// rows per block: the smallest power of two >= K*R, at most 8
template <bool SPLIT, typename T, typename KV, int D>
cudaError_t launch_rows(const void* q, const void* k, const void* v, void* o,
                        int S, int KH, int splits, const Args& a,
                        cudaStream_t stream) {
  if (a.nrows <= 1) return launch<SPLIT, T, KV, D, 1>(q, k, v, o, S, KH, splits, a, stream);
  if (a.nrows <= 2) return launch<SPLIT, T, KV, D, 2>(q, k, v, o, S, KH, splits, a, stream);
  if (a.nrows <= 4) return launch<SPLIT, T, KV, D, 4>(q, k, v, o, S, KH, splits, a, stream);
  return launch<SPLIT, T, KV, D, 8>(q, k, v, o, S, KH, splits, a, stream);
}

template <bool SPLIT, typename T, typename KV>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* o, int S, int KH, int splits, const Args& a,
                     cudaStream_t stream) {
  if (D == 64) return launch_rows<SPLIT, T, KV, 64>(q, k, v, o, S, KH, splits, a, stream);
  if (D == 128) return launch_rows<SPLIT, T, KV, 128>(q, k, v, o, S, KH, splits, a, stream);
  return cudaErrorInvalidValue;
}

// SPLIT: the decode kernel, whose plan must cover the key range (1 <=
// splits <= 16, splits * chunk >= MB*BS), else the verify kernel. Q8: int8
// pools (with a.ks / a.vs); else the pools have q's dtype.
template <bool SPLIT, bool Q8>
int dispatch(int dtype, int D, const void* q, const void* k, const void* v,
             void* o, int S, int KH, int splits, const Args& a, void* stream) {
  if (SPLIT && (splits < 1 || splits > MAX_SPLITS || a.chunk < 1 ||
                (long long)splits * a.chunk < (long long)a.MB * a.BS))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_d<SPLIT, float, std::conditional_t<Q8, int8_t, float>>(D, q, k, v, o, S, KH, splits, a, st);
    case 1: return (int)launch_d<SPLIT, __half, std::conditional_t<Q8, int8_t, __half>>(D, q, k, v, o, S, KH, splits, a, st);
    case 2: return (int)launch_d<SPLIT, __nv_bfloat16, std::conditional_t<Q8, int8_t, __nv_bfloat16>>(D, q, k, v, o, S, KH, splits, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

Args make_args(const void* tables, const void* lengths, void* tickets,
               void* part, int NB, int BS, int MB, int chunk, int R, int nrows, int extra, long long q_s,
               long long q_k, long long q_h, long long k_n, long long k_b,
               long long k_h, long long v_n, long long v_b, long long v_h,
               long long t_s, long long o_s, long long o_k, long long o_h,
               float scale) {
  Args a{};
  a.tables = static_cast<const int*>(tables);
  a.lengths = static_cast<const int*>(lengths);
  a.tickets = static_cast<int*>(tickets);
  a.part = static_cast<float*>(part);
  a.NB = NB; a.BS = BS; a.MB = MB; a.chunk = chunk;
  a.R = R; a.nrows = nrows; a.extra = extra;
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
// int32; all on the device. The plan: each key range [0, MB*BS) in
// `splits` (1..16) ranges of `chunk` keys, splits * chunk >= MB*BS. Its
// scratch: tickets, int32 [S * KH * row groups], all zero (the kernel
// leaves them zero), and part, f32 [S * KH * row groups * splits * rows *
// (D + 2)] (rows: the smallest power of two >= H/KH, at most 8; row
// groups: ceil(H/KH / 8)). Launches that share a scratch must run in order
// (one stream).
extern "C" int dstt_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* tables,
    const void* lengths, void* o, void* tickets, void* part, int S, int H,
    int KH, int D, int NB, int BS, int MB, int splits, int chunk,
    long long q_s, long long q_h, long long k_n, long long k_b, long long k_h,
    long long v_n, long long v_b, long long v_h, long long t_s, long long o_s,
    long long o_h, float scale, int dtype, void* stream) {
  if (S <= 0 || KH <= 0 || H % KH || NB <= 0 || BS <= 0 || MB <= 0) return (int)cudaErrorInvalidValue;
  const Args a = make_args(tables, lengths, tickets, part, NB, BS, MB, chunk, H / KH, H / KH, 0,
                           q_s, 0, q_h, k_n, k_b, k_h, v_n, v_b, v_h, t_s, o_s, 0, o_h, scale);
  return dispatch<true, false>(dtype, D, q, k, v, o, S, KH, splits, a, stream);
}

// As above with q and o [S, K, H, D] by (q_s, q_k, q_h) and (o_s, o_k, o_h);
// no plan.
extern "C" int dstt_paged_verify_attention(
    const void* q, const void* k, const void* v, const void* tables,
    const void* lengths, void* o, int S, int K, int H, int KH, int D, int NB,
    int BS, int MB, long long q_s, long long q_k, long long q_h, long long k_n,
    long long k_b, long long k_h, long long v_n, long long v_b, long long v_h,
    long long t_s, long long o_s, long long o_k, long long o_h, float scale,
    int dtype, void* stream) {
  if (S <= 0 || K <= 0 || KH <= 0 || H % KH || NB <= 0 || BS <= 0 || MB <= 0) return (int)cudaErrorInvalidValue;
  const Args a = make_args(tables, lengths, nullptr, nullptr, NB, BS, MB, 0, H / KH, K * (H / KH), 1,
                           q_s, q_k, q_h, k_n, k_b, k_h, v_n, v_b, v_h, t_s, o_s, o_k, o_h, scale);
  return dispatch<false, false>(dtype, D, q, k, v, o, S, KH, 0, a, stream);
}

// int8 pools: k, v int8 [NB, BS, KH, D]; ks, vs f32 scale tiles [NB, KH, BS]
// by (ks_n, ks_h), the block dim contiguous. dtype is q's and o's.
extern "C" int dstt_paged_decode_attention_int8(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* tables, const void* lengths, void* o,
    void* tickets, void* part, int S, int H, int KH, int D, int NB, int BS,
    int MB, int splits, int chunk, long long q_s, long long q_h, long long k_n,
    long long k_b, long long k_h, long long v_n, long long v_b, long long v_h,
    long long ks_n, long long ks_h, long long vs_n, long long vs_h,
    long long t_s, long long o_s, long long o_h, float scale, int dtype,
    void* stream) {
  if (S <= 0 || KH <= 0 || H % KH || NB <= 0 || BS <= 0 || MB <= 0) return (int)cudaErrorInvalidValue;
  Args a = make_args(tables, lengths, tickets, part, NB, BS, MB, chunk, H / KH, H / KH, 0,
                     q_s, 0, q_h, k_n, k_b, k_h, v_n, v_b, v_h, t_s, o_s, 0, o_h, scale);
  set_scales(a, ks, vs, ks_n, ks_h, vs_n, vs_h);
  return dispatch<true, true>(dtype, D, q, k, v, o, S, KH, splits, a, stream);
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
  Args a = make_args(tables, lengths, nullptr, nullptr, NB, BS, MB, 0, H / KH, K * (H / KH), 1,
                     q_s, q_k, q_h, k_n, k_b, k_h, v_n, v_b, v_h, t_s, o_s, o_k, o_h, scale);
  set_scales(a, ks, vs, ks_n, ks_h, vs_n, vs_h);
  return dispatch<false, true>(dtype, D, q, k, v, o, S, KH, 0, a, stream);
}

extern "C" const char* dstt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
