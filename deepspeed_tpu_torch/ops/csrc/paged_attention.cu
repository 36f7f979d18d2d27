// Paged decode, dense decode and paged verify attention for Hopper (sm_90a).
//
// Replaces three Pallas kernels of deepspeed_tpu/ops/pallas/decode_attention.py:
//  * `_paged_decode_kernel` (:164, entry `paged_decode_attention` :217):
//    one query token per slot attends that slot's keys through its block
//    table; key position `col` is visible iff col < lengths[s];
//  * `_decode_kernel` (:78, entry `decode_attention` :115): the same over
//    the dense cache [B, S, KH, D] (the layer view of the engine's
//    [L, B, S, KH, D] cache, read through its strides), row b attending
//    positions < lengths[b], the lengths clamped into [0, S];
//  * `_paged_verify_kernel` (:421, entry `paged_verify_attention` :479):
//    every slot's K candidate tokens at positions lengths[s]..lengths[s]+K-1
//    attend the slot's keys; query k sees col <= lengths[s] + k.
// The paged ones in two variants: full-precision pools (the pool dtype is
// q's), and int8 pools with f32 scale tiles [NB, KH, BS] (the kernels' int8
// branch, `_deq_tile` :46, which dequantizes each tile in VMEM).
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
//    keys stream once for the whole GQA group; any R: a (slot, kv head)
//    takes ceil(R / 8) units.
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
// Design of the dense decode kernel (B4, `decode_dense_kernel`): B5's
// units, plan and merge on a kernel of its own.
//  * unit = one (batch row, kv head, group of <= 8 query rows): any R =
//    H / KH takes ceil(R / 8) units, and a unit's keys stream once for its
//    rows. Its key range [0, S) is cut into `splits` ranges of `chunk`
//    keys (`dense_split_plan` in the wrapper, from static sizes only: S and
//    the units against the SM count; below the cap of 16 splits the chunk
//    does not depend on S). One block of 8 warps a (unit, split); a split
//    past the row's length exits after reading it. A unit with one live
//    split merges its warps straight into the output; otherwise the live
//    splits merge in split order by arrival tickets (`finish_split`, B5's).
//  * copies: each lane holds 4 steps of 16-byte loads of K and V in
//    registers (32 KB in flight a block), as streaming loads (`__ldcs`:
//    first in line for eviction, so the stream does not evict lines other
//    kernels wrote and L2 would have to write back); positions are
//    addressed through the cache's strides, no table.
//  * why not B5's body: a dense cache is a pool whose table is the
//    identity, and B5's split kernel took it as such (a template policy),
//    with a ring of 3 stages of 64 keys and a persistent grid that numbered
//    only the live splits. At phase decode's GPT-2 XL case it ran 0.0221
//    to 0.0264 ms against 0.0202-0.0206 for this kernel without streaming
//    loads (PERF.md, B4's design steps): behind an L2 flush the K/V
//    stream is bound by the HBM, and every variant with more bytes in
//    flight (the ring, 8 steps a lane) finished later.
// What bounds B4 at phase decode's shapes: the HBM and the launch. The
// live K/V of GPT-2 XL's 8 rows (~21 MB) take 0.0146-0.0160 ms to read
// once after the flush (streaming and plain loads of a kernel that does
// nothing else, scripts/stamp_decode_sparse.py), against 6.4 µs at
// 3.35 TB/s; an empty launch takes 0.0046.
// Design of the verify kernel (B7, B7i) over 16-bit queries
// (`paged_verify_mma_kernel`): B5's split-and-merge, with the query rows on
// the tensor cores.
//  * unit = one (slot, kv head, group of <= 16 query rows): row j of the
//    unit is candidate j / R of head kh*R + j % R, and all K*R <= 16 rows
//    of a (slot, kv head) are the 16-row A operand of mma.sync m16n8k16,
//    so K/V are read once per (slot, kv head) and 16 rows cost the
//    products of one (on the CUDA cores every f32 FMA repeats per row:
//    the split kernel at K*R rows is bound by them). Row j keeps its own
//    bound col <= lengths[s] + j/R.
//  * the key range of a unit is cut into splits of 256 keys
//    (`paged_verify_plan` in the wrapper: static sizes only, never MB below
//    the cap); a dead split ends at the length read, and the live splits
//    merge in the same launch in split order with arrival tickets
//    (`finish_split`, shared with B5).
//  * copies: a ring of 3 stages of 64 keys filled by 16-byte cp.async
//    through the table (paged_tiles.cuh); q's loads and the first stages'
//    table entries are issued beside the length read. Each of the 4 warps
//    takes 16 keys of every stage: S = Q.K^T on two n8 tiles, the online
//    softmax in f32, P from registers into O += P.V; the warps merge
//    through shared memory.
//  * numerics at f32's precision, as the decode kernel's: q enters the
//    product as it is (q.K^T is exact in f32) and the scale multiplies S in
//    f32; P goes into P.V as three bf16 terms (P rounded, then its
//    remainders) or one fp16 term, so the output is held to one rounding
//    of the f32 result (DECODE_TOL).
//  * int8 pools: the tiles stay int8 in shared memory and are widened in
//    registers as the fragments are built (paged_tiles.cuh); scale_k scales
//    S per key column, scale_v scales P before its rounding, l sums the
//    unscaled P.
// f32 queries take the decode kernel's split kernel (`paged_split_kernel`,
// units of <= 8 rows, the same plan): f32 has no tensor-core product of its
// precision, and the main path runs 16-bit queries.
// Head dims: every kernel is instantiated at DK = 64, 128 and 256 (the
// template D; the ring, the tiles, the partials and their scratch keep that
// width)
// and takes any true head dim Dv <= DK whose rows are whole 16-byte chunks
// (a.Dv). A chunk past Dv adds nothing to q.k or P.V: B5-B7 zero-fill it
// in the copy to shared memory (the copy's row test gains the column
// test), and B4's lanes past Dv hold a zero q and read their key rows'
// first columns, so the key loops gain no instruction and no register. The
// outputs are written only below Dv. B7's kernel takes the column tests
// as a template flag (PARTIAL), so Dv = D runs the code it ran before
// them: with them it measured 12-21% slower at D = 64 and 128, B4 and B5
// within 2% (PERF.md §6).
// At D = 256 (GPT-J, Gemma), behind the template width so that D = 64 and
// 128 compile to the code they had:
//  * B5: a key row is 32 lanes of 8 values, so a warp step takes one key
//    and a stage of 8 KB holds 8 keys of 16-bit rows (16 of int8);
//  * B4: f32 rows take two 16-byte loads a lane (a row is still one warp);
//    the warps' partials (74 KB at 8 rows) need the opt-in shared memory;
//  * B7: the 16 query rows' A fragments (64 registers a thread beside the
//    128 of the f32 accumulator) would spill, so q sits in shared memory
//    in fragment order (paged_tiles.cuh's QTile) and each k-step loads its
//    fragment by ldmatrix; three stages of 64 keys (66 KB each at 16 bits)
//    and the q tile take 207 KB.

#include <algorithm>
#include <type_traits>

#include "attention_common.cuh"
#include "paged_tiles.cuh"

namespace {

using namespace dstt;

constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int STAGES = 2;           // ring depth
constexpr int STAGE_BYTES = 8192;   // K and V rows of one stage
constexpr int MAX_SPLITS = 16;      // splits a unit, at most
constexpr int RING = 3;             // the mma verify kernel: stages at most

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
  int slots;           // the mma verify kernel's ring stages
  int Dv;              // the true head dim, <= the kernel width D
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

// The decode kernel's warps' partials (shared memory at ws: m, l
// [NUM_WARPS][ROWS], acc [NUM_WARPS][ROWS][D]) merged in warp order into
// the block's, after them: acc [ROWS][D], m [ROWS], l [ROWS]; the block's
// first nr rows. Returns the block's partial.
template <int D, int ROWS, int WARPS = NUM_WARPS>
__device__ __forceinline__ float* merge_warps(float* ws, int nr) {
  float* wm = ws;                               // [WARPS][ROWS]
  float* wl = wm + WARPS * ROWS;                // [WARPS][ROWS]
  float* wacc = wl + WARPS * ROWS;              // [WARPS][ROWS][D]
  float* bacc = wacc + WARPS * ROWS * D;
  float* bm = bacc + ROWS * D;
  float* bl = bm + ROWS;
  // one thread per (row, column)
  for (int idx = threadIdx.x; idx < nr * D; idx += WARPS * 32) {
    const int r = idx / D, d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wm[w * ROWS + r]);
    const float ref = mx == -INFINITY ? 0.f : mx;
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
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
  return bacc;
}

// The end of a unit's split, shared by the decode and the verify kernel,
// from the block's partial in shared memory at bp (acc [ROWS][D], m
// [ROWS], l [ROWS], the first nr rows live, written before a barrier). A
// unit with one live split writes it as the output. Otherwise each live
// split publishes its partial and takes an arrival ticket; the last to
// arrive merges the partials in split order (the loads of all splits in
// flight together), writes the output and resets the ticket to zero for
// the next launch (no memset, no second launch; the same bits on every
// run).
template <typename T, int D, int ROWS, int THREADS = NUM_THREADS, bool PARTIAL = true>
__device__ __forceinline__ void finish_split(const float* bp, int nr, int live, int split,
                                             int nsplit, long long unit, T* o, const Args& a,
                                             int s, int kh, int row0) {
  __shared__ int is_last;
  // floats of one split's partial: acc [ROWS][D], m [ROWS], l [ROWS],
  // padded to whole float4s (the wrappers allocate ROWS * (D + 4))
  constexpr int PART = ROWS * D + (2 * ROWS > 4 ? 2 * ROWS : 4);
  const float* bacc = bp;
  const float* bl = bp + ROWS * D + ROWS;
  auto out = [&](int r, int d) -> T& {
    const int j = row0 + r;
    return o[s * a.o_s + (j / a.R) * a.o_k + (kh * a.R + j % a.R) * a.o_h + d];
  };
  if (live == 1) {   // the unit's only split: its partial is the output
    for (int idx = threadIdx.x; idx < nr * D; idx += THREADS) {
      const int r = idx / D;
      if (!PARTIAL || idx % D < a.Dv)
        out(r, idx % D) = from_float<T>(bacc[idx] / fmaxf(bl[r], 1e-30f));
    }
    DSTT_STAMP(4);
    return;
  }

  // publish the partial; the last split of the unit to arrive merges them
  // all in split order and resets the unit's ticket for the next launch
  float* part = a.part + unit * nsplit * PART;
  for (int idx = threadIdx.x; idx < nr * D; idx += THREADS)
    part[split * PART + idx] = bacc[idx];
  if (threadIdx.x < 2 * ROWS)   // m and l
    part[split * PART + ROWS * D + threadIdx.x] = bacc[ROWS * D + threadIdx.x];
  // the barrier orders every thread's stores before thread 0's ticket,
  // whose release makes them visible to the unit's other splits and whose
  // acquire (with the barrier after it) makes theirs visible here: one
  // round trip, where a fence by every thread and then the atomic took two
  __syncthreads();
  if (threadIdx.x == 0) {
    int old;
    asm volatile("atom.acq_rel.gpu.add.s32 %0, [%1], 1;\n"
                 : "=r"(old) : "l"(a.tickets + unit) : "memory");
    is_last = old == live - 1;
  }
  __syncthreads();
  DSTT_STAMP(3);
  if (!is_last) {
    DSTT_STAMP(4);
    return;
  }
  if constexpr (ROWS * D <= 4 * THREADS) {
    // a few elements a thread (the decode kernel's units): each merges all
    // splits at once
    for (int idx = threadIdx.x; idx < nr * D; idx += THREADS) {
      const int r = idx / D;
      if (PARTIAL && idx % D >= a.Dv) continue;
      float ms[MAX_SPLITS], ls[MAX_SPLITS], av[MAX_SPLITS];
      float mx = -INFINITY;
#pragma unroll
      for (int p = 0; p < MAX_SPLITS; ++p) {
        ms[p] = -INFINITY;
        ls[p] = av[p] = 0.f;
        if (p < live) {
          ms[p] = __ldcg(part + p * PART + ROWS * D + r);
          ls[p] = __ldcg(part + p * PART + ROWS * D + ROWS + r);
          av[p] = __ldcg(part + p * PART + idx);
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
  } else {
    // many (the verify kernel's 16 rows): a float4 of acc a thread, each
    // loading its row's m and l and its float4 of every split at once
    for (int i4 = threadIdx.x; i4 < nr * D / 4; i4 += THREADS) {
      const int r = i4 * 4 / D;
      if (PARTIAL && i4 * 4 % D >= a.Dv) continue;   // Dv is a multiple of 4
      float ms[MAX_SPLITS], ls[MAX_SPLITS];
      float4 av[MAX_SPLITS];
      float mx = -INFINITY;
#pragma unroll
      for (int p = 0; p < MAX_SPLITS; ++p) {
        ms[p] = -INFINITY;
        ls[p] = 0.f;
        av[p] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (p < live) {
          ms[p] = __ldcg(part + p * PART + ROWS * D + r);
          ls[p] = __ldcg(part + p * PART + ROWS * D + ROWS + r);
          av[p] = __ldcg(reinterpret_cast<const float4*>(part + p * PART) + i4);
        }
        mx = fmaxf(mx, ms[p]);
      }
      const float ref = mx == -INFINITY ? 0.f : mx;
      float lt = 0.f, at[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int p = 0; p < MAX_SPLITS; ++p) {
        const float f = __expf(ms[p] - ref);
        lt += ls[p] * f;
        at[0] += av[p].x * f;
        at[1] += av[p].y * f;
        at[2] += av[p].z * f;
        at[3] += av[p].w * f;
      }
      const float lv = fmaxf(lt, 1e-30f);
#pragma unroll
      for (int c = 0; c < 4; ++c) out(r, i4 * 4 % D + c) = from_float<T>(at[c] / lv);
    }
  }
  if (threadIdx.x == 0) a.tickets[unit] = 0;
  DSTT_STAMP(4);
}

// grid (KH * row groups, S, splits); unit = one (slot, kv head, row group)
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
  DSTT_STAMP(0);

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
  if (split >= live) {
    DSTT_STAMP(5);
    return;
  }
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
      const int e0 = (c % CPR) * (16 / (int)sizeof(KV));
      const bool ok = pos < end && e0 < a.Dv;   // zero-filled past the head dim
      const long long off = ok ? pos % a.BS : 0;
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
      if (j < a.nrows && d0 + c * (16 / (int)sizeof(T)) < a.Dv)
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
    if (st == 0) DSTT_STAMP(1);
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
  DSTT_STAMP(2);

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
  // for whichever is larger): the warps' partials (finish_split's layout)
  float* wm = reinterpret_cast<float*>(smem);   // [NUM_WARPS][ROWS]
  float* wl = wm + NUM_WARPS * ROWS;            // [NUM_WARPS][ROWS]
  float* wacc = wl + NUM_WARPS * ROWS;          // [NUM_WARPS][ROWS][D]
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
  const int nr = min(ROWS, a.nrows - row0);   // live rows
  finish_split<T, D, ROWS>(merge_warps<D, ROWS>(wm, nr), nr, live, split, nsplit, unit, o,
                           a, s, kh, row0);
}

// The dense decode (B4; design in the note at the top): one block of 8
// warps per (kv head and row group, batch row, split of the plan).
constexpr int DENSE_WARPS = 8, DENSE_THREADS = DENSE_WARPS * 32;
constexpr int DENSE_UNROLL = 4;   // steps of 16-byte loads in flight a lane

template <typename T, int D, int ROWS>
__global__ void __launch_bounds__(DENSE_THREADS)
decode_dense_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, T* __restrict__ o, Args a) {
  constexpr int VEC1 = 16 / sizeof(T);  // elements per 16-byte load
  // 16-byte loads a lane takes of a key row: a row is at most one warp (2
  // for f32 at D = 256, else 1)
  constexpr int NV = D / VEC1 > 32 ? D / VEC1 / 32 : 1;
  constexpr int VEC = NV * VEC1;        // elements a lane
  constexpr int LPK = D / VEC;          // lanes per key row
  constexpr int KPW = 32 / LPK;         // keys per warp per step
  constexpr int STEP = DENSE_WARPS * KPW;
  extern __shared__ __align__(16) unsigned char smem[];
  const int groups = (a.nrows + ROWS - 1) / ROWS;
  const int kh = blockIdx.x / groups, row0 = (blockIdx.x % groups) * ROWS;
  const int b = blockIdx.y, split = blockIdx.z, nsplit = gridDim.z;
  const long long unit = (long long)b * gridDim.x + blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LPK, d0 = (lane % LPK) * VEC;
  DSTT_STAMP(0);
  const int len = max(0, min(a.lengths[b], a.BS));
  const int live = len > 0 ? (len + a.chunk - 1) / a.chunk : 1;
  if (split >= live) {
    DSTT_STAMP(5);
    return;
  }
  const int beg = split * a.chunk, end = min(beg + a.chunk, len);

  // a lane's load whose columns lie past the head dim takes a zero q and
  // reads the first columns of its key rows (the addresses its row's first
  // lane reads, so no bytes more): its products add 0, and the columns of
  // V it sums are never written
  bool dlive[NV];
  int col[NV];
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    dlive[c] = d0 + c * VEC1 < a.Dv;
    col[c] = dlive[c] ? d0 + c * VEC1 : 0;
  }
  float qv[ROWS][VEC], acc[ROWS][VEC], m[ROWS], l[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int j = min(row0 + r, a.nrows - 1);   // rows past the unit repeat its last
    uint4 raw[NV];
#pragma unroll
    for (int c = 0; c < NV; ++c)
      raw[c] = dlive[c] ? *reinterpret_cast<const uint4*>(q + b * a.q_s + (kh * a.R + j) * a.q_h + col[c])
                        : make_uint4(0, 0, 0, 0);
    const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      qv[r][i] = to_float(e[i]) * a.scale;
      acc[r][i] = 0.f;
    }
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  const T* kb = kc + b * a.k_n + kh * a.k_h;
  const T* vb = vc + b * a.v_n + kh * a.v_h;
  // the loop bound is uniform across the warp, so the shuffles below always
  // run with all 32 lanes; positions past end are masked instead
  for (int base = beg + warp * KPW; base < end; base += STEP * DENSE_UNROLL) {
    uint4 kr[DENSE_UNROLL][NV], vr[DENSE_UNROLL][NV];
#pragma unroll
    for (int u = 0; u < DENSE_UNROLL; ++u) {
      const int pos = base + u * STEP + grp;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        kr[u][c] = vr[u][c] = make_uint4(0, 0, 0, 0);
        if (pos < end) {   // read once: streaming loads, first in line for eviction
          kr[u][c] = __ldcs(reinterpret_cast<const uint4*>(kb + pos * a.k_b + col[c]));
          vr[u][c] = __ldcs(reinterpret_cast<const uint4*>(vb + pos * a.v_b + col[c]));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float sc[DENSE_UNROLL];
#pragma unroll
      for (int u = 0; u < DENSE_UNROLL; ++u) {
        const T* ke = reinterpret_cast<const T*>(&kr[u]);
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) dot = fmaf(qv[r][i], to_float(ke[i]), dot);
#pragma unroll
        for (int off = LPK / 2; off > 0; off /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        sc[u] = base + u * STEP + grp < end ? dot : -INFINITY;
      }
      float mn = m[r];
#pragma unroll
      for (int u = 0; u < DENSE_UNROLL; ++u) mn = fmaxf(mn, sc[u]);
      const float ref = mn == -INFINITY ? 0.f : mn;
      const float alpha = __expf(m[r] - ref);
      l[r] *= alpha;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[r][i] *= alpha;
#pragma unroll
      for (int u = 0; u < DENSE_UNROLL; ++u) {
        const float p = __expf(sc[u] - ref);
        const T* ve = reinterpret_cast<const T*>(&vr[u]);
        l[r] += p;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[r][i] = fmaf(p, to_float(ve[i]), acc[r][i]);
      }
      m[r] = mn;
    }
    if (base == beg + warp * KPW) DSTT_STAMP(1);
  }
  DSTT_STAMP(2);
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
  float* wm = reinterpret_cast<float*>(smem);   // [DENSE_WARPS][ROWS]
  float* wl = wm + DENSE_WARPS * ROWS;          // [DENSE_WARPS][ROWS]
  float* wacc = wl + DENSE_WARPS * ROWS;        // [DENSE_WARPS][ROWS][D]
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
  const int nr = min(ROWS, a.nrows - row0);   // live rows
  if (live == 1) {
    // the unit's only split: merge the warps straight into the output,
    // one thread a (row, column), in warp order
    for (int idx = threadIdx.x; idx < nr * D; idx += DENSE_THREADS) {
      const int r = idx / D, d = idx % D;
      if (d >= a.Dv) continue;
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < DENSE_WARPS; ++w) mx = fmaxf(mx, wm[w * ROWS + r]);
      const float ref = mx == -INFINITY ? 0.f : mx;
      float lt = 0.f, at = 0.f;
#pragma unroll
      for (int w = 0; w < DENSE_WARPS; ++w) {
        const float f = __expf(wm[w * ROWS + r] - ref);
        lt += wl[w * ROWS + r] * f;
        at += wacc[(w * ROWS + r) * D + d] * f;
      }
      o[b * a.o_s + (kh * a.R + row0 + r) * a.o_h + d] = from_float<T>(at / fmaxf(lt, 1e-30f));
    }
    DSTT_STAMP(4);
    return;
  }
  finish_split<T, D, ROWS, DENSE_THREADS>(merge_warps<D, ROWS, DENSE_WARPS>(wm, nr), nr, live,
                                          split, nsplit, unit, o, a, b, kh, row0);
}

template <typename T, int D, int ROWS>
cudaError_t launch_dense(const void* q, const void* k, const void* v, void* o, int B, int KH,
                         int splits, const Args& a, cudaStream_t stream) {
  dim3 grid(KH * ((a.nrows + ROWS - 1) / ROWS), B, splits);
  const int smem = (DENSE_WARPS * ROWS * (D + 2) + ROWS * (D + 2)) * 4;
  static_assert(MAX_SPLITS * ROWS + ROWS <= DENSE_WARPS * ROWS * (D + 2), "merge factors fit");
  if constexpr (D == 256) {   // above 48 KB at 8 rows
    const cudaError_t e = allow_smem<decode_dense_kernel<T, D, ROWS>>(smem);
    if (e != cudaSuccess) return e;
  }
  decode_dense_kernel<T, D, ROWS><<<grid, DENSE_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dense_rows(const void* q, const void* k, const void* v, void* o, int B,
                              int KH, int splits, const Args& a, cudaStream_t stream) {
  if (a.nrows <= 1) return launch_dense<T, D, 1>(q, k, v, o, B, KH, splits, a, stream);
  if (a.nrows <= 2) return launch_dense<T, D, 2>(q, k, v, o, B, KH, splits, a, stream);
  if (a.nrows <= 4) return launch_dense<T, D, 4>(q, k, v, o, B, KH, splits, a, stream);
  return launch_dense<T, D, 8>(q, k, v, o, B, KH, splits, a, stream);
}

template <typename T>
cudaError_t launch_dense_d(int D, const void* q, const void* k, const void* v, void* o, int B,
                           int KH, int splits, const Args& a, cudaStream_t stream) {
  if (D == 64) return launch_dense_rows<T, 64>(q, k, v, o, B, KH, splits, a, stream);
  if (D == 128) return launch_dense_rows<T, 128>(q, k, v, o, B, KH, splits, a, stream);
  if (D == 256) return launch_dense_rows<T, 256>(q, k, v, o, B, KH, splits, a, stream);
  return cudaErrorInvalidValue;
}

// The verify kernel over 16-bit queries (B7, B7i; design in the note at
// the top). grid (KH * row groups, S, splits); 4 warps. PARTIAL: the true
// head dim a.Dv is below D.
template <typename T, typename KV, int D, bool PARTIAL>
__global__ void __launch_bounds__(NUM_THREADS, D == 64 ? 4 : D == 128 ? 2 : 1)   // no spill
paged_verify_mma_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                        const KV* __restrict__ vp, T* __restrict__ o, Args a) {
  using TL = KVTile<KV, D>;
  using CP = TileCopy<KV, D, NUM_THREADS>;
  constexpr bool Q8 = TL::Q8;
  constexpr int CPT = CP::CPT, ROWS = 16;
  // D = 256: q's fragments from a tile in shared memory after the ring
  constexpr bool QS = D > 128;
  using QT = QTile<T, KV, D, ROWS>;
  // P in bf16 terms enough to carry its f32 value: the output is held to
  // the f32 math's (one rounding of it), as the decode kernel's is
  constexpr int NP = std::is_same<T, __nv_bfloat16>::value ? 3 : 1;
  extern __shared__ __align__(16) unsigned char smem[];   // as the split kernel's

  const int split = blockIdx.z, nsplit = gridDim.z;
  const int groups = (a.nrows + ROWS - 1) / ROWS;
  const int kh = blockIdx.x / groups, row0 = (blockIdx.x % groups) * ROWS;
  const int s = blockIdx.y;
  const long long unit = (long long)s * gridDim.x + blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int span = a.MB * a.BS;
  const int* table = a.tables + s * a.t_s;
  const int beg = split * a.chunk;
  const int slots = a.slots;
  DSTT_STAMP(0);

  // table entry of position pos (clamped into the row) and block id
  // (clamped into [0, NB)); the first stages' ids depend on the static
  // range only and load beside the length
  auto block_of = [&](int pos) {
    return min(max(table[min(pos / a.BS, a.MB - 1)], 0), a.NB - 1);
  };
  int pblk[RING][CPT], sblk[RING];
#pragma unroll
  for (int st = 0; st < RING; ++st) {
#pragma unroll
    for (int i = 0; i < CPT; ++i)
      pblk[st][i] = st < slots ? block_of(beg + st * TILE_KEYS + CP::row(i, threadIdx.x)) : 0;
    sblk[st] = Q8 && st < slots ? block_of(beg + st * TILE_KEYS + threadIdx.x % TILE_KEYS) : 0;
  }
  // the A fragments of q as it is, loaded first (ahead of the copies, and
  // not used before them): q.k^T is exact in f32 and the scale multiplies
  // it there. Rows past the unit's repeat its last row; none is written.
  uint32_t qf[QS ? 1 : D / 16][4];
  const int ja = row0 + g, jb = ja + 8;   // this thread's rows
  // (zero past the head dim)
  auto qpair = [&](int j, int d) -> uint32_t {
    j = min(j, a.nrows - 1);
    if (PARTIAL && d >= a.Dv) return 0u;
    return *reinterpret_cast<const uint32_t*>(
        q + s * a.q_s + (j / a.R) * a.q_k + (kh * a.R + j % a.R) * a.q_h + d);
  };
  if constexpr (!QS) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        qf[kk][2 * h] = qpair(ja, TL::qdim(kk, t4, h));
        qf[kk][2 * h + 1] = qpair(jb, TL::qdim(kk, t4, h));
      }
    }
  }
  T* qs = reinterpret_cast<T*>(smem + slots * TL::STAGE);   // QS: the q tile
  auto qa = [&](int kk, uint32_t (&f)[4]) {
    if constexpr (QS) {
      QT::frag(f, qs, 0, kk, lane);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) f[i] = qf[kk][i];
    }
  };

  const int len = a.lengths[s];

  // exclusive bound on the positions row j sees; it grows with j, so the
  // unit's range ends at its last live row's and lo is its first row's
  auto lim_of = [&](int j) { return max(0, min(len + a.extra + j / a.R, span)); };
  const int hi = lim_of(min(row0 + ROWS, a.nrows) - 1), lo = lim_of(row0);
  // splits with keys; split 0 always runs (zeros for a unit that sees none)
  const int live = hi > 0 ? (hi + a.chunk - 1) / a.chunk : 1;
  if (split >= live) {
    DSTT_STAMP(5);
    return;
  }
  const int end = min(beg + a.chunk, hi);
  const int nstages = end > beg ? (end - beg + TILE_KEYS - 1) / TILE_KEYS : 0;
  const int lim_a = ja < a.nrows ? lim_of(ja) : 0, lim_b = jb < a.nrows ? lim_of(jb) : 0;

  const KV* kb = kp + kh * a.k_h;
  const KV* vb = vp + kh * a.v_h;
  auto issue = [&](int st, const int (&blk)[CPT], int sb) {
    unsigned char* stage = smem + (st % slots) * TL::STAGE;
    const int p0 = beg + st * TILE_KEYS;
    CP::template issue<PARTIAL>(stage, kb, vb, blk, p0, end, a.BS, a.k_n, a.k_b, a.v_n, a.v_b,
                                a.Dv, threadIdx.x);
    if constexpr (Q8)
      CP::issue_scales(stage, a.ks + kh * a.ks_h, a.vs + kh * a.vs_h, sb, p0, end, a.BS,
                       a.ks_n, a.vs_n, threadIdx.x);
  };
#pragma unroll
  for (int st = 0; st < RING; ++st) {
    if (st < slots) {
      if (st < nstages) issue(st, pblk[st], sblk[st]);
      cp_async_commit();
    }
  }
  if constexpr (QS) {
    // the q tile, filled while the first stages are in flight; the loop's
    // first barrier makes it visible
    for (int i = threadIdx.x; i < ROWS * D / 2; i += NUM_THREADS) {
      const int r = i / (D / 2), c = 2 * (i % (D / 2));
      *reinterpret_cast<uint32_t*>(qs + r * QT::ROW + c) = qpair(row0 + r, QT::dim_at(c));
    }
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int r0 = warp * 16;   // this warp's tile rows
  for (int st = 0; st < nstages; ++st) {
    cp_async_wait_dyn(slots - 1);
    __syncthreads();   // stage st landed for every thread's copies
    if (st == 0) DSTT_STAMP(1);
    const unsigned char* kt = smem + (st % slots) * TL::STAGE;
    const unsigned char* vt = kt + TL::BYTES;
    const float* sc = reinterpret_cast<const float*>(vt + TL::BYTES);   // int8: K, V scales
    const int p = beg + st * TILE_KEYS + r0;   // position of tile row r0

    float sf[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t) sf[t][0] = sf[t][1] = sf[t][2] = sf[t][3] = 0.f;
    qk_rows16<T, KV, D>(sf, qa, kt, r0, lane);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sf[t][e] *= a.scale;   // S = (scale q) . K^T
        if constexpr (Q8) sf[t][e] *= sc[r0 + s_row<KV, D>(t, e, t4)];   // K = scale_k K_int
      }
    if (p + 16 > lo) {   // some key at or past a row's bound
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (p + s_row<KV, D>(t, e, t4) >= (e < 2 ? lim_a : lim_b)) sf[t][e] = -INFINITY;
    }

    // online softmax of rows g (e 0, 1) and g + 8 (e 2, 3)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      mx[0] = fmaxf(mx[0], fmaxf(sf[t][0], sf[t][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sf[t][2], sf[t][3]));
    }
    float base[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      base[i] = mx[i] == -INFINITY ? 0.f : mx[i];
      alpha[i] = __expf(m[i] - base[i]);
      m[i] = mx[i];
    }
    float pe[2][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pe[t][e] = __expf(sf[t][e] - base[e / 2]);
        rs[e / 2] += pe[t][e];
        if constexpr (Q8) pe[t][e] *= sc[TILE_KEYS + r0 + s_row<KV, D>(t, e, t4)];
      }
    }
    uint32_t pf[NP][4];
    p_frags<T, NP>(pf, pe);
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }
    pv_step<T, KV, D, NP>(acc, pf, vt, r0, lane);
    __syncthreads();   // every warp is done with the slot before it refills
    if (st + slots < nstages) {
      const int nxt = st + slots;
      int nb[CPT];
#pragma unroll
      for (int i = 0; i < CPT; ++i) nb[i] = block_of(beg + nxt * TILE_KEYS + CP::row(i, threadIdx.x));
      issue(nxt, nb, Q8 ? block_of(beg + nxt * TILE_KEYS + threadIdx.x % TILE_KEYS) : 0);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  DSTT_STAMP(2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {   // the row sums over the quad
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }

  // warps 1-3's partials into warp 0's through shared memory, register by
  // register (a lane holds the same rows and dims in every warp; a
  // register's column of 32 lanes is free of bank conflicts), in warp
  // order; the ring is free: every warp passed the loop's last barrier.
  // Then warp 0 writes the block's partial for finish_split.
  constexpr int NR = D / 2 + 4;                  // floats a lane: acc, m, l
  float* x = reinterpret_cast<float*>(smem);     // [NUM_WARPS - 1][NR][32]
  float* bp = x + (NUM_WARPS - 1) * NR * 32;     // acc [16][D], m, l [16]
  if (warp > 0) {
    float* y = x + (warp - 1) * NR * 32;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) y[(4 * j + k) * 32 + lane] = acc[j][k];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      y[(D / 2 + h) * 32 + lane] = m[h];
      y[(D / 2 + 2 + h) * 32 + lane] = l[h];
    }
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll 1
    for (int w = 0; w < NUM_WARPS - 1; ++w) {
      const float* y = x + w * NR * 32;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m1 = y[(D / 2 + h) * 32 + lane], mx = fmaxf(m[h], m1);
        const float ref = mx == -INFINITY ? 0.f : mx;
        const float f0 = __expf(m[h] - ref), f1 = __expf(m1 - ref);
        l[h] = l[h] * f0 + y[(D / 2 + 2 + h) * 32 + lane] * f1;
        m[h] = mx;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            acc[j][2 * h + e] = acc[j][2 * h + e] * f0 + y[(4 * j + 2 * h + e) * 32 + lane] * f1;
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        bp[g * D + TL::dim(j, e, t4)] = acc[j][e];
        bp[(g + 8) * D + TL::dim(j, e, t4)] = acc[j][2 + e];
      }
    if (t4 == 0) {
      bp[ROWS * D + g] = m[0];
      bp[ROWS * D + g + 8] = m[1];
      bp[ROWS * D + ROWS + g] = l[0];
      bp[ROWS * D + ROWS + g + 8] = l[1];
    }
  }
  __syncthreads();
  finish_split<T, D, ROWS, NUM_THREADS, PARTIAL>(bp, min(ROWS, a.nrows - row0), live, split,
                                                 nsplit, unit, o, a, s, kh, row0);
}

template <typename T, typename KV, int D, int ROWS>
cudaError_t launch_split(const void* q, const void* k, const void* v, void* o,
                         int S, int KH, int splits, const Args& a,
                         cudaStream_t stream) {
  dim3 grid(KH * ((a.nrows + ROWS - 1) / ROWS), S, splits);
  const int smem = std::max(Ring<KV, D>::SMEM, (NUM_WARPS * ROWS * (D + 2) + ROWS * (D + 2)) * 4);
  static_assert(MAX_SPLITS * ROWS + ROWS <= NUM_WARPS * ROWS * (D + 2), "merge factors fit");
  paged_split_kernel<T, KV, D, ROWS><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<T*>(o), a);
  return cudaGetLastError();
}

// rows per block: the smallest power of two >= the unit's rows, at most 8
template <typename T, typename KV, int D>
cudaError_t launch_rows(const void* q, const void* k, const void* v, void* o,
                        int S, int KH, int splits, const Args& a,
                        cudaStream_t stream) {
  if (a.nrows <= 1) return launch_split<T, KV, D, 1>(q, k, v, o, S, KH, splits, a, stream);
  if (a.nrows <= 2) return launch_split<T, KV, D, 2>(q, k, v, o, S, KH, splits, a, stream);
  if (a.nrows <= 4) return launch_split<T, KV, D, 4>(q, k, v, o, S, KH, splits, a, stream);
  return launch_split<T, KV, D, 8>(q, k, v, o, S, KH, splits, a, stream);
}

template <typename T, typename KV, int D, bool PARTIAL>
cudaError_t launch_verify_mma(const void* q, const void* k, const void* v, void* o, int S,
                              int KH, int splits, Args a, cudaStream_t stream) {
  using TL = KVTile<KV, D>;
  a.slots = std::min(RING, a.chunk / TILE_KEYS);
  constexpr int ROWS = 16;
  const int merge = ((NUM_WARPS - 1) * (D / 2 + 4) * 32 + ROWS * (D + 2)) * 4;
  const int qtile = D > 128 ? QTile<T, KV, D, ROWS>::BYTES : 0;
  const int smem = std::max(a.slots * TL::STAGE + qtile, merge);
  const cudaError_t e = allow_smem<paged_verify_mma_kernel<T, KV, D, PARTIAL>>(smem);
  if (e != cudaSuccess) return e;
  dim3 grid(KH * ((a.nrows + ROWS - 1) / ROWS), S, splits);
  paged_verify_mma_kernel<T, KV, D, PARTIAL><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<T*>(o), a);
  return cudaGetLastError();
}

template <bool SPLIT, typename T, typename KV>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* o, int S, int KH, int splits, const Args& a,
                     cudaStream_t stream) {
  if constexpr (!SPLIT && !std::is_same<T, float>::value) {
    const bool partial = a.Dv < D;
    if (D == 64)
      return partial ? launch_verify_mma<T, KV, 64, true>(q, k, v, o, S, KH, splits, a, stream)
                     : launch_verify_mma<T, KV, 64, false>(q, k, v, o, S, KH, splits, a, stream);
    if (D == 128)
      return partial ? launch_verify_mma<T, KV, 128, true>(q, k, v, o, S, KH, splits, a, stream)
                     : launch_verify_mma<T, KV, 128, false>(q, k, v, o, S, KH, splits, a, stream);
    if (D == 256)
      return partial ? launch_verify_mma<T, KV, 256, true>(q, k, v, o, S, KH, splits, a, stream)
                     : launch_verify_mma<T, KV, 256, false>(q, k, v, o, S, KH, splits, a, stream);
  } else {
    if (D == 64) return launch_rows<T, KV, 64>(q, k, v, o, S, KH, splits, a, stream);
    if (D == 128) return launch_rows<T, KV, 128>(q, k, v, o, S, KH, splits, a, stream);
    if (D == 256) return launch_rows<T, KV, 256>(q, k, v, o, S, KH, splits, a, stream);
  }
  return cudaErrorInvalidValue;
}

// SPLIT: the decode kernel, else the verify kernel (whose f32 queries run
// the decode kernel's split kernel, in units of <= 8 rows). The plan of
// either must cover the key range: 1 <= splits <= 16, splits * chunk >=
// MB*BS, and for the verify kernel chunk a multiple of 64. Q8: int8 pools
// (with a.ks / a.vs); else the pools have q's dtype.
template <bool SPLIT, bool Q8>
int dispatch(int dtype, int D, const void* q, const void* k, const void* v,
             void* o, int S, int KH, int splits, const Args& a, void* stream) {
  if (splits < 1 || splits > MAX_SPLITS || a.chunk < 1 ||
      (long long)splits * a.chunk < (long long)a.MB * a.BS ||
      (!SPLIT && a.chunk % TILE_KEYS))
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
               void* part, int Dv, int NB, int BS, int MB, int chunk, int R, int nrows, int extra,
               long long q_s,
               long long q_k, long long q_h, long long k_n, long long k_b,
               long long k_h, long long v_n, long long v_b, long long v_h,
               long long t_s, long long o_s, long long o_k, long long o_h,
               float scale) {
  Args a{};
  a.tables = static_cast<const int*>(tables);
  a.lengths = static_cast<const int*>(lengths);
  a.tickets = static_cast<int*>(tickets);
  a.part = static_cast<float*>(part);
  a.Dv = Dv; a.NB = NB; a.BS = BS; a.MB = MB; a.chunk = chunk;
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

// dtype: 0 float32, 1 float16, 2 bfloat16. D is the kernel width (64, 128
// or 256), Dv the true head dim (1 <= Dv <= D, rows of Dv elements of q and
// of the pools whole 16-byte chunks); the shapes below are of width Dv, the
// scratch of width D. Strides are in elements, the
// head dim contiguous. q and o [S, H, D]; pools [NB, BS, KH, D] by
// (k_n, k_b, k_h); tables [S, MB] int32 with row stride t_s; lengths [S]
// int32; all on the device. The plan: each key range [0, MB*BS) in
// `splits` (1..16) ranges of `chunk` keys, splits * chunk >= MB*BS. Its
// scratch: tickets, int32 [S * KH * row groups], all zero (the kernel
// leaves them zero), and part, f32 [S * KH * row groups * splits * rows *
// (D + 4)] (rows: the smallest power of two >= H/KH, at most 8; row
// groups: ceil(H/KH / 8)). Launches that share a scratch must run in order
// (one stream).
extern "C" int dstt_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* tables,
    const void* lengths, void* o, void* tickets, void* part, int S, int H,
    int KH, int D, int Dv, int NB, int BS, int MB, int splits, int chunk,
    long long q_s, long long q_h, long long k_n, long long k_b, long long k_h,
    long long v_n, long long v_b, long long v_h, long long t_s, long long o_s,
    long long o_h, float scale, int dtype, void* stream) {
  if (S <= 0 || KH <= 0 || H % KH || NB <= 0 || BS <= 0 || MB <= 0 ||
      Dv < 1 || Dv > D)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(tables, lengths, tickets, part, Dv, NB, BS, MB, chunk, H / KH, H / KH, 0,
                           q_s, 0, q_h, k_n, k_b, k_h, v_n, v_b, v_h, t_s, o_s, 0, o_h, scale);
  return dispatch<true, false>(dtype, D, q, k, v, o, S, KH, splits, a, stream);
}

// The dense decode (B4): q and o [B, H, D] by (q_b, q_h) and (o_b, o_h);
// caches [B, S, KH, D] by (k_b, k_s, k_h) and (v_b, v_s, v_h); lengths [B]
// int32, clamped into [0, S]; all on the device, the head dim contiguous.
// The plan: each key range [0, S) in `splits` (1..16) ranges of `chunk`
// keys, splits * chunk >= S. Its scratch: tickets, int32 [B * KH * row
// groups], all zero (the kernel leaves them zero), and part, f32 [B * KH *
// row groups * splits * rows * (D + 4)] (rows: the smallest power of two
// >= H/KH, at most 8, at most 4 at D = 128; row groups: ceil(H/KH / that
// cap)). Launches that share a scratch must run in order.
extern "C" int dstt_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths, void* o,
    void* tickets, void* part, int B, int S, int H, int KH, int D, int Dv, int splits,
    int chunk, long long q_b, long long q_h, long long k_b, long long k_s,
    long long k_h, long long v_b, long long v_s, long long v_h, long long o_b,
    long long o_h, float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || H % KH || splits < 1 || splits > MAX_SPLITS || chunk < 1 ||
      (long long)splits * chunk < S || Dv < 1 || Dv > D)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(nullptr, lengths, tickets, part, Dv, B, S, 1, chunk, H / KH, H / KH, 0,
                           q_b, 0, q_h, k_b, k_s, k_h, v_b, v_s, v_h, 0, o_b, 0, o_h, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_dense_d<float>(D, q, k, v, o, B, KH, splits, a, st);
    case 1: return (int)launch_dense_d<__half>(D, q, k, v, o, B, KH, splits, a, st);
    case 2: return (int)launch_dense_d<__nv_bfloat16>(D, q, k, v, o, B, KH, splits, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As above with q and o [S, K, H, D] by (q_s, q_k, q_h) and (o_s, o_k, o_h),
// the units (slot, kv head, group of <= 16 of the K * H/KH query rows) and
// the plan chunk a multiple of 64: tickets int32 [S * KH * groups], part
// f32 [S * KH * groups * splits * 16 * (D + 4)]. f32 queries take units of
// <= 8 rows (the decode kernel's): tickets int32 [S * KH * ceil(K * H/KH /
// 8)] (part as above suffices).
extern "C" int dstt_paged_verify_attention(
    const void* q, const void* k, const void* v, const void* tables,
    const void* lengths, void* o, void* tickets, void* part, int S, int K,
    int H, int KH, int D, int Dv, int NB, int BS, int MB, int splits, int chunk,
    long long q_s, long long q_k, long long q_h, long long k_n, long long k_b,
    long long k_h, long long v_n, long long v_b, long long v_h, long long t_s,
    long long o_s, long long o_k, long long o_h, float scale, int dtype,
    void* stream) {
  if (S <= 0 || K <= 0 || KH <= 0 || H % KH || NB <= 0 || BS <= 0 || MB <= 0 ||
      Dv < 1 || Dv > D)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(tables, lengths, tickets, part, Dv, NB, BS, MB, chunk, H / KH, K * (H / KH), 1,
                           q_s, q_k, q_h, k_n, k_b, k_h, v_n, v_b, v_h, t_s, o_s, o_k, o_h, scale);
  return dispatch<false, false>(dtype, D, q, k, v, o, S, KH, splits, a, stream);
}

// int8 pools: k, v int8 [NB, BS, KH, D]; ks, vs f32 scale tiles [NB, KH, BS]
// by (ks_n, ks_h), the block dim contiguous. dtype is q's and o's.
extern "C" int dstt_paged_decode_attention_int8(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* tables, const void* lengths, void* o,
    void* tickets, void* part, int S, int H, int KH, int D, int Dv, int NB, int BS,
    int MB, int splits, int chunk, long long q_s, long long q_h, long long k_n,
    long long k_b, long long k_h, long long v_n, long long v_b, long long v_h,
    long long ks_n, long long ks_h, long long vs_n, long long vs_h,
    long long t_s, long long o_s, long long o_h, float scale, int dtype,
    void* stream) {
  if (S <= 0 || KH <= 0 || H % KH || NB <= 0 || BS <= 0 || MB <= 0 ||
      Dv < 1 || Dv > D)
    return (int)cudaErrorInvalidValue;
  Args a = make_args(tables, lengths, tickets, part, Dv, NB, BS, MB, chunk, H / KH, H / KH, 0,
                     q_s, 0, q_h, k_n, k_b, k_h, v_n, v_b, v_h, t_s, o_s, 0, o_h, scale);
  set_scales(a, ks, vs, ks_n, ks_h, vs_n, vs_h);
  return dispatch<true, true>(dtype, D, q, k, v, o, S, KH, splits, a, stream);
}

extern "C" int dstt_paged_verify_attention_int8(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* tables, const void* lengths, void* o,
    void* tickets, void* part, int S, int K, int H, int KH, int D, int Dv, int NB,
    int BS, int MB, int splits, int chunk, long long q_s, long long q_k,
    long long q_h, long long k_n, long long k_b, long long k_h, long long v_n,
    long long v_b, long long v_h, long long ks_n, long long ks_h,
    long long vs_n, long long vs_h, long long t_s, long long o_s,
    long long o_k, long long o_h, float scale, int dtype, void* stream) {
  if (S <= 0 || K <= 0 || KH <= 0 || H % KH || NB <= 0 || BS <= 0 || MB <= 0 ||
      Dv < 1 || Dv > D)
    return (int)cudaErrorInvalidValue;
  Args a = make_args(tables, lengths, tickets, part, Dv, NB, BS, MB, chunk, H / KH, K * (H / KH), 1,
                     q_s, q_k, q_h, k_n, k_b, k_h, v_n, v_b, v_h, t_s, o_s, o_k, o_h, scale);
  set_scales(a, ks, vs, ks_n, ks_h, vs_n, vs_h);
  return dispatch<false, true>(dtype, D, q, k, v, o, S, KH, splits, a, stream);
}

extern "C" const char* dstt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
