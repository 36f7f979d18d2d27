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
// 4.B.D.block^2 operations of the listed blocks take longer than the bytes
// of q, k, v and o (989 TFLOP/s, 3.35 TB/s); every K/V block is read by
// several query blocks, so its bytes come from L2 after the first read.
// Only wgmma reaches the tensor cores' rate.
//
// Design for 16-bit inputs at blocks of 64 and 128 (`bsa_wgmma_kernel`, on
// the TMA/wgmma/mbarrier helpers of hopper.cuh, as flash_attention_fwd.cu):
//  * persistent: one block per SM takes tiles (query block, head, batch
//    row) from a counter in global memory, the tiles of 8 heads of a batch
//    row at a time (their K/V stay in L2), in the order the host gives
//    (`tile_order` in the wrapper: the heaviest tile, most visible LUT
//    entries, first) or else query blocks from the last. The fetch that
//    finds the counter past its end for the last time resets it to 0 for
//    the next launch (no memset).
//  * A block is a producer warpgroup and two consumer warpgroups of 64
//    query rows each; setmaxnreg moves registers from the producer (56) to
//    the consumers (224). At block 128 both consumers share one tile, its
//    q block and its LUT row: one pipeline. At block 64 a tile has only
//    64 rows, and the two consumers run two tiles at once, each with its
//    own producer warp, q buffer, K/V rings and barriers: two
//    pipelines that share nothing but the SM. Splitting one tile's keys
//    between them instead would merge two (m, l, O) through shared memory
//    on every tile, in a fixed order, and would leave the second
//    consumer idle on the tiles with a single visible entry.
//  * A pipeline's producer warp reads the tile's LUT row 32 entries at a
//    time (entries past the count, out of [0, nb) or above the diagonal
//    are never loaded); its lane 0 publishes the tile and its number of
//    visible entries with q's TMA load, then issues TMA loads of the
//    listed K and V blocks into two
//    rings of 3 slots (4 at D = 64), each slot with a full and an empty
//    mbarrier; K runs one entry ahead of V, as the consumers use them, and
//    each slot carries its block index for the diagonal test. The tensor
//    maps are 4-D over (D, heads, T, B) built from the strides, so [B, T,
//    H, D] views of a fused projection need no copy; they are cached on the
//    host by (address, shape, strides), not encoded per call.
//  * Consumers: S = Q.K^T by wgmma m64n64k16 (block 64) or m64n128k16
//    (block 128), both operands K-major in shared memory; the online
//    softmax on the f32 accumulator in registers (exp2 of S times scale
//    times log2(e)); P packed to 16 bits as the register A operand of
//    O += P.V by wgmma, V read MN-major. Q.K^T of entry j and P.V of entry
//    j - 1 are issued together, and the softmax of j runs while P.V of
//    j - 1 runs on the tensor cores. Only the diagonal block pays for the
//    causal mask.
//  * Epilogue: O times 1 / l (or 0 for a row that saw no key), rounded,
//    stored from registers through the output's strides as streaming
//    stores. The q buffer is released as soon as it is read (block 64: q's
//    A fragments go to registers, so Q.K^T reads only K from shared
//    memory) or once the last Q.K^T is done (block 128), so the next
//    tile's q lands under this one's products and stores.
//  * The same bits on every run: a tile's entries are summed in LUT order
//    by one warpgroup, whichever block takes it.
// Blocks of 16 and 32 (`bsa_mma_kernel`: wgmma needs 64 rows) keep the
// first design: one block of BLOCK/16 warps per (query block, head, batch
// row), listed K/V blocks through a 2-deep cp.async buffer, products on
// mma.sync.m16n8k16, P from registers. float32 inputs take a plain FMA
// kernel: one warp per query row.
// At D = 256 a K or V block of 128 keys is 64 KB and O holds 128 registers
// a thread: `bsa_wgmma_kernel` then streams each listed block through its
// rings as tiles of 32 keys (2 a block of 64, 4 a block of 128; at 64-key
// tiles S and P beside O spill), reads q from shared memory for Q.K^T
// (m64n32k16) and runs P.V as two m64n128k16, one per 128-column half of
// V: block 64 keeps its two pipelines (2 x 96 KB, 2-slot rings), block 128
// its one (192 KB, 4-slot rings). `bsa_mma_kernel` at
// 256 reads q's fragments from its resident q block where it uses them.
// Head dims: the kernels are instantiated at DK = 64, 128 and 256 and take
// any true head dim Dv <= DK whose rows are whole 16-byte chunks. The tensor
// maps are encoded with Dv as their innermost extent (TMA reads zeros past
// it), the cp.async and pointer loads zero-fill past it, and every store
// stops at Dv; zero columns change neither q.k nor P.V.
//
// C interface (nvcc -shared, loaded with ctypes): the launch returns
// cudaGetLastError() so the Python wrapper can raise.

#include <mutex>

#include "attention_common.cuh"
#include "hopper.cuh"

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

// blocks of 16 and 32: one block of BLOCK/16 warps per (query block, head,
// batch row), each warp 16 query rows
template <typename T, int D, int BLOCK>
__global__ void __launch_bounds__(BLOCK * 2)
bsa_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               const int* __restrict__ lut, const int* __restrict__ counts,
               int nb, int max_active, int Dv, Strides st, float scale, int causal) {
  constexpr int NUM_THREADS = BLOCK * 2;   // BLOCK / 16 warps
  static_assert(BLOCK <= 32, "blocks of 64 and 128 take bsa_wgmma_kernel");
  constexpr int KN = BLOCK;                // keys per softmax step
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
  DSTT_STAMP(0);

  auto load_kv = [&](int kb, int buf) {
    T* dK = sK + buf * BLOCK * LD;
    T* dV = sV + buf * BLOCK * LD;
    const T* ks = kbase + (long long)kb * BLOCK * st.k_t;
    const T* vs = vbase + (long long)kb * BLOCK * st.v_t;
    for (int c = tid; c < BLOCK * CHUNKS; c += NUM_THREADS) {
      const int r = c / CHUNKS, col = (c % CHUNKS) * VEC;
      const bool ok = col < Dv;   // zero-filled past the head dim
      cp_async16(dK + r * LD + col, ks + (long long)r * st.k_t + (ok ? col : 0), ok);
      cp_async16(dV + r * LD + col, vs + (long long)r * st.v_t + (ok ? col : 0), ok);
    }
    cp_async_commit();
  };

  int j = next_entry(lrow, 0, count, nb, qb, causal);
  const int j0 = j;
  if (j < count) load_kv(__ldg(lrow + j), 0);

  for (int c = tid; c < BLOCK * CHUNKS; c += NUM_THREADS) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * VEC;
    *reinterpret_cast<uint4*>(sQ + r * LD + col) =
        col < Dv ? *reinterpret_cast<const uint4*>(qp + (long long)r * st.q_t + col)
                 : make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  const int wr = warp * 16;
  // q's A fragments, held in registers below D = 256; at 256 (64 registers
  // beside O's 128) each is read from the resident q block where it is used
  constexpr bool QF_REGS = D < 256;
  auto q_frag = [&](uint32_t (&f)[4], int kk) {
    ldmatrix_x4(f, sQ + (wr + (lane % 8) + ((lane / 8) % 2) * 8) * LD + kk * 16 + (lane / 16) * 8);
  };
  uint32_t qf[QF_REGS ? D / 16 : 1][4];
  if constexpr (QF_REGS) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) q_frag(qf[kk], kk);
  }

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
    if (j == j0) DSTT_STAMP(1);
    const T* cK = sK + buf * BLOCK * LD;
    const T* cV = sV + buf * BLOCK * LD;
    const bool diag = causal && kb == qb;

#pragma unroll
    {
      constexpr int n0 = 0;   // the whole block in one softmax step

      // S = Q . K^T over KN keys, 16 x KN per warp, then times the scale
      float s[KN / 8][4];
#pragma unroll
      for (int i = 0; i < KN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        auto qk_slice = [&](const uint32_t (&a)[4]) {
#pragma unroll
          for (int np = 0; np < KN / 16; ++np) {
            uint32_t bf[4];
            ldmatrix_x4(bf, cK + (n0 + np * 16 + (lane / 16) * 8 + (lane % 8)) * LD + kk * 16 + ((lane / 8) % 2) * 8);
            mma16816<T>(s[2 * np], a, bf);
            mma16816<T>(s[2 * np + 1], a, bf + 2);
          }
        };
        if constexpr (QF_REGS) {
          qk_slice(qf[kk]);
        } else {
          uint32_t a[4];
          q_frag(a, kk);
          qk_slice(a);
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
  DSTT_STAMP(2);

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
    if (d >= Dv) continue;
    *reinterpret_cast<uint32_t*>(ob + (long long)row_a * st.o_t + d) =
        pack2<T>(acc[i][0] * inv_a, acc[i][1] * inv_a);
    *reinterpret_cast<uint32_t*>(ob + (long long)row_b * st.o_t + d) =
        pack2<T>(acc[i][2] * inv_b, acc[i][3] * inv_b);
  }
  DSTT_STAMP(4);
}

// ------------------------------------------- blocks of 64 and 128: TMA + wgmma

constexpr int WG_THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int HEAD_GROUP = 8;   // heads of one batch row whose tiles go together

// 2^x, one MUFU instruction (subnormal results flush to 0, far below a
// 16-bit P's resolution)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D, int BLOCK> struct SparseTiles {
  static constexpr int CONSUMERS = 2;                 // warpgroups of 64 q rows
  static constexpr int NC = BLOCK / 64;               // consumers a tile
  static constexpr int PIPES = CONSUMERS / NC;        // tiles in flight
  static constexpr int THREADS = (CONSUMERS + 1) * WG_THREADS;   // the producer's last
  // registers a thread after setmaxnreg: 56 + 2 x 224 fits the 512 a lane
  // of four warps (the producer warp walks the LUT row with its lanes)
  static constexpr int PRODUCER_REGS = 56;
  static constexpr int CONSUMER_REGS = 224;
  static constexpr int HALVES = D / 64;               // 64-column boxes a row
  // keys a ring tile: a whole block below D = 256; at 256 32 keys (a
  // block of 128 is 64 KB of K or V, and S and P of 64 keys beside O's 128
  // registers spill at setmaxnreg's 224), so the two pipelines at block 64
  // fit two-slot rings beside their q tiles (2 x 96 KB) and the one at 128
  // a four-slot ring (192 KB)
  static constexpr int KN = D == 256 ? 32 : BLOCK;
  static constexpr int SUB = BLOCK / KN;              // ring tiles a listed block
  static constexpr int STAGES =
      D == 64 ? 4 : D == 256 ? (BLOCK == 128 ? 4 : 2) : 3;   // slots of the K and V rings
  // block 64 below D = 256: q's A fragments in registers (at 256 they would
  // take 64 registers beside O's 128, so Q.K^T reads q from shared memory)
  static constexpr bool Q_REGS = BLOCK == 64 && D < 256;
  static constexpr int Q_HALF = BLOCK * 128;          // bytes of one box of a q tile
  static constexpr int KV_HALF = KN * 128;            // bytes of one box of a K or V tile
  static constexpr int Q_BYTES = HALVES * Q_HALF;
  static constexpr int KV_BYTES = HALVES * KV_HALF;
  static constexpr int PIPE_BYTES = Q_BYTES + 2 * STAGES * KV_BYTES;
  // per pipeline: full and empty of q, then full and empty of K and V a slot
  static constexpr int BARS = 2 + 4 * STAGES;
  // bytes a pipeline after the tiles: barriers, tile info (4 ints), the
  // ring tile of each slot (block index x SUB + its half); a multiple of 8
  // (the next one's barriers)
  static constexpr int META = (8 * BARS + 16 + 4 * STAGES + 7) / 8 * 8;
  // pipelines' tiles | pipelines' META | room to align
  static constexpr int SMEM = PIPES * PIPE_BYTES + PIPES * META + 1024;
  static_assert(SMEM <= 227 * 1024, "shared memory");
};

template <typename T, int D, int BLOCK>
__global__ void __launch_bounds__(SparseTiles<D, BLOCK>::THREADS, 1)
bsa_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, T* __restrict__ o,
                 const int* __restrict__ lut, const int* __restrict__ counts,
                 const int* __restrict__ order, int* __restrict__ next_tile, int B, int H,
                 int nb, int max_active, int Dv, long long o_b, long long o_h, long long o_t,
                 float scale, int causal) {
  using L = SparseTiles<D, BLOCK>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: boxes start on that grid
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int wg = threadIdx.x / WG_THREADS;
  // this thread's pipeline: a consumer's, or the producer warp's (warp p
  // of the producer warpgroup serves pipeline p)
  const int pipe = wg < L::CONSUMERS ? wg / L::NC : (threadIdx.x / 32) % 4;
  const uint32_t base_addr = smem_u32(smem) + pipe * L::PIPE_BYTES;
  const uint32_t sQ = base_addr;
  const uint32_t sK = sQ + L::Q_BYTES;
  const uint32_t sV = sK + L::STAGES * L::KV_BYTES;
  unsigned char* meta = smem + L::PIPES * L::PIPE_BYTES + pipe * L::META;
  const uint32_t bars = smem_u32(meta);
  volatile int* info = reinterpret_cast<volatile int*>(meta + 8 * L::BARS);   // i, h nb + qb, b, entries
  volatile int* slot_kb = info + 4;                                          // block index a slot
  const uint32_t full_q = bars, empty_q = bars + 8;
  // visible entry j (counted over every tile the pipeline takes) sits in
  // slot j % STAGES of both rings, in phase (j / STAGES) & 1
  auto slot = [](int j) { return j % L::STAGES; };
  auto parity = [](int j) { return (uint32_t)(j / L::STAGES) & 1; };
  auto full_k = [&](int j) { return bars + 8 * (2 + slot(j)); };
  auto full_v = [&](int j) { return bars + 8 * (2 + L::STAGES + slot(j)); };
  auto empty_k = [&](int j) { return bars + 8 * (2 + 2 * L::STAGES + slot(j)); };
  auto empty_v = [&](int j) { return bars + 8 * (2 + 3 * L::STAGES + slot(j)); };
  const int n_tiles = nb * H * B;
  DSTT_STAMP(0);

  if (threadIdx.x < L::PIPES) {   // thread p sets up pipeline p's barriers
    const uint32_t b0 = smem_u32(smem + L::PIPES * L::PIPE_BYTES + threadIdx.x * L::META);
    mbar_init(b0, 1);                      // full q
    mbar_init(b0 + 8, 4 * L::NC);          // empty q: lane 0 of each consumer warp
    for (int j = 0; j < L::STAGES; ++j) {
      mbar_init(b0 + 8 * (2 + j), 1);
      mbar_init(b0 + 8 * (2 + L::STAGES + j), 1);
      mbar_init(b0 + 8 * (2 + 2 * L::STAGES + j), 4 * L::NC);
      mbar_init(b0 + 8 * (2 + 3 * L::STAGES + j), 4 * L::NC);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == L::CONSUMERS) {
    // ---- producer: warp p of the producer warpgroup runs pipeline p. Its
    // lanes read the LUT row 32 entries at a time (one round trip, not
    // one per entry); lane 0 takes tiles and issues every copy.
    setmaxnreg_dec<L::PRODUCER_REGS>();
    if ((threadIdx.x / 32) % 4 < L::PIPES) {
      const int lane = threadIdx.x % 32;
      const int fetchers = gridDim.x * L::PIPES;
      // tile i (from the counter): batch row, group of HEAD_GROUP heads,
      // then within the group the host's order or query blocks from the
      // last; its LUT row, count and visible entries
      int i, b, hq, count, n_vis;
      auto visible = [&](int kb) { return kb >= 0 && kb < nb && !(causal && kb > hq % nb); };
      // entry j0 + lane of the row, and the warp's mask of visible ones
      auto entry = [&](int j0, int& kb) {
        kb = j0 + lane < count ? __ldg(lut + (long long)hq * max_active + j0 + lane) : -1;
        return __ballot_sync(0xffffffffu, visible(kb));
      };
      auto fetch = [&]() {
        i = 0;
        if (lane == 0) {
          i = atomicAdd(next_tile, 1);
          // the last fetch of all (every pipeline's first past the end)
          // resets the counter for the next launch
          if (i == n_tiles + fetchers - 1) *next_tile = 0;
        }
        i = __shfl_sync(0xffffffffu, i, 0);
        if (i >= n_tiles) return;
        b = i / (H * nb);
        const int r = i % (H * nb);
        const int first = r / (HEAD_GROUP * nb) * HEAD_GROUP;
        const int size = min(HEAD_GROUP, H - first);
        const int w = r - first * nb;
        hq = order != nullptr ? __ldg(order + r) : (first + w % size) * nb + (nb - 1 - w / size);
        count = min(__ldg(counts + hq), max_active);
        n_vis = 0;
        for (int j0 = 0; j0 < count; j0 += 32) {
          int kb;
          n_vis += __popc(entry(j0, kb));
        }
      };
      int base = 0;
      fetch();
      for (int u = 0;; ++u) {
        // the q buffer is free once the last Q.K^T of tile u - 1 is done
        if (lane == 0) mbar_wait(empty_q, (u & 1) ^ 1);
        __syncwarp();
        if (i >= n_tiles) {
          if (lane == 0) {
            info[0] = -1;
            mbar_arrive(full_q);
          }
          break;
        }
        const int h = hq / nb, qb = hq % nb;
        if (lane == 0) {
          info[0] = i;
          info[1] = hq;
          info[2] = b;
          info[3] = n_vis;
          if (n_vis == 0) {
            mbar_arrive(full_q);   // rows that see no key: the consumers write zeros
          } else {
            mbar_expect_tx(full_q, L::Q_BYTES);
            for (int c = 0; c < L::NC; ++c)
              for (int hf = 0; hf < L::HALVES; ++hf)
                tma_load_4d(sQ + hf * L::Q_HALF + c * 64 * 128, &tm_q, full_q, hf * 64, h,
                            qb * BLOCK + 64 * c, b);
          }
        }
        // ring tile j (tile t of the keys: block t / SUB, its part t % SUB)
        // of one ring, once its slot's previous tile is released
        auto load = [&](const CUtensorMap* map, uint32_t ring, bool is_k, int j, int t) {
          const int jg = base + j;
          mbar_wait(is_k ? empty_k(jg) : empty_v(jg), parity(jg) ^ 1);
          if (is_k) slot_kb[slot(jg)] = t;   // published by the arrival below
          const uint32_t full = is_k ? full_k(jg) : full_v(jg);
          mbar_expect_tx(full, L::KV_BYTES);
          for (int hf = 0; hf < L::HALVES; ++hf)
            tma_load_4d(ring + slot(jg) * L::KV_BYTES + hf * L::KV_HALF, map, full, hf * 64, h,
                        t * L::KN, b);
        };
        // K runs one tile ahead of V, in the order the consumers take them
        int v = 0, prev = 0;
        for (int j0 = 0; j0 < count; j0 += 32) {
          int kb;
          for (unsigned m = entry(j0, kb); m; m &= m - 1) {
            const int e = __shfl_sync(0xffffffffu, kb, __ffs(m) - 1);
#pragma unroll
            for (int sb = 0; sb < L::SUB; ++sb) {
              const int t = e * L::SUB + sb;
              if (lane == 0) {
                load(&tm_k, sK, true, v, t);
                if (v > 0) load(&tm_v, sV, false, v - 1, prev);
              }
              prev = t;
              ++v;
            }
          }
        }
        if (lane == 0 && n_vis > 0) load(&tm_v, sV, false, n_vis * L::SUB - 1, prev);
        base += n_vis * L::SUB;
        // the next tile and its LUT row, read while this one is multiplied
        fetch();
      }
    }
  } else {
    // ---- consumers: 64 q rows each
    setmaxnreg_inc<L::CONSUMER_REGS>();
    const int tid = threadIdx.x % WG_THREADS, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int r0 = (wg % L::NC) * 64;   // first row of this warpgroup in a tile
    const float sl2 = scale * LOG2E;
    auto arrive = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
    };
    constexpr int KN = L::KN;
    float acc[D / 2];
    float m_r[2], l_r[2];   // running row max (of S times scale times log2(e)); partial sums
    float s[KN / 2];        // S of ring tile j, then its P in f32
    uint32_t pf[KN / 16][4];   // P of ring tile j - 1: the A fragment of each 16 keys
    uint32_t qf[L::Q_REGS ? D / 16 : 1][4];   // q's A fragments (Q_REGS)
    float alpha[2];
    int base = 0;
    for (int u = 0;; ++u) {
      mbar_wait(full_q, u & 1);
      const int i = info[0];
      if (i < 0) break;
      const int hq = info[1], b = info[2], n_vis = info[3];
      const int h = hq / nb, qb = hq % nb;
      // accumulator layout of m64nN: element 4i + e of a thread sits at
      // row 16 warp + g (+8 for e >= 2), column 8i + 2 t4 + (e & 1)
      const int ra = r0 + warp * 16 + g, rb = ra + 8;   // rows within the q block
#pragma unroll
      for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
      m_r[0] = m_r[1] = -INFINITY;
      l_r[0] = l_r[1] = 0.f;
      if (n_vis > 0) {
        const uint32_t my_q = sQ + r0 * 128;   // its rows in each box
        // block 64: q's A fragments in registers (ldmatrix from the
        // swizzled tile), and the q buffer released at once, so the next
        // tile's q lands while this one runs and Q.K^T reads only K from
        // shared memory (m64n64k16 with both operands there would take all
        // of its bandwidth)
        if constexpr (L::Q_REGS) {
          const unsigned char* qs = smem + pipe * L::PIPE_BYTES + r0 * 128;
          const int row = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const int c = (kk % 4) * 2 + lane / 16;   // 16-byte chunk of the row
            ldmatrix_x4(qf[kk], qs + (kk / 4) * L::Q_HALF + row * 128 + ((c ^ (row % 8)) * 16));
          }
          arrive(empty_q);
        }
        // S = Q . K^T, 64 x KN: K K-major in shared memory (q too unless
        // Q_REGS: m64n128k16 at block 128, m64n32k16 at D = 256); slice kk
        // of 16 columns is 32 bytes into the rows of box kk / 4
        auto issue_qk = [&](int jg) {
          const uint32_t kt = sK + slot(jg) * L::KV_BYTES;
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint64_t db = wgmma_desc(kt + (kk / 4) * L::KV_HALF + (kk % 4) * 32, 16, 1024);
            if constexpr (L::Q_REGS) {
              WgmmaRS<T, 64, 0>::run(s, qf[kk], db, kk > 0);
            } else {
              const uint64_t da = wgmma_desc(my_q + (kk / 4) * L::Q_HALF + (kk % 4) * 32, 16, 1024);
              if constexpr (KN == 128) {
                wgmma_ss_m64n128k16<T, 0, 0>(s, da, db, kk > 0);
              } else {   // 32 keys at D = 256
                if (kk == 0) wgmma_ss_m64n32k16<T, 0, 0, true>(s, da, db);
                else wgmma_ss_m64n32k16<T, 0, 0>(s, da, db);
              }
            }
          }
          wgmma_commit();
        };
        // O += P . V: V is MN-major (D contiguous); slice kk of 16 keys is
        // 16 rows = 2048 bytes on, the next 64-column box KV_HALF bytes on.
        // At D = 256, O's 128-column halves (V's boxes 0-1 and 2-3) are each
        // the accumulator of one m64n128k16 (registers 4i + e of the m64n256
        // layout, column 8i + 2 t4 + (e & 1), are the same)
        auto issue_pv = [&](int jg) {
          const uint32_t vt = sV + slot(jg) * L::KV_BYTES;
#pragma unroll
          for (int kk = 0; kk < KN / 16; ++kk) {
            if constexpr (D == 256) {
              float(&o_lo)[64] = *reinterpret_cast<float(*)[64]>(acc);
              float(&o_hi)[64] = *reinterpret_cast<float(*)[64]>(acc + 64);
              WgmmaRS<T, 128, 1>::run(o_lo, pf[kk], wgmma_desc(vt + kk * 2048, L::KV_HALF, 1024), 1);
              WgmmaRS<T, 128, 1>::run(o_hi, pf[kk],
                                      wgmma_desc(vt + 2 * L::KV_HALF + kk * 2048, L::KV_HALF, 1024), 1);
            } else {
              WgmmaRS<T, D, 1>::run(acc, pf[kk], wgmma_desc(vt + kk * 2048, L::KV_HALF, 1024), 1);
            }
          }
          wgmma_commit();
        };
        // scale, diagonal mask, new running max, rescale factor alpha,
        // S -> P in place, l
        auto softmax = [&](int jg) {
          const int t = slot_kb[slot(jg)];   // block t / SUB, keys from (t % SUB) KN
          if (causal && t / L::SUB == qb) {
            const int c0 = (t % L::SUB) * KN;
#pragma unroll
            for (int nt = 0; nt < KN / 8; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (c0 + nt * 8 + 2 * t4 + (e & 1) > (e < 2 ? ra : rb)) s[nt * 4 + e] = -INFINITY;
          }
          float rm[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int nt = 0; nt < KN / 8; ++nt) {
            rm[0] = fmaxf(rm[0], fmaxf(s[nt * 4], s[nt * 4 + 1]));
            rm[1] = fmaxf(rm[1], fmaxf(s[nt * 4 + 2], s[nt * 4 + 3]));
          }
          float bias[2], rs[2] = {0.f, 0.f};
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            rm[x] = fmaxf(rm[x], __shfl_xor_sync(0xffffffffu, rm[x], 1));
            rm[x] = fmaxf(rm[x], __shfl_xor_sync(0xffffffffu, rm[x], 2));
            const float mx = fmaxf(m_r[x], rm[x] * sl2);
            bias[x] = mx == -INFINITY ? 0.f : mx;
            alpha[x] = ex2(m_r[x] - bias[x]);
            m_r[x] = mx;
          }
#pragma unroll
          for (int x = 0; x < KN / 2; ++x) {
            s[x] = ex2(fmaf(s[x], sl2, -bias[(x / 2) % 2]));
            rs[(x / 2) % 2] += s[x];
          }
          l_r[0] = l_r[0] * alpha[0] + rs[0];
          l_r[1] = l_r[1] * alpha[1] + rs[1];
        };
        // after P.V of entry j - 1 has finished: O *= alpha, P of j packed
        auto rescale_and_pack = [&]() {
#pragma unroll
          for (int x = 0; x < D / 2; ++x) acc[x] *= alpha[(x / 2) % 2];
#pragma unroll
          for (int nt = 0; nt < KN / 8; ++nt) {
            pf[nt / 2][(nt % 2) * 2 + 0] = pack2<T>(s[nt * 4], s[nt * 4 + 1]);
            pf[nt / 2][(nt % 2) * 2 + 1] = pack2<T>(s[nt * 4 + 2], s[nt * 4 + 3]);
          }
        };

        mbar_wait(full_k(base), parity(base));
        if (base == 0) DSTT_STAMP(1);
        wgmma_fence_operands(s);
        wgmma_fence();
        issue_qk(base);
        wgmma_wait<0>();
        wgmma_fence_operands(s);
        softmax(base);
        arrive(empty_k(base));
        rescale_and_pack();
        const int n_t = n_vis * L::SUB;   // ring tiles of the tile's visible entries
        for (int j = 1; j < n_t; ++j) {
          const int jg = base + j;
          mbar_wait(full_k(jg), parity(jg));
          mbar_wait(full_v(jg - 1), parity(jg - 1));
          wgmma_fence_operands(s);
          wgmma_fence_operands(acc);
          wgmma_fence();
          issue_qk(jg);
          issue_pv(jg - 1);
          wgmma_wait<1>();   // S of entry j is ready; P.V of j - 1 runs on
          wgmma_fence_operands(s);
          softmax(jg);
          arrive(empty_k(jg));
          wgmma_wait<0>();
          wgmma_fence_operands(acc);
          arrive(empty_v(jg - 1));
          rescale_and_pack();
        }
        if constexpr (!L::Q_REGS)
          arrive(empty_q);   // every Q.K^T of the tile is done: q may take the next tile
        const int jl = base + n_t - 1;
        mbar_wait(full_v(jl), parity(jl));
        wgmma_fence_operands(acc);
        wgmma_fence();
        issue_pv(jl);
        wgmma_wait<0>();
        wgmma_fence_operands(acc);
        arrive(empty_v(jl));
        base += n_t;
      } else {
        arrive(empty_q);
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        l_r[x] += __shfl_xor_sync(0xffffffffu, l_r[x], 1);
        l_r[x] += __shfl_xor_sync(0xffffffffu, l_r[x], 2);
      }
      // a row whose running max never rose above -inf saw no key: exactly 0
      const float inv_a = m_r[0] == -INFINITY ? 0.f : 1.f / l_r[0];
      const float inv_b = m_r[1] == -INFINITY ? 0.f : 1.f / l_r[1];
      // streaming stores: the output is not read again here, so it does
      // not take the L2 that K and V are reused from
      T* ob = o + b * o_b + h * o_h + (long long)qb * BLOCK * o_t;
#pragma unroll
      for (int x = 0; x < D / 8; ++x) {
        const int d = x * 8 + 2 * t4;
        if (d >= Dv) continue;
        __stcs(reinterpret_cast<unsigned*>(ob + (long long)ra * o_t + d),
               pack2<T>(acc[x * 4] * inv_a, acc[x * 4 + 1] * inv_a));
        __stcs(reinterpret_cast<unsigned*>(ob + (long long)rb * o_t + d),
               pack2<T>(acc[x * 4 + 2] * inv_b, acc[x * 4 + 3] * inv_b));
      }
    }
    DSTT_STAMP(2);
  }
  DSTT_STAMP(4);
}

// Tensor maps over (D, heads, T, B), cached by everything they encode
// (address, shape, strides, box rows), so a call does not encode them again.
struct MapKey {
  const void* p;
  long long d, h, t, b, s1, s2, s3;
  int rows, dtype;
  bool operator==(const MapKey& o) const {
    return p == o.p && d == o.d && h == o.h && t == o.t && b == o.b && s1 == o.s1 &&
           s2 == o.s2 && s3 == o.s3 && rows == o.rows && dtype == o.dtype;
  }
};

template <typename T>
bool cached_map(CUtensorMap* map, const void* p, long long D, long long H, long long T_len,
                long long B, long long s_h, long long s_t, long long s_b, int rows) {
  constexpr int N = 32;
  static std::mutex mu;
  static MapKey keys[N];
  static CUtensorMap maps[N];
  static int used = 0, next = 0;
  const MapKey key{p, D, H, T_len, B, s_h, s_t, s_b, rows, std::is_same<T, __half>::value ? 1 : 2};
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (keys[i] == key) {
      *map = maps[i];
      return true;
    }
  if (!make_tile_map<T>(map, p, D, H, T_len, B, s_h, s_t, s_b, rows)) return false;
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % N;
  if (used < N) ++used;
  return true;
}

template <typename T, int D, int BLOCK>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         const int* lut, const int* counts, const int* order, int* next_tile,
                         int B, int H, int T_len, int max_active, int Dv, const Strides& st,
                         float scale, int causal, cudaStream_t stream) {
  using L = SparseTiles<D, BLOCK>;
  CUtensorMap tq, tk, tv;
  if (!cached_map<T>(&tq, q, Dv, H, T_len, B, st.q_h, st.q_t, st.q_b, 64) ||
      !cached_map<T>(&tk, k, Dv, H, T_len, B, st.k_h, st.k_t, st.k_b, L::KN) ||
      !cached_map<T>(&tv, v, Dv, H, T_len, B, st.v_h, st.v_t, st.v_b, L::KN))
    return cudaErrorInvalidValue;
  // per device, looked up once: the shared-memory limit of the function
  // and the number of SMs (one persistent block each)
  constexpr int MAX_DEVICES = 64;
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    e = cudaFuncSetAttribute(bsa_wgmma_kernel<T, D, BLOCK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  const int nb = T_len / BLOCK;
  const long long pipes_needed = ((long long)nb * H * B + L::PIPES - 1) / L::PIPES;
  const int grid = (int)min(pipes_needed, (long long)sms[dev]);
  bsa_wgmma_kernel<T, D, BLOCK><<<grid, L::THREADS, L::SMEM, stream>>>(
      tq, tk, tv, static_cast<T*>(o), lut, counts, order, next_tile, B, H, nb, max_active, Dv,
      st.o_b, st.o_h, st.o_t, scale, causal);
  return cudaGetLastError();
}

constexpr int F32_WARPS = 4;

// float32: one warp per query row, each lane holding D/32 columns; a column
// past Dv reads column Dv - 1 times a zero q and is not written
template <int D>
__global__ void __launch_bounds__(F32_WARPS * 32)
bsa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               const int* __restrict__ lut, const int* __restrict__ counts,
               int nb, int max_active, int block, int Dv, Strides st, float scale,
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
  int col[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    col[i] = min(lane + 32 * i, Dv - 1);
    qv[i] = lane + 32 * i < Dv ? qr[col[i]] : 0.f;
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
      for (int i = 0; i < E; ++i) s = fmaf(qv[i], kr[col[i]], s);
#pragma unroll
      for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
      s *= scale;
      const float mn = fmaxf(m, s);
      const float alpha = expf(m - mn), p = expf(s - mn);
      l = l * alpha + p;
      const float* vr = vb_ + key * st.v_t;
#pragma unroll
      for (int i = 0; i < E; ++i) acc[i] = fmaf(p, vr[col[i]], acc[i] * alpha);
      m = mn;
    }
  }
  const float inv = m == -INFINITY ? 0.f : 1.f / l;
  float* orow = o + b * st.o_b + h * st.o_h + (long long)row * st.o_t;
#pragma unroll
  for (int i = 0; i < E; ++i)
    if (lane + 32 * i < Dv) orow[lane + 32 * i] = acc[i] * inv;
}

template <typename T, int D, int BLOCK>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       const int* lut, const int* counts, int B, int H, int nb,
                       int max_active, int Dv, const Strides& st, float scale,
                       int causal, cudaStream_t stream) {
  const size_t smem = (size_t)5 * BLOCK * (D + 8) * sizeof(T);   // Q + 2 x (K, V)
  // per device, so it is set on every launch (a host-side call, no sync)
  cudaError_t e = cudaFuncSetAttribute(bsa_mma_kernel<T, D, BLOCK>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(nb, H, B);
  bsa_mma_kernel<T, D, BLOCK><<<grid, BLOCK * 2, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lut, counts, nb, max_active, Dv, st, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_block(int block, const void* q, const void* k, const void* v,
                         void* o, const int* lut, const int* counts,
                         const int* order, int* next_tile, int B, int H, int nb,
                         int max_active, int Dv, const Strides& st, float scale,
                         int causal, cudaStream_t s) {
  switch (block) {
    case 16: return launch_mma<T, D, 16>(q, k, v, o, lut, counts, B, H, nb, max_active, Dv, st, scale, causal, s);
    case 32: return launch_mma<T, D, 32>(q, k, v, o, lut, counts, B, H, nb, max_active, Dv, st, scale, causal, s);
    case 64: return launch_wgmma<T, D, 64>(q, k, v, o, lut, counts, order, next_tile, B, H, nb * 64, max_active, Dv, st, scale, causal, s);
    case 128: return launch_wgmma<T, D, 128>(q, k, v, o, lut, counts, order, next_tile, B, H, nb * 128, max_active, Dv, st, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int D>
cudaError_t launch_f32(int block, const void* q, const void* k, const void* v,
                       void* o, const int* lut, const int* counts, int B,
                       int H, int nb, int max_active, int Dv, const Strides& st,
                       float scale, int causal, cudaStream_t s) {
  dim3 grid(nb * block / F32_WARPS, H, B);
  bsa_f32_kernel<D><<<grid, F32_WARPS * 32, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lut, counts, nb,
      max_active, block, Dv, st, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: [B, H, T, D] through (batch, head, time) strides in elements,
// head dim contiguous (16-bit: base 16-byte aligned, strides multiples of 8
// elements, TMA's rules). lut [H, nb, max_active] and counts [H, nb] int32,
// contiguous. order: null (query blocks from the last, 8 heads at a time),
// or int32 [H * nb], a permutation of h * nb + qb: the order in which the
// kernel takes the tiles of each batch row. next_tile: one int32 on the
// device, 0 before the first launch (the kernel leaves it 0); launches that
// share it run in order. dtype: 0 float32, 1 float16, 2 bfloat16. block in
// {16, 32, 64, 128}, T = nb * block, D (the kernel width) in {64, 128, 256} and
// Dv, the true head dim of q, k, v and o, 1 <= Dv <= D with rows of Dv
// elements whole 16-byte chunks.
extern "C" int dstt_block_sparse_attention(
    const void* q, const void* k, const void* v, void* o, const void* lut,
    const void* counts, const void* order, void* next_tile, int B, int H,
    int T_len, int D, int Dv, int block, int max_active, long long q_b, long long q_h,
    long long q_t, long long k_b, long long k_h, long long k_t, long long v_b,
    long long v_h, long long v_t, long long o_b, long long o_h, long long o_t,
    float scale, int causal, int dtype, void* stream) {
  const Strides st{q_b, q_h, q_t, k_b, k_h, k_t, v_b, v_h, v_t, o_b, o_h, o_t};
  const int* l = static_cast<const int*>(lut);
  const int* c = static_cast<const int*>(counts);
  const int* ord = static_cast<const int*>(order);
  int* nt = static_cast<int*>(next_tile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || block <= 0 || T_len <= 0 || T_len % block || max_active <= 0 ||
      Dv < 1 || Dv > D)
    return (int)cudaErrorInvalidValue;
  const int nb = T_len / block;
  if (dtype == 2 && D == 64) return (int)launch_block<__nv_bfloat16, 64>(block, q, k, v, o, l, c, ord, nt, B, H, nb, max_active, Dv, st, scale, causal, s);
  if (dtype == 2 && D == 128) return (int)launch_block<__nv_bfloat16, 128>(block, q, k, v, o, l, c, ord, nt, B, H, nb, max_active, Dv, st, scale, causal, s);
  if (dtype == 2 && D == 256) return (int)launch_block<__nv_bfloat16, 256>(block, q, k, v, o, l, c, ord, nt, B, H, nb, max_active, Dv, st, scale, causal, s);
  if (dtype == 1 && D == 64) return (int)launch_block<__half, 64>(block, q, k, v, o, l, c, ord, nt, B, H, nb, max_active, Dv, st, scale, causal, s);
  if (dtype == 1 && D == 128) return (int)launch_block<__half, 128>(block, q, k, v, o, l, c, ord, nt, B, H, nb, max_active, Dv, st, scale, causal, s);
  if (dtype == 1 && D == 256) return (int)launch_block<__half, 256>(block, q, k, v, o, l, c, ord, nt, B, H, nb, max_active, Dv, st, scale, causal, s);
  if (block != 16 && block != 32 && block != 64 && block != 128) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 64) return (int)launch_f32<64>(block, q, k, v, o, l, c, B, H, nb, max_active, Dv, st, scale, causal, s);
  if (dtype == 0 && D == 128) return (int)launch_f32<128>(block, q, k, v, o, l, c, B, H, nb, max_active, Dv, st, scale, causal, s);
  if (dtype == 0 && D == 256) return (int)launch_f32<256>(block, q, k, v, o, l, c, B, H, nb, max_active, Dv, st, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dstt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
