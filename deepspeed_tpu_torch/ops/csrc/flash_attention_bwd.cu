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
// all sums are f32 and the scale is applied once at the end. P is exp2 of
// the f32 score times log2(e) minus lse times log2(e), as in the forward.
//
// What bounds them on the H100: at the training shape of GPT-2 1.3B (B = 8,
// T = 1024, H = 16, D = 128, causal) dq does three products and dk/dv four
// over the causal half of the T x T pairs (~52 and ~69 GFLOP, ~0.05 and
// ~0.07 ms at 989 TFLOP/s bf16), against ~0.06 ms of bytes for dq: both
// are bound by the tensor cores, and only wgmma reaches their rate.
//
// Design (16-bit inputs), on the mechanics of the forward
// (flash_attention_fwd.cu) and the helpers of hopper.cuh:
//  * Two kernels, each deterministic: dq's scores use q.scale rounded and
//    dk/dv's k.scale rounded (the TPU kernels' two roundings), there are no
//    atomics across blocks, and two launches on the same inputs give the
//    same bits.
//  * Persistent: one block per SM takes tiles from a counter in global
//    memory, 16 (head, batch row) pairs at a time (the tiles they stream
//    stay in L2), heaviest tile first. A block is a producer warpgroup, of
//    which one thread issues every TMA copy (setmaxnreg 40), and two
//    consumer warpgroups (232 registers) of 64 rows of the block's tile
//    each; dq at D = 64 takes three (24 and 160 registers), as the
//    forward does, since its exp/dS work weighs as much as its products.
//  * Tiles arrive by TMA through 4-D tensor maps over (D, heads, T, B),
//    built on the host for each launch from the strides (q/k/v may be
//    views of a fused projection), as 128-byte-swizzled boxes of 64 rows by
//    64 columns (a D = 128 row is two boxes); rows past T read as zero.
//  * dq: a block owns 128 q rows (192 at D = 64). Its Q and dO tiles are
//    double-buffered, so the next tile's land while this one is
//    multiplied; each warpgroup scales its Q rows in place and fences them
//    to the async proxy. K and V tiles of 64 keys stream through two
//    mbarrier rings. Per key tile,
//    S = Qs.K^T and dP = dO.V^T are SS wgmma m64n64k16 (both operands
//    K-major); dS = P o (dP - delta) is built in registers and packed to
//    16-bit A fragments; dQ += dS.K is register-A wgmma with the K tile
//    read MN-major (the transpose bit). S and dP of key tile j are issued
//    with dQ of key tile j - 1, so the exp/dS work of j runs on the CUDA
//    cores while dQ of j - 1 runs on the tensor cores. delta is summed by
//    the four threads that hold each row (O read from device memory, dO
//    from the resident tile) while the first products run, written for
//    dk/dv and kept in registers.
//  * dk/dv: a block owns 128 keys. Ks (scaled in place) and V are
//    double-buffered across tiles. For each member of the GQA group and
//    each visible q tile of 64 rows the producer streams Q and dO with
//    their lse and delta rows (a 1-D f32 tensor map) in one ring stage
//    under one mbarrier. Per q tile at D = 64, per half q tile at D = 128
//    (32 rows, so the scores take 32 registers beside dK's and dV's 128),
//    keys as rows: S^T = Ks.Q^T and dP^T = V.dO^T are SS wgmma (n = 64 or
//    32); dV += P^T.dO and dK += dS^T.Q are register-A wgmma with dO and Q
//    read MN-major (one swizzled tile is both a K-major and an MN-major
//    operand), and run while the next half's scores are issued. The group
//    sum stays in registers, in a fixed order.
//  * Causal: dq stops at each warpgroup's diagonal key tile and dk/dv
//    starts at each warpgroup's diagonal q tile; only those tiles and the
//    ragged last tile pay for the mask. The warpgroups release the ring's
//    tiles they do not multiply untouched.
//  * Epilogue: dq (x scale), dk (x scale) and dv, rounded, go through the
//    warpgroup's rows of its resident tile (no longer read) to a TMA store
//    that drops rows past T.
// At D = 256 (Gemma-shaped heads) these tiles do not fit the SM:
//  * dq: a double-buffered Q and dO pair of 128 rows alone takes 256 KB,
//    and dQ holds 128 registers a thread. `DqTiles<256>` keeps one (Q, dO)
//    buffer (128 KB: the producer loads the next tile's once this one's dq
//    is stored) and streams K and V in tiles of 32 keys through 3-slot
//    rings (96 KB): S and dP are m64n32k16 (16 registers each beside dQ's
//    128), dQ += dS.K two m64n128k16 a slice of 16 keys, one per
//    128-column half of K. Two warpgroups of 64 rows keep a 128-row tile,
//    so each K/V tile still serves 128 q rows.
//  * dk/dv: dK and dV of one warpgroup's 64 keys would be 256 registers a
//    thread. `bwd_dkv_split_kernel` gives the two warpgroups one tile of 64
//    keys and a role each (dV, dK), passing P^T between them through shared
//    memory; its note below gives the design.
// float32 inputs take plain FMA kernels: one warp per query row (dq) or
// per key row (dk/dv).
// Head dims: the kernels are instantiated at DK = 64, 128 and 256 and take
// any true head dim Dv <= DK whose rows are whole 16-byte chunks. Every tensor
// map is encoded with Dv as its innermost extent (dq, dk and dv are packed
// [B, T, heads, Dv]), so TMA reads the columns past Dv as zeros and the
// stores drop them; dq's pointer loads of O are zero past Dv, so
// delta = rowsum(dO o O) gains nothing from them. The f32 kernels read
// clamped columns times a zero operand and write only the first Dv.
//
// C interface (route (b) of the build: nvcc -shared, loaded with ctypes):
// each launch returns cudaGetLastError() so the Python wrapper can raise.

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

using namespace dstt;

constexpr float NEG_BIG = -1e30f;   // the TPU kernels' NEG_INF
constexpr float LOG2E = 1.4426950408889634f;

// element strides of q, k, v, o and dO (batch, time, head); the head dim is
// contiguous. dq, dk and dv are written packed [B, T, heads, Dv].
struct Strides {
  long long q_b, q_t, q_h, k_b, k_t, k_h, v_b, v_t, v_h, o_b, o_t, o_h,
      do_b, do_t, do_h;
};

// ------------------------------------------------- 16-bit: TMA + wgmma

constexpr int WG_THREADS = 128;

// 2^x, one MUFU instruction (subnormal results flush to 0, far below a
// 16-bit P's resolution)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D, int C = 2> struct Tiles {
  static constexpr int CONSUMERS = C;              // warpgroups of 64 rows
  static constexpr int BLOCK_M = 64 * CONSUMERS;   // q rows (dq) or keys (dk/dv) a tile
  static constexpr int THREADS = (CONSUMERS + 1) * WG_THREADS;   // the producer's last
  // setmaxnreg moves registers only within those a thread the launch gave
  // (65,536 / threads, rounded down to 8): 40 + 2 x 232 = 3 x 168 (with
  // 32 + 2 x 240 the consumers wait for registers forever); 24 + 3 x 160
  // <= 4 x 128
  static constexpr int PRODUCER_REGS = C == 3 ? 24 : 40;
  static constexpr int CONSUMER_REGS = C == 3 ? 160 : 232;
  static constexpr int HALVES = D / 64;            // 64-column boxes a row
  static constexpr int BOX = 64 * 128;             // bytes of a box of 64 rows
  static constexpr int RES_HALF = BLOCK_M * 128;   // one box column of a resident tile
  static constexpr int RES_BYTES = HALVES * RES_HALF;   // a resident Q, dO, K or V tile
  static constexpr int STREAM_BYTES = HALVES * BOX;     // a streamed tile of 64 rows
  static constexpr int HEAD_GROUP = 16;
};

// dq: q buffers (Q, dO) | K ring | V ring | mbarriers: full and empty of
// each q buffer (room for 2), then full and empty of K and V per slot | 2
// tile indices
template <int D> struct DqTiles : Tiles<D, D == 64 ? 3 : 2> {
  using B_ = Tiles<D, D == 64 ? 3 : 2>;
  // keys a K/V tile: 32 at D = 256, where a Q and dO pair of 128 rows takes
  // 128 KB and the rings what is left; S and dP of 32 keys (16 registers
  // each) sit beside dQ's 128
  static constexpr int KN = D == 256 ? 32 : 64;
  // (Q, dO) buffers: one at D = 256 (a second would not fit beside the rings)
  static constexpr int Q_BUFS = D == 256 ? 1 : 2;
  static constexpr int KV_HALF = KN * 128;                  // one box of a K or V tile
  static constexpr int KV_BYTES = B_::HALVES * KV_HALF;     // a K or V tile
  // depth of the K ring and the V ring: a K tile is held until dQ of the
  // next key tile's turn is done, so two stages would leave none to prefetch
  static constexpr int STAGES = D == 64 ? 4 : 3;
  static constexpr int BARRIERS = Q_BUFS * 2 * B_::RES_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int SMEM = BARRIERS + 8 * (4 + 4 * STAGES) + 8 + 1024;   // + room to align
  static_assert(SMEM <= 232448, "the SM's shared memory");
};

// dk/dv: 2 kv buffers (K, V) | q ring of stages (Q, dO) | each stage's 64
// lse and 64 delta | mbarriers: full and empty of each kv buffer, then of
// each stage | 2 tile indices. At D = 128 three stages fill the 227 KB.
template <int D> struct DkvTiles : Tiles<D> {
  using B_ = Tiles<D>;
  static constexpr int STAGES = D == 64 ? 4 : 3;
  // q columns of one product: a q tile at D = 64; at D = 128 half a tile,
  // so S^T and dP^T take 32 registers beside dK's and dV's 128
  static constexpr int QN = D == 64 ? 64 : 32;
  static constexpr int STAGE_BYTES = 2 * B_::STREAM_BYTES;
  static constexpr int ROWS = 4 * B_::RES_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BARRIERS = ROWS + STAGES * 2 * 64 * 4;
  static constexpr int SMEM = BARRIERS + 8 * (4 + 2 * STAGES) + 8 + 1024;
};

// (x * scale).astype(T) in place over a warpgroup's 64 rows of a resident
// tile (elementwise: the swizzle does not matter)
template <typename T, int D>
__device__ __forceinline__ void scale_rows(unsigned char* rows, int half, float scale, int tid) {
#pragma unroll
  for (int hf = 0; hf < D / 64; ++hf) {
    uint4* p = reinterpret_cast<uint4*>(rows + hf * half);
#pragma unroll
    for (int x = tid; x < 64 * 128 / 16; x += WG_THREADS) {
      uint4 raw = p[x];
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int y = 0; y < 8; ++y) e[y] = from_float<T>(to_float(e[y]) * scale);
      p[x] = raw;
    }
  }
}

// a warpgroup's 64 x D f32 accumulator times mul, rounded, into its rows
// of a resident tile, in the swizzled layout a TMA store reads. Accumulator
// layout of m64nN: element 4i + e of a thread sits at row 16 warp + g (+8
// for e >= 2), column 8i + 2 t4 + (e & 1).
template <typename T, int D>
__device__ __forceinline__ void stage_rows(unsigned char* rows, int half, const float (&acc)[D / 2],
                                           float mul, int warp, int g, int t4) {
  const int ra = warp * 16 + g;
#pragma unroll
  for (int x = 0; x < D / 8; ++x) {
    const int c = x * 8 + 2 * t4, cc = c % 64;
    unsigned char* box = rows + (c / 64) * half;
    const int at = (((cc / 8) ^ (ra % 8)) * 16) + (cc % 8) * 2;
    *reinterpret_cast<uint32_t*>(box + ra * 128 + at) =
        pack2<T>(acc[x * 4] * mul, acc[x * 4 + 1] * mul);
    *reinterpret_cast<uint32_t*>(box + (ra + 8) * 128 + at) =
        pack2<T>(acc[x * 4 + 2] * mul, acc[x * 4 + 3] * mul);
  }
}

// an m64nN f32 accumulator -> the A fragments of its N / 16 slices of 16
// columns, rounded to T
template <typename T, int N>
__device__ __forceinline__ void pack_frags(uint32_t (&f)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    f[nt / 2][(nt % 2) * 2 + 0] = pack2<T>(x[nt * 4], x[nt * 4 + 1]);
    f[nt / 2][(nt % 2) * 2 + 1] = pack2<T>(x[nt * 4 + 2], x[nt * 4 + 3]);
  }
}

// sum += the dot product of 8 values of a and 8 of b, in f32
template <typename T>
__device__ __forceinline__ void dot8(float& sum, const uint4& a, const uint4& b) {
  const T* x = reinterpret_cast<const T*>(&a);
  const T* y = reinterpret_cast<const T*>(&b);
#pragma unroll
  for (int i = 0; i < 8; ++i) sum = fmaf(to_float(x[i]), to_float(y[i]), sum);
}

// hides a value from the optimiser (no code): what is computed from it
// stays where it is written
__device__ __forceinline__ void opaque(uint32_t& x) { asm volatile("" : "+r"(x)); }

// two f32 from shared memory at a shared-space address (32 bits, where a
// generic pointer takes two registers)
__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

// d = A.B^T over D columns, 64 x N (N = 64 or 32), both operands K-major
// tiles of 128-byte rows (A's box columns `a_half` bytes apart, B's
// B_HALF): slice kk of 16 columns is 32 bytes into the rows of box kk / 4.
// The first slice overwrites d.
template <typename T, int D, int N, int B_HALF = 64 * 128>
__device__ __forceinline__ void kmajor_product(float (&d)[N / 2], uint32_t a, int a_half,
                                               uint32_t b) {
  // the descriptors are built here, each before its product: hoisted out of
  // a loop they would hold 32 registers of a consumer for nothing
  opaque(a);
  opaque(b);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = wgmma_desc(a + (kk / 4) * a_half + (kk % 4) * 32, 16, 1024);
    const uint64_t db = wgmma_desc(b + (kk / 4) * B_HALF + (kk % 4) * 32, 16, 1024);
    if constexpr (N == 64) {
      if (kk == 0) wgmma_ss_m64n64k16<T, 0, 0, true>(d, da, db);
      else wgmma_ss_m64n64k16<T, 0, 0>(d, da, db);
    } else {
      if (kk == 0) wgmma_ss_m64n32k16<T, 0, 0, true>(d, da, db);
      else wgmma_ss_m64n32k16<T, 0, 0>(d, da, db);
    }
  }
}

// ---------------------------------------------------------------- B2: dq

template <typename T, int D>
__global__ void __launch_bounds__(DqTiles<D>::THREADS, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_dq, const T* __restrict__ o,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    int* __restrict__ next_tile, int T_len, int H, int KH, int B, int Dv,
                    long long os_b, long long os_t, long long os_h, float scale, int causal) {
  using L = DqTiles<D>;
  constexpr int KN = L::KN, QB = L::Q_BUFS;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: boxes start on that grid
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = smem_u32(smem);
  const uint32_t sK = s0 + QB * 2 * L::RES_BYTES;
  const uint32_t sV = sK + L::STAGES * L::KV_BYTES;
  const uint32_t bars = s0 + L::BARRIERS;
  volatile int* tile_slot =
      reinterpret_cast<volatile int*>(smem + L::BARRIERS + 8 * (4 + 4 * L::STAGES));
  // q buffer u % QB (Q, then dO) holds the block's u-th tile, in phase (u / QB) & 1
  auto qbuf = [](int u) { return (u % QB) * 2 * L::RES_BYTES; };
  auto full_q = [&](int u) { return bars + 8 * (u % QB); };
  auto empty_q = [&](int u) { return bars + 8 * (2 + u % QB); };
  // key tile j (counted over every tile the block takes) sits in slot
  // j % STAGES of both rings, in phase (j / STAGES) & 1
  auto slot = [](int j) { return j % L::STAGES; };
  auto parity = [](int j) { return (uint32_t)(j / L::STAGES) & 1; };
  auto full_k = [&](int j) { return bars + 8 * (4 + slot(j)); };
  auto full_v = [&](int j) { return bars + 8 * (4 + L::STAGES + slot(j)); };
  auto empty_k = [&](int j) { return bars + 8 * (4 + 2 * L::STAGES + slot(j)); };
  auto empty_v = [&](int j) { return bars + 8 * (4 + 3 * L::STAGES + slot(j)); };

  const int n_qt = (T_len + L::BLOCK_M - 1) / L::BLOCK_M;
  const int n_tiles = n_qt * H * B;
  // q tiles are cut back from T rounded up to 64 rows, so the tile that
  // would stick out past row 0 is the lightest under a causal mask, and its
  // warpgroup of rows < 0 sits out
  const int T64 = (T_len + 63) / 64 * 64;
  const int n_keys = (T_len + KN - 1) / KN;   // key tiles of KN
  auto tile_of = [&](int i, int& q0, int& h, int& b, int& n_kt) {
    const int group = i / (n_qt * L::HEAD_GROUP);
    const int first = group * L::HEAD_GROUP;
    const int size = min(L::HEAD_GROUP, H * B - first);
    const int w = i - group * n_qt * L::HEAD_GROUP;
    q0 = T64 - (1 + w / size) * L::BLOCK_M;   // heaviest first
    h = (first + w % size) % H;
    b = (first + w % size) / H;
    n_kt = causal ? min(n_keys, (q0 + L::BLOCK_M) / KN) : n_keys;   // through the diagonal
  };

  if (threadIdx.x == 0) {
    for (int u = 0; u < QB; ++u) {
      mbar_init(full_q(u), 1);
      mbar_init(empty_q(u), 4 * L::CONSUMERS);   // lane 0 of each consumer warp
    }
    for (int j = 0; j < L::STAGES; ++j) {
      mbar_init(full_k(j), 1);
      mbar_init(full_v(j), 1);
      mbar_init(empty_k(j), 4 * L::CONSUMERS);
      mbar_init(empty_v(j), 4 * L::CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == L::CONSUMERS) {
    // ---- producer: one thread takes tiles and keeps the q buffers and rings full
    setmaxnreg_dec<L::PRODUCER_REGS>();
    if (threadIdx.x == L::CONSUMERS * WG_THREADS) {
      int base = 0;
      for (int u = 0;; ++u) {
        // the q buffer of tile u - QB is free once its dq has been stored
        mbar_wait(empty_q(u), ((u / QB) & 1) ^ 1);
        const int i = atomicAdd(next_tile, 1);
        tile_slot[u % QB] = i;   // published by the arrival on full_q
        if (i >= n_tiles) {
          mbar_arrive(full_q(u));
          break;
        }
        int q0, h, b, n_kt;
        tile_of(i, q0, h, b, n_kt);
        const int kh = h / (H / KH);
        // Q and dO rows of each warpgroup with rows >= 0 (full boxes, rows
        // past T included)
        const int w0 = q0 < 0 ? -q0 / 64 : 0;
        mbar_expect_tx(full_q(u), (L::CONSUMERS - w0) * 64 * D * 2 * 2);
        const uint32_t qb = s0 + qbuf(u);
        for (int w = w0; w < L::CONSUMERS; ++w)
          for (int hf = 0; hf < L::HALVES; ++hf) {
            const uint32_t at = qb + hf * L::RES_HALF + w * L::BOX;
            tma_load_4d(at, &tm_q, full_q(u), hf * 64, h, q0 + 64 * w, b);
            tma_load_4d(at + L::RES_BYTES, &tm_do, full_q(u), hf * 64, h, q0 + 64 * w, b);
          }
        // key tile j of one ring, once its slot's previous tile is released
        auto load = [&](const CUtensorMap* map, uint32_t ring, uint32_t full, uint32_t empty,
                        int j) {
          const int jg = base + j;
          mbar_wait(empty, parity(jg) ^ 1);
          mbar_expect_tx(full, L::KV_BYTES);
          for (int hf = 0; hf < L::HALVES; ++hf)
            tma_load_4d(ring + slot(jg) * L::KV_BYTES + hf * L::KV_HALF, map, full, hf * 64, kh,
                        j * KN, b);
        };
        for (int j = 0; j < n_kt; ++j) {
          load(&tm_k, sK, full_k(base + j), empty_k(base + j), j);
          load(&tm_v, sV, full_v(base + j), empty_v(base + j), j);
        }
        base += n_kt;
      }
    }
  } else {
    // ---- consumers: 64 q rows each
    setmaxnreg_inc<L::CONSUMER_REGS>();
    const int tid = threadIdx.x % WG_THREADS, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int r0 = wg * 64;   // first row of this warpgroup in a tile
    auto arrive = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
      __syncwarp();
    };
    constexpr int CH = D / 32;   // 16-byte chunks of a row each of its four threads sums
    float s[KN / 2], dp[KN / 2], dq[D / 2];
    uint32_t dsf[KN / 16][4];   // dS of key tile j - 1: the A fragment of each 16 keys
    int base = 0;
    for (int u = 0;; ++u) {
      mbar_wait(full_q(u), (u / QB) & 1);
      const int i = tile_slot[u % QB];
      if (i >= n_tiles) break;
      int q0, h, b, n_kt;
      tile_of(i, q0, h, b, n_kt);
      const int qr = q0 + r0;   // first row of this warpgroup
      // key tiles this warpgroup multiplies: through its own diagonal, none
      // when its rows lie before row 0; it still releases every tile
      int n_wg = causal ? min(n_kt, (qr + 64) / KN) : n_kt;
      if (qr < 0) n_wg = 0;
      if (n_wg > 0) {
        unsigned char* q_rows = smem + qbuf(u) + r0 * 128;   // its rows in each box
        const uint32_t my_q = smem_u32(q_rows), my_do = my_q + L::RES_BYTES;
        const int row_a = qr + warp * 16 + g, row_b = row_a + 8;
        const long long bh = (long long)b * H + h;
        // this thread's quarter of its two rows of O (16-byte chunks t4,
        // t4 + 4, ...; zero past Dv) and the rows' lse times log2(e), read
        // ahead of use
        uint4 o_a[CH], o_b[CH];
        const T* ob = o + b * os_b + h * os_h;
#pragma unroll
        for (int x = 0; x < CH; ++x) {
          const int col = (t4 + 4 * x) * 8;
          o_a[x] = row_a < T_len && col < Dv
                       ? *reinterpret_cast<const uint4*>(ob + row_a * os_t + col)
                       : make_uint4(0, 0, 0, 0);
          o_b[x] = row_b < T_len && col < Dv
                       ? *reinterpret_cast<const uint4*>(ob + row_b * os_t + col)
                       : make_uint4(0, 0, 0, 0);
        }
        const float lse_a = row_a < T_len ? lse[bh * T_len + row_a] * LOG2E : 0.f;
        const float lse_b = row_b < T_len ? lse[bh * T_len + row_b] * LOG2E : 0.f;
        __syncwarp();   // reconverge before the warpgroup-wide instructions
        // Qs = (q * scale).astype(q.dtype), in place, made visible to wgmma
        scale_rows<T, D>(q_rows, L::RES_HALF, scale, tid);
        fence_proxy_async();
        named_barrier(1 + wg, WG_THREADS);
        if constexpr (D != 256) {
#pragma unroll
          for (int x = 0; x < D / 2; ++x) dq[x] = 0.f;
        }

        // S = Qs.K^T and dP = dO.V^T, 64 x KN: all operands K-major; slice
        // kk of 16 columns is 32 bytes into the rows of box kk / 4
        auto issue_sdp = [&](int jg) {
          const uint32_t kt = sK + slot(jg) * L::KV_BYTES;
          const uint32_t vt = sV + slot(jg) * L::KV_BYTES;
          kmajor_product<T, D, KN, L::KV_HALF>(s, my_q, L::RES_HALF, kt);
          kmajor_product<T, D, KN, L::KV_HALF>(dp, my_do, L::RES_HALF, vt);
          wgmma_commit();
        };
        // dQ += dS.K: K is MN-major (D contiguous); slice kk of 16 keys is 16
        // rows = 2048 bytes on, the next 64-column box KV_HALF bytes on. At
        // D = 256, dQ's 128-column halves (K's boxes 0-1 and 2-3) are each
        // the accumulator of one m64n128k16: registers 4i + e of the m64n256
        // layout, column 8i + 2 t4 + (e & 1), are the same
        auto issue_dq = [&](int jg) {
          uint32_t kt = sK + slot(jg) * L::KV_BYTES;
          opaque(kt);
#pragma unroll
          for (int kk = 0; kk < KN / 16; ++kk) {
            if constexpr (D == 256) {
              float(&dq_lo)[64] = *reinterpret_cast<float(*)[64]>(dq);
              float(&dq_hi)[64] = *reinterpret_cast<float(*)[64]>(dq + 64);
              WgmmaRS<T, 128, 1>::run(dq_lo, dsf[kk], wgmma_desc(kt + kk * 2048, L::KV_HALF, 1024),
                                      1);
              WgmmaRS<T, 128, 1>::run(
                  dq_hi, dsf[kk], wgmma_desc(kt + 2 * L::KV_HALF + kk * 2048, L::KV_HALF, 1024), 1);
            } else {
              WgmmaRS<T, D, 1>::run(dq, dsf[kk], wgmma_desc(kt + kk * 2048, L::KV_HALF, 1024), 1);
            }
          }
          wgmma_commit();
        };
        float dl_a, dl_b;
        // P = exp(s - lse) and dS = P o (dP - delta) in f32, in dp's registers
        auto make_ds = [&](int j) {
          const int k0 = j * KN;
          const bool masked = (causal && k0 + KN - 1 > qr) || k0 + KN > T_len;
#pragma unroll
          for (int nt = 0; nt < KN / 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = k0 + nt * 8 + 2 * t4 + (e & 1);
              const int row = e < 2 ? row_a : row_b;
              float x = s[nt * 4 + e];
              if (masked && (col >= T_len || (causal && col > row))) x = NEG_BIG;
              const float p = ex2(fmaf(x, LOG2E, -(e < 2 ? lse_a : lse_b)));
              dp[nt * 4 + e] = p * (dp[nt * 4 + e] - (e < 2 ? dl_a : dl_b));
            }
          }
        };

        mbar_wait(full_k(base), parity(base));
        mbar_wait(full_v(base), parity(base));
        __syncwarp();
        wgmma_fence();
        issue_sdp(base);
        // delta = rowsum(dO o O) while the first products run: the four
        // threads of a row each sum a quarter of it
        {
          const int ra = warp * 16 + g;
          const unsigned char* d_rows = q_rows + L::RES_BYTES;
          float acc_a = 0.f, acc_b = 0.f;
#pragma unroll
          for (int x = 0; x < CH; ++x) {
            const int c = t4 + 4 * x;   // 16-byte chunk of the row
            const int at = (c / 8) * L::RES_HALF + (((c % 8) ^ (ra % 8)) * 16);
            dot8<T>(acc_a, *reinterpret_cast<const uint4*>(d_rows + ra * 128 + at), o_a[x]);
            dot8<T>(acc_b, *reinterpret_cast<const uint4*>(d_rows + (ra + 8) * 128 + at),
                    o_b[x]);
          }
#pragma unroll
          for (int m = 1; m < 4; m *= 2) {
            acc_a += __shfl_xor_sync(0xffffffffu, acc_a, m);
            acc_b += __shfl_xor_sync(0xffffffffu, acc_b, m);
          }
          dl_a = acc_a;
          dl_b = acc_b;
          if (t4 == 0) {
            if (row_a < T_len) delta[bh * T_len + row_a] = acc_a;
            if (row_b < T_len) delta[bh * T_len + row_b] = acc_b;
          }
          __syncwarp();
        }
        if constexpr (D == 256) {   // dQ's zeros are not held through delta's loads
#pragma unroll
          for (int x = 0; x < D / 2; ++x) dq[x] = 0.f;
        }
        wgmma_wait<0>();
        wgmma_fence_operands(s);
        wgmma_fence_operands(dp);
        arrive(empty_v(base));
        make_ds(0);
        pack_frags<T, KN>(dsf, dp);
        // S and dP of key tile j are issued with dQ of j - 1; the exp/dS
        // work of j runs while dQ of j - 1 is on the tensor cores
        for (int j = 1; j < n_wg; ++j) {
          const int jg = base + j;
          mbar_wait(full_k(jg), parity(jg));
          mbar_wait(full_v(jg), parity(jg));
          wgmma_fence_operands(dq);
          __syncwarp();
          wgmma_fence();
          issue_sdp(jg);
          issue_dq(jg - 1);
          wgmma_wait<1>();   // S and dP of j are ready; dQ of j - 1 runs on
          wgmma_fence_operands(s);
          wgmma_fence_operands(dp);
          arrive(empty_v(jg));
          make_ds(j);
          __syncwarp();
          wgmma_wait<0>();
          wgmma_fence_operands(dq);
          arrive(empty_k(jg - 1));
          pack_frags<T, KN>(dsf, dp);
        }
        const int jl = base + n_wg - 1;
        wgmma_fence_operands(dq);
        __syncwarp();
        wgmma_fence();
        issue_dq(jl);
        wgmma_wait<0>();
        wgmma_fence_operands(dq);
        arrive(empty_k(jl));

        // dQ x scale, rounded, into this warpgroup's q rows (no longer
        // read); the TMA store drops rows past T
        stage_rows<T, D>(q_rows, L::RES_HALF, dq, scale, warp, g, t4);
        fence_proxy_async();
        named_barrier(1 + wg, WG_THREADS);
        if (tid == 0) {
          for (int hf = 0; hf < L::HALVES; ++hf)
            tma_store_4d(&tm_dq, my_q + hf * L::RES_HALF, hf * 64, h, qr, b);
          tma_store_wait();
        }
        named_barrier(1 + wg, WG_THREADS);
      }
      arrive(empty_q(u));   // the q buffer may take tile u + 2
      // key tiles past this warpgroup's diagonal: released once loaded, so
      // each phase of an empty barrier counts one arrival per warp per tile
      for (int j = n_wg; j < n_kt; ++j) {
        mbar_wait(full_k(base + j), parity(base + j));
        arrive(empty_k(base + j));
        mbar_wait(full_v(base + j), parity(base + j));
        arrive(empty_v(base + j));
      }
      base += n_kt;
    }
  }
}

// -------------------------------------------------------------- B3: dk/dv

template <typename T, int D>
__global__ void __launch_bounds__(DkvTiles<D>::THREADS, 1)
bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_lse,
                     const __grid_constant__ CUtensorMap tm_delta,
                     const __grid_constant__ CUtensorMap tm_dk,
                     const __grid_constant__ CUtensorMap tm_dv, int* __restrict__ next_tile,
                     int T_len, int H, int KH, int B, float scale, int causal) {
  using L = DkvTiles<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = smem_u32(smem);
  const uint32_t bars = s0 + L::BARRIERS;
  volatile int* tile_slot =
      reinterpret_cast<volatile int*>(smem + L::BARRIERS + 8 * (4 + 2 * L::STAGES));
  // kv buffer u % 2 (K, then V) holds the block's u-th tile, in phase (u / 2) & 1
  auto kvbuf = [](int u) { return (u % 2) * 2 * L::RES_BYTES; };
  auto full_kv = [&](int u) { return bars + 8 * (u % 2); };
  auto empty_kv = [&](int u) { return bars + 8 * (2 + u % 2); };
  // q tile j (counted over every tile the block takes) sits in stage
  // j % STAGES, in phase (j / STAGES) & 1
  auto stage = [](int j) { return 4 * L::RES_BYTES + (j % L::STAGES) * L::STAGE_BYTES; };
  auto rows_at = [](int j) { return L::ROWS + (j % L::STAGES) * 2 * 64 * 4; };
  auto parity = [](int j) { return (uint32_t)(j / L::STAGES) & 1; };
  auto full_r = [&](int j) { return bars + 8 * (4 + j % L::STAGES); };
  auto empty_r = [&](int j) { return bars + 8 * (4 + L::STAGES + j % L::STAGES); };

  const int rep = H / KH;
  const int n_kt = (T_len + L::BLOCK_M - 1) / L::BLOCK_M;
  const int n_tiles = n_kt * KH * B;
  const int n_qt = (T_len + 63) / 64;   // q tiles of 64
  auto tile_of = [&](int i, int& k0, int& kh, int& b, int& q_first) {
    const int group = i / (n_kt * L::HEAD_GROUP);
    const int first = group * L::HEAD_GROUP;
    const int size = min(L::HEAD_GROUP, KH * B - first);
    const int w = i - group * n_kt * L::HEAD_GROUP;
    k0 = (w / size) * L::BLOCK_M;   // under a causal mask the first keys see the most rows
    kh = (first + w % size) % KH;
    b = (first + w % size) / KH;
    q_first = causal ? k0 / 64 : 0;   // earlier q tiles see none of these keys
  };

  if (threadIdx.x == 0) {
    for (int u = 0; u < 2; ++u) {
      mbar_init(full_kv(u), 1);
      mbar_init(empty_kv(u), 4 * L::CONSUMERS);
    }
    for (int j = 0; j < L::STAGES; ++j) {
      mbar_init(full_r(j), 1);
      mbar_init(empty_r(j), 4 * L::CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == L::CONSUMERS) {
    // ---- producer
    setmaxnreg_dec<L::PRODUCER_REGS>();
    if (threadIdx.x == L::CONSUMERS * WG_THREADS) {
      int base = 0;
      for (int u = 0;; ++u) {
        mbar_wait(empty_kv(u), ((u / 2) & 1) ^ 1);
        const int i = atomicAdd(next_tile, 1);
        tile_slot[u % 2] = i;
        if (i >= n_tiles) {
          mbar_arrive(full_kv(u));
          break;
        }
        int k0, kh, b, q_first;
        tile_of(i, k0, kh, b, q_first);
        // K and V rows of each warpgroup whose keys start before T
        const int nw = min(L::CONSUMERS, (T_len - k0 + 63) / 64);
        mbar_expect_tx(full_kv(u), nw * 64 * D * 2 * 2);
        const uint32_t kb = s0 + kvbuf(u);
        for (int w = 0; w < nw; ++w)
          for (int hf = 0; hf < L::HALVES; ++hf) {
            const uint32_t at = kb + hf * L::RES_HALF + w * L::BOX;
            tma_load_4d(at, &tm_k, full_kv(u), hf * 64, kh, k0 + 64 * w, b);
            tma_load_4d(at + L::RES_BYTES, &tm_v, full_kv(u), hf * 64, kh, k0 + 64 * w, b);
          }
        // for each member of the group, each q tile from the first visible
        const int per_head = n_qt - q_first, n_it = rep * per_head;
        for (int it = 0; it < n_it; ++it) {
          const int jg = base + it;
          const int hh = kh * rep + it / per_head, q0 = (q_first + it % per_head) * 64;
          mbar_wait(empty_r(jg), parity(jg) ^ 1);
          const uint32_t full = full_r(jg), st = s0 + stage(jg);
          mbar_expect_tx(full, L::STAGE_BYTES + 2 * 64 * 4);
          for (int hf = 0; hf < L::HALVES; ++hf) {
            tma_load_4d(st + hf * L::BOX, &tm_q, full, hf * 64, hh, q0, b);
            tma_load_4d(st + L::STREAM_BYTES + hf * L::BOX, &tm_do, full, hf * 64, hh, q0, b);
          }
          // values past T read as zero (the mask makes their P 0)
          const uint32_t rows = s0 + rows_at(jg);
          tma_load_2d(rows, &tm_lse, full, q0, b * H + hh);
          tma_load_2d(rows + 256, &tm_delta, full, q0, b * H + hh);
        }
        base += n_it;
      }
    }
  } else {
    // ---- consumers: 64 keys each
    setmaxnreg_inc<L::CONSUMER_REGS>();
    const int tid = threadIdx.x % WG_THREADS, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int r0 = wg * 64;
    auto arrive = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
      __syncwarp();
    };
    constexpr int QN = L::QN;
    float dk[D / 2], dv[D / 2], s[QN / 2], dp[QN / 2];   // S^T and dP^T of QN q rows
    uint32_t pf[QN / 16][4], dsf[QN / 16][4];   // P^T, dS^T: the A fragment of each 16
    int base = 0;
    for (int u = 0;; ++u) {
      mbar_wait(full_kv(u), (u / 2) & 1);
      const int i = tile_slot[u % 2];
      if (i >= n_tiles) break;
      int k0, kh, b, q_first;
      tile_of(i, k0, kh, b, q_first);
      const int per_head = n_qt - q_first, n_it = rep * per_head;
      const int kw = k0 + r0;   // first key of this warpgroup
      const bool active = kw < T_len;
      const int qw = causal ? kw / 64 : 0;   // its first visible q tile
      const uint32_t my_k = s0 + kvbuf(u) + r0 * 128, my_v = my_k + L::RES_BYTES;
      const int row_a = kw + warp * 16 + g, row_b = row_a + 8;   // key rows of this thread
      if (active) {
        // Ks = (k * scale).astype(k.dtype), in place, made visible to wgmma
        scale_rows<T, D>(smem + kvbuf(u) + r0 * 128, L::RES_HALF, scale, tid);
        fence_proxy_async();
        named_barrier(1 + wg, WG_THREADS);
#pragma unroll
        for (int x = 0; x < D / 2; ++x) dk[x] = dv[x] = 0.f;
      }
      for (int it = 0; it < n_it; ++it) {
        const int jg = base + it;
        const int qt = q_first + it % per_head;
        mbar_wait(full_r(jg), parity(jg));
        if (active && qt >= qw) {
          const uint32_t sq = s0 + stage(jg), sdo = sq + L::STREAM_BYTES;
          const uint32_t lse_r = s0 + rows_at(jg), dl_r = lse_r + 256;
          const int q0 = qt * 64;
          const bool masked = (causal && qt == qw) || q0 + 64 > T_len;
          // per QN q rows: S^T = Ks.Q^T and dP^T = V.dO^T (SS, K-major),
          // then P^T = exp(s - lse) and dS^T = P^T o (dP^T - delta), then
          // dV += P^T.dO and dK += dS^T.Q (register A; dO and Q MN-major,
          // slice kk of 16 q rows 2048 bytes on). At D = 128 the products
          // of the first half tile run while the second half's scores are
          // issued.
#pragma unroll
          for (int hv = 0; hv < 64 / QN; ++hv) {
            __syncwarp();
            wgmma_fence();
            kmajor_product<T, D, QN>(s, my_k, L::RES_HALF, sq + hv * QN * 128);
            kmajor_product<T, D, QN>(dp, my_v, L::RES_HALF, sdo + hv * QN * 128);
            wgmma_commit();
            wgmma_wait<0>();
            wgmma_fence_operands(s);
            wgmma_fence_operands(dp);
#pragma unroll
            for (int nt = 0; nt < QN / 8; ++nt) {
              const int c = hv * QN + nt * 8 + 2 * t4;
              const float2 l = ld_shared_f2(lse_r + 4 * c);
              const float2 dl = ld_shared_f2(dl_r + 4 * c);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int col = q0 + c + (e & 1);
                const int row = e < 2 ? row_a : row_b;
                float x = s[nt * 4 + e];
                if (masked && (col >= T_len || (causal && col < row))) x = NEG_BIG;
                const float p = ex2(fmaf(x, LOG2E, -(e & 1 ? l.y : l.x) * LOG2E));
                s[nt * 4 + e] = p;
                dp[nt * 4 + e] = p * (dp[nt * 4 + e] - (e & 1 ? dl.y : dl.x));
              }
            }
            pack_frags<T, QN>(pf, s);
            pack_frags<T, QN>(dsf, dp);
            wgmma_fence_operands(dk);
            wgmma_fence_operands(dv);
            __syncwarp();
            wgmma_fence();
            uint32_t sq_ = sq + hv * QN * 128, sdo_ = sdo + hv * QN * 128;
            opaque(sq_);
            opaque(sdo_);
#pragma unroll
            for (int kk = 0; kk < QN / 16; ++kk)
              WgmmaRS<T, D, 1>::run(dv, pf[kk], wgmma_desc(sdo_ + kk * 2048, L::BOX, 1024), 1);
#pragma unroll
            for (int kk = 0; kk < QN / 16; ++kk)
              WgmmaRS<T, D, 1>::run(dk, dsf[kk], wgmma_desc(sq_ + kk * 2048, L::BOX, 1024), 1);
            wgmma_commit();
          }
          wgmma_wait<0>();
          wgmma_fence_operands(dk);
          wgmma_fence_operands(dv);
        }
        arrive(empty_r(jg));
      }
      if (active) {
        // dK x scale and dV, rounded, into this warpgroup's K and V rows;
        // the TMA stores drop rows past T
        unsigned char* k_rows = smem + kvbuf(u) + r0 * 128;
        stage_rows<T, D>(k_rows, L::RES_HALF, dk, scale, warp, g, t4);
        stage_rows<T, D>(k_rows + L::RES_BYTES, L::RES_HALF, dv, 1.f, warp, g, t4);
        fence_proxy_async();
        named_barrier(1 + wg, WG_THREADS);
        if (tid == 0) {
          for (int hf = 0; hf < L::HALVES; ++hf) {
            tma_store_4d(&tm_dk, my_k + hf * L::RES_HALF, hf * 64, kh, kw, b);
            tma_store_4d(&tm_dv, my_v + hf * L::RES_HALF, hf * 64, kh, kw, b);
          }
          tma_store_wait();
        }
        named_barrier(1 + wg, WG_THREADS);
      }
      arrive(empty_kv(u));   // the kv buffer may take tile u + 2
      base += n_it;
    }
  }
}

// ------------------------------------------------- B3 at D = 256: a role split
//
// dK and dV of 64 keys at 256 columns are 256 f32 registers a thread, past
// the 255 a thread can hold, so at D = 256 a block's two consumer
// warpgroups share one tile of 64 keys and split the work by role, each
// with one 128-register accumulator:
//  * the dV warpgroup computes S^T = Ks.Q^T and P^T = exp(S^T - lse),
//    hands P^T in f32 to the other through shared memory, and accumulates
//    dV += P^T.dO;
//  * the dK warpgroup computes dP^T = V.dO^T, takes P^T, forms dS^T =
//    P^T o (dP^T - delta) and accumulates dK += dS^T.Q.
// The products are those of the two-consumer kernel above (none is done
// twice); only P^T crosses between the warpgroups, 16 KB a q tile through
// two slots. K and V (64 KB) have one buffer; Q and dO stream through two
// stages of 64 rows (128 KB). Each warpgroup stores its result through the
// resident tile it alone reads: dV through K's rows, dK through V's.
struct DkvSplitTiles {
  static constexpr int D = 256;
  static constexpr int CONSUMERS = 2;               // the dV and the dK warpgroup
  static constexpr int THREADS = 3 * WG_THREADS;    // the producer's last
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = 232;
  static constexpr int HALVES = D / 64;             // 64-column boxes a row
  static constexpr int BOX = 64 * 128;              // bytes of a box of 64 rows
  static constexpr int TILE_BYTES = HALVES * BOX;   // 64 rows of K, V, Q or dO
  static constexpr int STAGES = 2;
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;   // Q, then dO
  static constexpr int P_BYTES = 64 * 64 * 4;          // P^T of 64 keys x 64 q rows, f32
  static constexpr int ROWS = 2 * TILE_BYTES + STAGES * STAGE_BYTES;
  static constexpr int PX = ROWS + STAGES * 2 * 64 * 4;   // after each stage's lse and delta
  static constexpr int BARRIERS = PX + 2 * P_BYTES;
  // mbarriers: full and empty of K/V, of each stage, of each P slot | tile index
  static constexpr int SMEM = BARRIERS + 8 * (2 + 2 * STAGES + 4) + 8 + 1024;
  static constexpr int HEAD_GROUP = 16;
  static_assert(SMEM <= 232448, "the SM's shared memory");
};

template <typename T>
__global__ void __launch_bounds__(DkvSplitTiles::THREADS, 1)
bwd_dkv_split_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_lse,
                     const __grid_constant__ CUtensorMap tm_delta,
                     const __grid_constant__ CUtensorMap tm_dk,
                     const __grid_constant__ CUtensorMap tm_dv, int* __restrict__ next_tile,
                     int T_len, int H, int KH, int B, float scale, int causal) {
  using L = DkvSplitTiles;
  constexpr int D = L::D;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = smem_u32(smem);   // K, then V
  const uint32_t bars = s0 + L::BARRIERS;
  volatile int* tile_slot =
      reinterpret_cast<volatile int*>(smem + L::BARRIERS + 8 * (2 + 2 * L::STAGES + 4));
  // the block's u-th tile holds K/V in phase u & 1; q tile j (counted over
  // every tile the block takes) sits in stage j % STAGES, in phase
  // (j / STAGES) & 1; P^T of the n-th q tile a warpgroup multiplies sits in
  // slot n % 2, in phase (n / 2) & 1
  const uint32_t full_kv = bars, empty_kv = bars + 8;
  auto stage = [](int j) { return 2 * L::TILE_BYTES + (j % L::STAGES) * L::STAGE_BYTES; };
  auto rows_at = [](int j) { return L::ROWS + (j % L::STAGES) * 2 * 64 * 4; };
  auto parity = [](int j) { return (uint32_t)(j / L::STAGES) & 1; };
  auto full_r = [&](int j) { return bars + 8 * (2 + j % L::STAGES); };
  auto empty_r = [&](int j) { return bars + 8 * (2 + L::STAGES + j % L::STAGES); };
  auto full_p = [&](int n) { return bars + 8 * (2 + 2 * L::STAGES + n % 2); };
  auto empty_p = [&](int n) { return bars + 8 * (4 + 2 * L::STAGES + n % 2); };

  const int rep = H / KH;
  const int n_kt = (T_len + 63) / 64;   // key tiles of 64
  const int n_tiles = n_kt * KH * B;
  const int n_qt = (T_len + 63) / 64;   // q tiles of 64
  auto tile_of = [&](int i, int& k0, int& kh, int& b, int& q_first) {
    const int group = i / (n_kt * L::HEAD_GROUP);
    const int first = group * L::HEAD_GROUP;
    const int size = min(L::HEAD_GROUP, KH * B - first);
    const int w = i - group * n_kt * L::HEAD_GROUP;
    k0 = (w / size) * 64;   // under a causal mask the first keys see the most rows
    kh = (first + w % size) % KH;
    b = (first + w % size) / KH;
    q_first = causal ? k0 / 64 : 0;   // earlier q tiles see none of these keys
  };

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    mbar_init(empty_kv, 4 * L::CONSUMERS);   // lane 0 of each consumer warp
    for (int j = 0; j < L::STAGES; ++j) {
      mbar_init(full_r(j), 1);
      mbar_init(empty_r(j), 4 * L::CONSUMERS);
    }
    for (int n = 0; n < 2; ++n) {
      mbar_init(full_p(n), WG_THREADS);    // every thread of the dV warpgroup
      mbar_init(empty_p(n), WG_THREADS);   // every thread of the dK warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == L::CONSUMERS) {
    // ---- producer
    setmaxnreg_dec<L::PRODUCER_REGS>();
    if (threadIdx.x == L::CONSUMERS * WG_THREADS) {
      int base = 0;
      for (int u = 0;; ++u) {
        mbar_wait(empty_kv, (u & 1) ^ 1);
        const int i = atomicAdd(next_tile, 1);
        tile_slot[0] = i;   // published by the arrival on full_kv
        if (i >= n_tiles) {
          mbar_arrive(full_kv);
          break;
        }
        int k0, kh, b, q_first;
        tile_of(i, k0, kh, b, q_first);
        mbar_expect_tx(full_kv, 2 * L::TILE_BYTES);
        for (int hf = 0; hf < L::HALVES; ++hf) {
          tma_load_4d(s0 + hf * L::BOX, &tm_k, full_kv, hf * 64, kh, k0, b);
          tma_load_4d(s0 + L::TILE_BYTES + hf * L::BOX, &tm_v, full_kv, hf * 64, kh, k0, b);
        }
        // for each member of the group, each q tile from the first visible
        const int per_head = n_qt - q_first, n_it = rep * per_head;
        for (int it = 0; it < n_it; ++it) {
          const int jg = base + it;
          const int hh = kh * rep + it / per_head, q0 = (q_first + it % per_head) * 64;
          mbar_wait(empty_r(jg), parity(jg) ^ 1);
          const uint32_t full = full_r(jg), st = s0 + stage(jg);
          mbar_expect_tx(full, L::STAGE_BYTES + 2 * 64 * 4);
          for (int hf = 0; hf < L::HALVES; ++hf) {
            tma_load_4d(st + hf * L::BOX, &tm_q, full, hf * 64, hh, q0, b);
            tma_load_4d(st + L::TILE_BYTES + hf * L::BOX, &tm_do, full, hf * 64, hh, q0, b);
          }
          const uint32_t rows = s0 + rows_at(jg);
          tma_load_2d(rows, &tm_lse, full, q0, b * H + hh);
          tma_load_2d(rows + 256, &tm_delta, full, q0, b * H + hh);
        }
        base += n_it;
      }
    }
  } else {
    // ---- consumers: warpgroup 0 accumulates dV, warpgroup 1 dK, of the
    // tile's 64 keys
    setmaxnreg_inc<L::CONSUMER_REGS>();
    const int tid = threadIdx.x % WG_THREADS, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const bool dv_role = wg == 0;
    auto arrive = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
      __syncwarp();
    };
    float acc[D / 2], s[32];   // dV or dK; S^T (then P^T) or dP^T (then dS^T) of 64 q rows
    uint32_t f[4][4];          // P^T or dS^T: the A fragment of each 16 q rows
    float(&acc_lo)[64] = *reinterpret_cast<float(*)[64]>(acc);
    float(&acc_hi)[64] = *reinterpret_cast<float(*)[64]>(acc + 64);
    const uint32_t my_k = s0, my_v = s0 + L::TILE_BYTES;
    int base = 0, n = 0;
    for (int u = 0;; ++u) {
      mbar_wait(full_kv, u & 1);
      const int i = tile_slot[0];
      if (i >= n_tiles) break;
      int k0, kh, b, q_first;
      tile_of(i, k0, kh, b, q_first);
      const int per_head = n_qt - q_first, n_it = rep * per_head;
      const int row_a = k0 + warp * 16 + g, row_b = row_a + 8;   // key rows of this thread
      if (dv_role) {
        // Ks = (k * scale).astype(k.dtype), in place (only this warpgroup
        // reads K), made visible to wgmma
        scale_rows<T, D>(smem, L::BOX, scale, tid);
        fence_proxy_async();
        named_barrier(1 + wg, WG_THREADS);
      }
#pragma unroll
      for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
      for (int it = 0; it < n_it; ++it) {
        const int jg = base + it;
        const int qt = q_first + it % per_head;
        mbar_wait(full_r(jg), parity(jg));
        {
          const uint32_t sq = s0 + stage(jg), sdo = sq + L::TILE_BYTES;
          const uint32_t lse_r = s0 + rows_at(jg), dl_r = lse_r + 256;
          const int q0 = qt * 64;
          const bool masked = (causal && qt == q_first) || q0 + 64 > T_len;
          float* px = reinterpret_cast<float*>(smem + L::PX + (n % 2) * L::P_BYTES);
          // S^T = Ks.Q^T (dV) or dP^T = V.dO^T (dK), 64 x 64, both K-major
          wgmma_fence_operands(acc);
          __syncwarp();
          wgmma_fence();
          kmajor_product<T, D, 64>(s, dv_role ? my_k : my_v, L::BOX, dv_role ? sq : sdo);
          wgmma_commit();
          wgmma_wait<0>();   // and the previous tile's dV or dK
          wgmma_fence_operands(s);
          wgmma_fence_operands(acc);
          if (dv_role) {
            // P^T = exp(S^T - lse), to the dK warpgroup in f32 (thread by
            // thread: the other warpgroup's thread tid holds dP^T's same
            // elements), then rounded for P^T.dO
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              const int c = nt * 8 + 2 * t4;
              const float2 l = ld_shared_f2(lse_r + 4 * c);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int col = q0 + c + (e & 1);
                const int row = e < 2 ? row_a : row_b;
                float x = s[nt * 4 + e];
                if (masked && (col >= T_len || (causal && col < row))) x = NEG_BIG;
                s[nt * 4 + e] = ex2(fmaf(x, LOG2E, -(e & 1 ? l.y : l.x) * LOG2E));
              }
            }
            mbar_wait(empty_p(n), ((n / 2) & 1) ^ 1);
#pragma unroll
            for (int x = 0; x < 32; ++x) px[x * WG_THREADS + tid] = s[x];
            mbar_arrive(full_p(n));
            pack_frags<T, 64>(f, s);
          } else {
            // dS^T = P^T o (dP^T - delta)
            mbar_wait(full_p(n), (n / 2) & 1);
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              const float2 dl = ld_shared_f2(dl_r + 4 * (nt * 8 + 2 * t4));
#pragma unroll
              for (int e = 0; e < 4; ++e)
                s[nt * 4 + e] = px[(nt * 4 + e) * WG_THREADS + tid] *
                                (s[nt * 4 + e] - (e & 1 ? dl.y : dl.x));
            }
            mbar_arrive(empty_p(n));
            pack_frags<T, 64>(f, s);
          }
          // dV += P^T.dO or dK += dS^T.Q: register A, dO or Q MN-major (slice
          // kk of 16 q rows 2048 bytes on), 128 columns a product
          uint32_t src = dv_role ? sdo : sq;
          opaque(src);
          __syncwarp();
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            WgmmaRS<T, 128, 1>::run(acc_lo, f[kk], wgmma_desc(src + kk * 2048, L::BOX, 1024), 1);
            WgmmaRS<T, 128, 1>::run(acc_hi, f[kk],
                                    wgmma_desc(src + 2 * L::BOX + kk * 2048, L::BOX, 1024), 1);
          }
          wgmma_commit();
          ++n;
        }
        // the stage is free once this warpgroup's products have read it
        wgmma_wait<0>();
        wgmma_fence_operands(acc);
        arrive(empty_r(jg));
      }
      // dV into K's rows (read only by the dV warpgroup), dK x scale into
      // V's rows (read only by the dK warpgroup); the TMA stores drop rows
      // past T
      const uint32_t rows = dv_role ? my_k : my_v;
      stage_rows<T, D>(smem + (dv_role ? 0 : L::TILE_BYTES), L::BOX, acc,
                       dv_role ? 1.f : scale, warp, g, t4);
      fence_proxy_async();
      named_barrier(1 + wg, WG_THREADS);
      if (tid == 0) {
        for (int hf = 0; hf < L::HALVES; ++hf)
          tma_store_4d(dv_role ? &tm_dv : &tm_dk, rows + hf * L::BOX, hf * 64, kh, k0, b);
        tma_store_wait();
      }
      named_barrier(1 + wg, WG_THREADS);
      arrive(empty_kv);   // K and V may take tile u + 1
      base += n_it;
    }
  }
}

// ------------------------------------------------------------ float32 path

constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// dq: one warp per query row, each lane holding D/32 columns; a column past
// Dv reads column Dv - 1 times a zero q and dO and is not written
template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ o,
                  const float* __restrict__ dout, const float* __restrict__ lse,
                  float* __restrict__ delta, float* __restrict__ dq, int T_len,
                  int H, int KH, int Dv, Strides st, float scale, int causal) {
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
  int col[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const bool live = lane + 32 * i < Dv;
    col[i] = min(lane + 32 * i, Dv - 1);
    qv[i] = live ? qr[col[i]] * scale : 0.f;
    dov[i] = live ? dr[col[i]] : 0.f;
    dl += live ? dov[i] * orow[col[i]] : 0.f;
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
      s = fmaf(qv[i], kr[col[i]], s);
      dp = fmaf(dov[i], vr[col[i]], dp);
    }
    s = warp_sum(s);
    dp = warp_sum(dp);
    const float ds = __expf(s - L) * (dp - dl);
#pragma unroll
    for (int i = 0; i < E; ++i) acc[i] = fmaf(ds, kr[col[i]], acc[i]);
  }
  float* out = dq + (((long long)b * T_len + row) * H + h) * Dv;
#pragma unroll
  for (int i = 0; i < E; ++i)
    if (lane + 32 * i < Dv) out[lane + 32 * i] = acc[i] * scale;
}

// dk/dv: one warp per key row, looping over the GQA group and the query
// rows that see it; a column past Dv reads column Dv - 1 times a zero k and
// v and is not written
template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dk, float* __restrict__ dv, int T_len,
                   int H, int KH, int Dv, Strides st, float scale, int causal) {
  constexpr int E = D / 32;
  const int row = blockIdx.x * NUM_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kh = blockIdx.y, b = blockIdx.z;
  if (row >= T_len) return;
  const int rep = H / KH;
  const float* kr = k + b * st.k_b + (long long)row * st.k_t + kh * st.k_h;
  const float* vr = v + b * st.v_b + (long long)row * st.v_t + kh * st.v_h;
  float ks[E], vv[E], dka[E], dva[E];
  int col[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const bool live = lane + 32 * i < Dv;
    col[i] = min(lane + 32 * i, Dv - 1);
    ks[i] = live ? kr[col[i]] * scale : 0.f;
    vv[i] = live ? vr[col[i]] : 0.f;
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
        qv[i] = qr[col[i]];
        dov[i] = dr[col[i]];
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
  const long long off = (((long long)b * T_len + row) * KH + kh) * Dv;
  float *dkr = dk + off, *dvr = dv + off;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    if (lane + 32 * i >= Dv) continue;
    dkr[lane + 32 * i] = dka[i] * scale;
    dvr[lane + 32 * i] = dva[i];
  }
}

// ---------------------------------------------------------------- launches

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int* next_tile;
  int B, T_len, H, KH;
  int Dv;   // the true head dim (<= the kernel width D)
  int ld;   // lse and delta rows are ld floats apart (dk/dv)
  Strides st;
  float scale;
  int causal;
  cudaStream_t stream;
};

// per device, looked up once: the shared-memory limit of the kernel (an
// attribute) and the number of SMs (one persistent block each)
template <auto Kernel>
cudaError_t prepare(int smem, int* sms) {
  constexpr int MAX_DEVICES = 64;
  static int count[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (count[dev] == 0) {
    e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  *sms = count[dev];
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  using L = DqTiles<D>;
  const Strides& st = a.st;
  const int Dv = a.Dv;
  const long long hd = (long long)a.H * Dv;
  // maps over (Dv, heads, T, B), boxes of 64 rows (K and V: of KN); dq
  // is packed
  CUtensorMap tq, tk, tv, tdo, tdq;
  if (!make_tile_map<T>(&tq, a.q, Dv, a.H, a.T_len, a.B, st.q_h, st.q_t, st.q_b, 64) ||
      !make_tile_map<T>(&tk, a.k, Dv, a.KH, a.T_len, a.B, st.k_h, st.k_t, st.k_b, L::KN) ||
      !make_tile_map<T>(&tv, a.v, Dv, a.KH, a.T_len, a.B, st.v_h, st.v_t, st.v_b, L::KN) ||
      !make_tile_map<T>(&tdo, a.dout, Dv, a.H, a.T_len, a.B, st.do_h, st.do_t, st.do_b, 64) ||
      !make_tile_map<T>(&tdq, a.dq, Dv, a.H, a.T_len, a.B, Dv, hd, hd * a.T_len, 64))
    return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t e = prepare<bwd_dq_wgmma_kernel<T, D>>(L::SMEM, &sms);
  if (e != cudaSuccess) return e;
  const long long tiles = (long long)((a.T_len + L::BLOCK_M - 1) / L::BLOCK_M) * a.H * a.B;
  const int grid = (int)min(tiles, (long long)sms);
  bwd_dq_wgmma_kernel<T, D><<<grid, L::THREADS, L::SMEM, a.stream>>>(
      tq, tk, tv, tdo, tdq, static_cast<const T*>(a.o), a.lse, a.delta, a.next_tile, a.T_len,
      a.H, a.KH, a.B, Dv, st.o_b, st.o_t, st.o_h, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  const Strides& st = a.st;
  const int Dv = a.Dv;
  const long long kd = (long long)a.KH * Dv, rows = (long long)a.B * a.H;
  CUtensorMap tq, tk, tv, tdo, tl, tdl, tdk, tdv;
  if (!make_tile_map<T>(&tq, a.q, Dv, a.H, a.T_len, a.B, st.q_h, st.q_t, st.q_b, 64) ||
      !make_tile_map<T>(&tk, a.k, Dv, a.KH, a.T_len, a.B, st.k_h, st.k_t, st.k_b, 64) ||
      !make_tile_map<T>(&tv, a.v, Dv, a.KH, a.T_len, a.B, st.v_h, st.v_t, st.v_b, 64) ||
      !make_tile_map<T>(&tdo, a.dout, Dv, a.H, a.T_len, a.B, st.do_h, st.do_t, st.do_b, 64) ||
      !make_row_map(&tl, a.lse, a.T_len, rows, a.ld, 64) ||
      !make_row_map(&tdl, a.delta, a.T_len, rows, a.ld, 64) ||
      !make_tile_map<T>(&tdk, a.dk, Dv, a.KH, a.T_len, a.B, Dv, kd, kd * a.T_len, 64) ||
      !make_tile_map<T>(&tdv, a.dv, Dv, a.KH, a.T_len, a.B, Dv, kd, kd * a.T_len, 64))
    return cudaErrorInvalidValue;
  int sms = 0;
  if constexpr (D == 256) {
    using L = DkvSplitTiles;
    cudaError_t e = prepare<bwd_dkv_split_kernel<T>>(L::SMEM, &sms);
    if (e != cudaSuccess) return e;
    const long long tiles = (long long)((a.T_len + 63) / 64) * a.KH * a.B;
    const int grid = (int)min(tiles, (long long)sms);
    bwd_dkv_split_kernel<T><<<grid, L::THREADS, L::SMEM, a.stream>>>(
        tq, tk, tv, tdo, tl, tdl, tdk, tdv, a.next_tile, a.T_len, a.H, a.KH, a.B, a.scale,
        a.causal);
  } else {
    using L = DkvTiles<D>;
    cudaError_t e = prepare<bwd_dkv_wgmma_kernel<T, D>>(L::SMEM, &sms);
    if (e != cudaSuccess) return e;
    const long long tiles = (long long)((a.T_len + L::BLOCK_M - 1) / L::BLOCK_M) * a.KH * a.B;
    const int grid = (int)min(tiles, (long long)sms);
    bwd_dkv_wgmma_kernel<T, D><<<grid, L::THREADS, L::SMEM, a.stream>>>(
        tq, tk, tv, tdo, tl, tdl, tdk, tdv, a.next_tile, a.T_len, a.H, a.KH, a.B, a.scale,
        a.causal);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_f32(const Args& a) {
  dim3 grid((a.T_len + NUM_WARPS - 1) / NUM_WARPS, a.H, a.B);
  bwd_dq_f32_kernel<D><<<grid, NUM_THREADS, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.o),
      static_cast<const float*>(a.dout), a.lse, a.delta, static_cast<float*>(a.dq), a.T_len,
      a.H, a.KH, a.Dv, a.st, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const Args& a) {
  dim3 grid((a.T_len + NUM_WARPS - 1) / NUM_WARPS, a.KH, a.B);
  bwd_dkv_f32_kernel<D><<<grid, NUM_THREADS, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.T_len, a.H, a.KH, a.Dv, a.st,
      a.scale, a.causal);
  return cudaGetLastError();
}


bool bad_shape(int B, int T_len, int H, int KH, int D, int Dv) {
  return B <= 0 || T_len <= 0 || H <= 0 || KH <= 0 || H % KH || Dv < 1 || Dv > D;
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16. D is the kernel width (64, 128
// or 256), Dv the true head dim (1 <= Dv <= D, rows of Dv elements whole
// 16-byte chunks). Strides (in elements, 15 of them: q, k, v, o, dO, each
// batch/time/head) with a contiguous head dim; for 16-bit inputs every base
// 16-byte aligned and every stride a multiple of 8 elements (TMA's rules).
// lse and delta are [B, H, T] float32, contiguous; dq is a contiguous
// [B, T, H, Dv]. next_tile is a zeroed int32, the persistent 16-bit
// kernel's tile counter. Writes delta = rowsum(dO o O) for the dk/dv
// kernel.
extern "C" int dstt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, void* next_tile, int B, int T_len, int H, int KH,
    int D, int Dv, long long q_b, long long q_t, long long q_h, long long k_b, long long k_t,
    long long k_h, long long v_b, long long v_t, long long v_h, long long o_b,
    long long o_t, long long o_h, long long do_b, long long do_t, long long do_h,
    float scale, int causal, int dtype, void* stream) {
  if (bad_shape(B, T_len, H, KH, D, Dv)) return (int)cudaErrorInvalidValue;
  const Strides st{q_b, q_t, q_h, k_b, k_t, k_h, v_b, v_t, v_h, o_b, o_t, o_h, do_b, do_t, do_h};
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta),
               dq, nullptr, nullptr, static_cast<int*>(next_tile), B, T_len, H, KH, Dv, T_len,
               st, scale, causal, static_cast<cudaStream_t>(stream)};
  if (dtype == 2 && D == 64) return (int)launch_dq<__nv_bfloat16, 64>(a);
  if (dtype == 2 && D == 128) return (int)launch_dq<__nv_bfloat16, 128>(a);
  if (dtype == 2 && D == 256) return (int)launch_dq<__nv_bfloat16, 256>(a);
  if (dtype == 1 && D == 64) return (int)launch_dq<__half, 64>(a);
  if (dtype == 1 && D == 128) return (int)launch_dq<__half, 128>(a);
  if (dtype == 1 && D == 256) return (int)launch_dq<__half, 256>(a);
  if (dtype == 0 && D == 64) return (int)launch_dq_f32<64>(a);
  if (dtype == 0 && D == 128) return (int)launch_dq_f32<128>(a);
  if (dtype == 0 && D == 256) return (int)launch_dq_f32<256>(a);
  return (int)cudaErrorInvalidValue;
}

// Reads q, k, v and dO (12 strides: each batch/time/head) and the delta the
// dq kernel wrote; no o. lse and delta rows are ld floats apart: T for f32
// inputs, T rounded up to a multiple of 4 (TMA's 16 bytes) for 16-bit ones.
// dk and dv are contiguous [B, T, KH, Dv]; next_tile a zeroed int32 of its
// own.
extern "C" int dstt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, void* next_tile, int B, int T_len, int H, int KH,
    int D, int Dv, int ld, long long q_b, long long q_t, long long q_h, long long k_b, long long k_t,
    long long k_h, long long v_b, long long v_t, long long v_h, long long do_b,
    long long do_t, long long do_h, float scale, int causal, int dtype, void* stream) {
  if (bad_shape(B, T_len, H, KH, D, Dv) || ld < T_len || (dtype == 0 ? ld != T_len : ld % 4))
    return (int)cudaErrorInvalidValue;
  const Strides st{q_b, q_t, q_h, k_b, k_t, k_h, v_b, v_t, v_h, 0, 0, 0, do_b, do_t, do_h};
  const Args a{q, k, v, nullptr, dout, static_cast<const float*>(lse),
               const_cast<float*>(static_cast<const float*>(delta)), nullptr, dk, dv,
               static_cast<int*>(next_tile), B, T_len, H, KH, Dv, ld, st, scale, causal,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 2 && D == 64) return (int)launch_dkv<__nv_bfloat16, 64>(a);
  if (dtype == 2 && D == 128) return (int)launch_dkv<__nv_bfloat16, 128>(a);
  if (dtype == 2 && D == 256) return (int)launch_dkv<__nv_bfloat16, 256>(a);
  if (dtype == 1 && D == 64) return (int)launch_dkv<__half, 64>(a);
  if (dtype == 1 && D == 128) return (int)launch_dkv<__half, 128>(a);
  if (dtype == 1 && D == 256) return (int)launch_dkv<__half, 256>(a);
  if (dtype == 0 && D == 64) return (int)launch_dkv_f32<64>(a);
  if (dtype == 0 && D == 128) return (int)launch_dkv_f32<128>(a);
  if (dtype == 0 && D == 256) return (int)launch_dkv_f32<256>(a);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dstt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
