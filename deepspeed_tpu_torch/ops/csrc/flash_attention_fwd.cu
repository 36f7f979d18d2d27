// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_fwd_kernel`
// (deepspeed_tpu/ops/pallas/flash_attention.py:65, driven by `_flash_fwd`
// :125): causal or full attention with an online softmax, O and the f32
// log-sum-exp LSE = m + log(l) as outputs. Numerics follow the TPU kernel:
// the softmax scale is folded into q in the storage dtype, P is rounded to
// the storage dtype before P.V, and m, l and the accumulator are f32 (the
// exponentials are exp2 of f32 scores times log2(e), which moves only the
// last bits of an f32 exp).
//
// What bounds it on the H100: at the prefill shapes of GPT-2 XL (D = 64,
// T = 1024) the bytes of q, k, v and o and the causal half of the
// 4.B.H.T^2.D operations take about the same least time (3.35 TB/s,
// 989 TFLOP/s bf16); at D = 128 the operations weigh as much as the bytes.
// Only wgmma reaches the tensor cores' rate, and at D = 64 the 64 exp2 a
// row and key tile cost the SM about as many cycles as the two products.
//
// Design (16-bit inputs):
//  * persistent: one block per SM takes (q tile, head, batch row) tiles from
//    a counter in global memory, the tiles of 16 heads at a time (their K/V
//    stay in L2), each head's heaviest q tile first. A block is a producer
//    warpgroup and consumer warpgroups of 64 q rows each: three at D = 64
//    (192-row tiles), two at D = 128 (128-row tiles). setmaxnreg moves
//    registers from the producer (24) to the consumers (160 or 240).
//  * One producer thread issues every copy. TMA copies tiles through 4-D
//    tensor maps over (D, heads, T, B), built on the host for each launch
//    from the tensors' strides, so q/k/v may be views of a fused
//    projection. Tiles are 128-byte swizzled rows of 64 values; a D = 128
//    row is two such boxes. Rows past T read as zero.
//  * q tiles are double-buffered, so the next tile's q lands while this one
//    is multiplied; each consumer warpgroup scales its rows in place in the
//    storage dtype and fences them to the async proxy. K and V tiles of 128
//    keys stream through two rings (4 slots each at D = 64, 2 at D = 128),
//    each slot with a full and an empty mbarrier; K runs one tile ahead of
//    V, as the consumers use them, and each is released as soon as its
//    product is done.
//  * S = Qs.K^T is wgmma m64n128k16 with both operands K-major in shared
//    memory. The online softmax runs on the f32 accumulator in registers
//    (a row's max and sum over the 4 threads that hold it); P is packed to
//    16-bit pairs and is the register A operand of O += P.V, whose B
//    operand is the V tile read MN-major (the transpose bit).
//  * Each warpgroup pipelines its tiles: Q.K^T of key tile j and P.V of key
//    tile j - 1 are issued together, and the softmax of j runs on the CUDA
//    cores while P.V of j - 1 runs on the tensor cores.
//  * Causal: each warpgroup stops at its own diagonal (and releases the
//    ring's later tiles untouched); only tiles that cross the diagonal and
//    the ragged last key tile pay for the mask. q tiles are cut back from T
//    rounded up to 64 rows, so the tile that would reach below row 0 is the
//    lightest, and its warpgroups of rows < 0 sit out.
//  * Epilogue: O times 1 / l, rounded, goes through the warpgroup's q rows
//    in shared memory to a TMA store that drops rows past T; the LSE is
//    written from registers.
// At D = 256 (GPT-J, Gemma) the tiles above do not fit the SM: a
// double-buffered 128-row q tile and two-slot rings of 128-key tiles take
// 384 KB of shared memory, and O (128 registers a thread) beside S and P of
// 128 keys exceeds setmaxnreg's 240. So `Tiles<256>` takes 64-key K/V tiles
// (S 32 and P 16 registers: O + S + P = 176), one q buffer (64 KB: the
// producer loads the next tile's q once this one's O is stored) and
// two-slot rings of 32 KB tiles: 192 KB. S = Qs.K^T is wgmma m64n64k16;
// O += P.V is two m64n128k16 a slice of 16 keys, one per 128-column half
// of V. The template width keeps D = 64 and 128 on the code they had.
// float32 inputs take a plain FMA kernel: one warp per query row.
// Head dims: the kernels are instantiated at DK = 64, 128 and 256 and take
// any true head dim Dv <= DK whose rows are whole 16-byte chunks (the
// wrapper's `head_dim_route`). The tensor maps are encoded with Dv as their innermost
// extent, so TMA reads the columns past Dv as zeros (and the mbarriers still
// count whole boxes) and the O store drops them; zero columns change
// neither q.k nor P.V. The f32 kernel reads clamped columns times a zero q
// and writes only the first Dv.
//
// C interface (route (b) of the build: nvcc -shared, loaded with ctypes):
// the launch returns cudaGetLastError() so the Python wrapper can raise.

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

using namespace dstt;

struct Strides {
  long long q_b, q_t, q_h, k_b, k_t, k_h, v_b, v_t, v_h, o_b, o_t, o_h;
};

// ------------------------------------------------- 16-bit: TMA + wgmma

constexpr int WG_THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

// 2^x, one MUFU instruction (exp2f adds range handling; subnormal results
// flush to 0, far below a bf16 P's resolution)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D> struct Tiles {
  // consumer warpgroups of 64 q rows: 3 at D = 64, where the exp2 work
  // weighs as much as the products and a third warpgroup keeps the tensor
  // cores fed; 2 at D = 128, where S, P and O take 160 registers a thread,
  // and at D = 256 (176)
  static constexpr int CONSUMERS = D == 64 ? 3 : 2;
  // keys a K/V tile: 64 at D = 256, where a 128-key tile's S and P beside
  // O would pass the consumers' 240 registers and its ring the SM
  static constexpr int BLOCK_N = D == 256 ? 64 : 128;
  // q buffers: one at D = 256 (a second would not fit beside the rings)
  static constexpr int Q_BUFS = D == 256 ? 1 : 2;
  static constexpr int BLOCK_M = 64 * CONSUMERS;   // q rows a tile
  static constexpr int THREADS = (CONSUMERS + 1) * WG_THREADS;   // the producer's last
  // registers a thread after setmaxnreg: 24 + CONSUMERS x CONSUMER_REGS
  // fits the 512 a lane of four warps (65536 a block)
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = CONSUMERS == 3 ? 160 : 240;
  static constexpr int HALVES = D / 64;            // 64-column boxes a row
  static constexpr int STAGES = D == 64 ? 4 : 2;   // depth of the K ring and the V ring
  static constexpr int Q_HALF = BLOCK_M * 128;     // bytes of one box of a q tile
  static constexpr int KV_HALF = BLOCK_N * 128;    // bytes of one box of a K or V tile
  static constexpr int Q_BYTES = HALVES * Q_HALF;
  static constexpr int KV_BYTES = HALVES * KV_HALF;
  // q buffers | K ring | V ring | mbarriers: full and empty of each q
  // buffer (room for 2), then full and empty of K and V per slot | 2 tile
  // indices
  static constexpr int BARRIERS = Q_BUFS * Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int SMEM = BARRIERS + 8 * (4 + 4 * STAGES) + 8 + 1024;   // + room to align
  static_assert(SMEM <= 232448, "the SM's shared memory");
  // tiles are handed out head group by head group: the K/V of 16 heads
  // (4 MB at D = 64, 8 MB at D = 128, T = 1024) stay in L2 while every q
  // tile of those heads is taken, heaviest q tile first
  static constexpr int HEAD_GROUP = 16;
};

template <typename T, int D>
__global__ void __launch_bounds__(Tiles<D>::THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_o,
                       float* __restrict__ lse, int* __restrict__ next_tile, int T_len,
                       int H, int KH, int B, float scale, int causal) {
  using L = Tiles<D>;
  constexpr int BLOCK_N = L::BLOCK_N, QB = L::Q_BUFS;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: boxes start on that grid
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sK = sQ + QB * L::Q_BYTES;
  const uint32_t sV = sK + L::STAGES * L::KV_BYTES;
  const uint32_t bars = sQ + L::BARRIERS;
  volatile int* tile_slot =
      reinterpret_cast<volatile int*>(smem + L::BARRIERS + 8 * (4 + 4 * L::STAGES));
  // q buffer u % QB holds the block's u-th tile, in phase (u / QB) & 1
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

  // persistent: each block takes tiles from a counter until none is left
  const int n_qt = (T_len + L::BLOCK_M - 1) / L::BLOCK_M;
  const int n_tiles = n_qt * H * B;
  // q tiles are cut back from T rounded up to 64 rows, so the tile that
  // would stick out past row 0 is the first, the lightest under a causal
  // mask, and its warpgroups of rows < 0 sit out
  const int T64 = (T_len + 63) / 64 * 64;
  auto tile_of = [&](int i, int& q0, int& h, int& b, int& n_kt) {
    const int group = i / (n_qt * L::HEAD_GROUP);
    const int first = group * L::HEAD_GROUP;
    const int size = min(L::HEAD_GROUP, H * B - first);
    const int w = i - group * n_qt * L::HEAD_GROUP;
    q0 = T64 - (1 + w / size) * L::BLOCK_M;   // heaviest first
    h = (first + w % size) % H;
    b = (first + w % size) / H;
    n_kt = (T_len + BLOCK_N - 1) / BLOCK_N;   // through the diagonal when causal
    if (causal) n_kt = min(n_kt, (q0 + L::BLOCK_M - 1) / BLOCK_N + 1);
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
    // ---- producer: one thread takes tiles and keeps q and the rings full
    setmaxnreg_dec<L::PRODUCER_REGS>();
    if (threadIdx.x == L::CONSUMERS * WG_THREADS) {
      int base = 0;
      for (int u = 0;; ++u) {
        // the q buffer of tile u - QB is free once its O has been stored
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
        // the rows of each warpgroup that has rows >= 0, 64 at a time (full
        // boxes, rows past T included)
        const int w0 = q0 < 0 ? -q0 / 64 : 0;
        mbar_expect_tx(full_q(u), (L::CONSUMERS - w0) * 64 * D * 2);
        for (int w = w0; w < L::CONSUMERS; ++w)
          for (int hf = 0; hf < L::HALVES; ++hf)
            tma_load_4d(sQ + (u % QB) * L::Q_BYTES + hf * L::Q_HALF + w * 64 * 128, &tm_q,
                        full_q(u), hf * 64, h, q0 + 64 * w, b);
        // key tile j of one ring, once its slot's previous tile is released
        auto load = [&](const CUtensorMap* map, uint32_t ring, bool is_k, int j) {
          const int jg = base + j;
          mbar_wait(is_k ? empty_k(jg) : empty_v(jg), parity(jg) ^ 1);
          const uint32_t full = is_k ? full_k(jg) : full_v(jg);
          mbar_expect_tx(full, L::KV_BYTES);
          for (int hf = 0; hf < L::HALVES; ++hf)
            tma_load_4d(ring + slot(jg) * L::KV_BYTES + hf * L::KV_HALF, map, full, hf * 64, kh,
                        j * BLOCK_N, b);
        };
        // K runs one tile ahead of V, in the order the consumers take them
        load(&tm_k, sK, true, 0);
        for (int j = 1; j < n_kt; ++j) {
          load(&tm_k, sK, true, j);
          load(&tm_v, sV, false, j - 1);
        }
        load(&tm_v, sV, false, n_kt - 1);
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
    };
    float o[D / 2];
    float m_r[2], l_r[2];   // running row max (times log2(e)); per-thread partial sums
    float s[BLOCK_N / 2];   // S of key tile j, then its P in f32
    uint32_t pf[BLOCK_N / 16][4];   // P of key tile j - 1: the A fragment of each 16 keys
    float alpha[2];
    int base = 0;
    for (int u = 0;; ++u) {
      mbar_wait(full_q(u), (u / QB) & 1);
      const int i = tile_slot[u % QB];
      if (i >= n_tiles) break;
      int q0, h, b, n_kt;
      tile_of(i, q0, h, b, n_kt);
      const uint32_t my_q = sQ + (u % QB) * L::Q_BYTES + r0 * 128;   // its rows in each box
      // key tiles this warpgroup multiplies: through its own diagonal, none
      // when its rows lie before row 0; it still releases every tile of the
      // ring
      int n_wg = causal ? min(n_kt, (q0 + r0 + 63) / BLOCK_N + 1) : n_kt;
      if (q0 + r0 < 0) n_wg = 0;
      if (n_wg == 0) {
        arrive(empty_q(u));
      } else {
        // Qs = (q * scale).astype(q.dtype), in place (elementwise: the
        // swizzle does not matter), then made visible to wgmma
#pragma unroll
        for (int hf = 0; hf < L::HALVES; ++hf) {
          uint4* p =
              reinterpret_cast<uint4*>(smem + (u % QB) * L::Q_BYTES + hf * L::Q_HALF + r0 * 128);
#pragma unroll
          for (int x = tid; x < 64 * 128 / 16; x += WG_THREADS) {
            uint4 raw = p[x];
            T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
            for (int y = 0; y < 8; ++y) e[y] = from_float<T>(to_float(e[y]) * scale);
            p[x] = raw;
          }
        }
        fence_proxy_async();
        named_barrier(1 + wg, WG_THREADS);

        // accumulator layout of m64nN: element 4i + e of a thread sits at
        // row 16 warp + g (+8 for e >= 2), column 8i + 2 t4 + (e & 1)
        const int row_a = q0 + r0 + warp * 16 + g, row_b = row_a + 8;
#pragma unroll
        for (int x = 0; x < D / 2; ++x) o[x] = 0.f;
        m_r[0] = m_r[1] = -INFINITY;
        l_r[0] = l_r[1] = 0.f;

        // S = Qs . K^T, 64 x BLOCK_N: both operands K-major; slice kk of 16
        // columns is 32 bytes into the rows of box kk / 4
        auto issue_qk = [&](int jg) {
          const uint32_t kt = sK + slot(jg) * L::KV_BYTES;
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint64_t da = wgmma_desc(my_q + (kk / 4) * L::Q_HALF + (kk % 4) * 32, 16, 1024);
            const uint64_t db = wgmma_desc(kt + (kk / 4) * L::KV_HALF + (kk % 4) * 32, 16, 1024);
            if constexpr (BLOCK_N == 128) {
              wgmma_ss_m64n128k16<T, 0, 0>(s, da, db, kk > 0);
            } else if (kk == 0) {
              wgmma_ss_m64n64k16<T, 0, 0, true>(s, da, db);
            } else {
              wgmma_ss_m64n64k16<T, 0, 0>(s, da, db);
            }
          }
          wgmma_commit();
        };
        // O += P . V: V is MN-major (D contiguous); slice kk of 16 keys is 16
        // rows = 2048 bytes on, the next 64-column box KV_HALF bytes on
        auto issue_pv = [&](int jg) {
          const uint32_t vt = sV + slot(jg) * L::KV_BYTES;
#pragma unroll
          for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
            if constexpr (D == 256) {
              // O's 128-column halves (V's boxes 0-1 and 2-3), each the
              // accumulator of one m64n128k16: registers 4i + e of the
              // m64n256 layout, column 8i + 2 t4 + (e & 1), are the same
              float(&o_lo)[64] = *reinterpret_cast<float(*)[64]>(o);
              float(&o_hi)[64] = *reinterpret_cast<float(*)[64]>(o + 64);
              WgmmaRS<T, 128, 1>::run(o_lo, pf[kk], wgmma_desc(vt + kk * 2048, L::KV_HALF, 1024), 1);
              WgmmaRS<T, 128, 1>::run(o_hi, pf[kk],
                                      wgmma_desc(vt + 2 * L::KV_HALF + kk * 2048, L::KV_HALF, 1024), 1);
            } else {
              WgmmaRS<T, D, 1>::run(o, pf[kk], wgmma_desc(vt + kk * 2048, L::KV_HALF, 1024), 1);
            }
          }
          wgmma_commit();
        };
        // mask, new running max, rescale factor alpha, S -> P in place, l
        auto softmax = [&](int j) {
          const int k0 = j * BLOCK_N;
          if ((causal && k0 + BLOCK_N - 1 > q0 + r0) || k0 + BLOCK_N > T_len) {
#pragma unroll
            for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int col = k0 + nt * 8 + 2 * t4 + (e & 1);
                const int row = e < 2 ? row_a : row_b;
                if (col >= T_len || (causal && col > row)) s[nt * 4 + e] = -INFINITY;
              }
            }
          }
          float rm[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
            rm[0] = fmaxf(rm[0], fmaxf(s[nt * 4], s[nt * 4 + 1]));
            rm[1] = fmaxf(rm[1], fmaxf(s[nt * 4 + 2], s[nt * 4 + 3]));
          }
          float bias[2], rs[2] = {0.f, 0.f};
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            rm[x] = fmaxf(rm[x], __shfl_xor_sync(0xffffffffu, rm[x], 1));
            rm[x] = fmaxf(rm[x], __shfl_xor_sync(0xffffffffu, rm[x], 2));
            const float mx = fmaxf(m_r[x], rm[x] * LOG2E);
            bias[x] = mx == -INFINITY ? 0.f : mx;
            alpha[x] = ex2(m_r[x] - bias[x]);
            m_r[x] = mx;
          }
#pragma unroll
          for (int x = 0; x < BLOCK_N / 2; ++x) {
            s[x] = ex2(fmaf(s[x], LOG2E, -bias[(x / 2) % 2]));
            rs[(x / 2) % 2] += s[x];
          }
          l_r[0] = l_r[0] * alpha[0] + rs[0];
          l_r[1] = l_r[1] * alpha[1] + rs[1];
        };
        // after P.V of key tile j - 1 has finished: O *= alpha, P of j packed
        auto rescale_and_pack = [&]() {
#pragma unroll
          for (int x = 0; x < D / 2; ++x) o[x] *= alpha[(x / 2) % 2];
#pragma unroll
          for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
            pf[nt / 2][(nt % 2) * 2 + 0] = pack2<T>(s[nt * 4], s[nt * 4 + 1]);
            pf[nt / 2][(nt % 2) * 2 + 1] = pack2<T>(s[nt * 4 + 2], s[nt * 4 + 3]);
          }
        };

        // Software pipeline within the warpgroup: Q.K^T of key tile j and
        // P.V of key tile j - 1 are issued together, and the softmax of j
        // runs on the CUDA cores while P.V of j - 1 runs on the tensor cores.
        mbar_wait(full_k(base), parity(base));
        wgmma_fence_operands(s);
        wgmma_fence();
        issue_qk(base);
        wgmma_wait<0>();
        wgmma_fence_operands(s);
        arrive(empty_k(base));
        softmax(0);
        rescale_and_pack();
        for (int j = 1; j < n_wg; ++j) {
          const int jg = base + j;
          mbar_wait(full_k(jg), parity(jg));
          mbar_wait(full_v(jg - 1), parity(jg - 1));
          wgmma_fence_operands(s);
          wgmma_fence_operands(o);
          wgmma_fence();
          issue_qk(jg);
          issue_pv(jg - 1);
          wgmma_wait<1>();   // S of key tile j is ready; P.V of j - 1 runs on
          wgmma_fence_operands(s);
          arrive(empty_k(jg));
          softmax(j);
          wgmma_wait<0>();
          wgmma_fence_operands(o);
          arrive(empty_v(jg - 1));
          rescale_and_pack();
        }
        const int jl = base + n_wg - 1;
        mbar_wait(full_v(jl), parity(jl));
        wgmma_fence_operands(o);
        wgmma_fence();
        issue_pv(jl);
        wgmma_wait<0>();
        wgmma_fence_operands(o);
        arrive(empty_v(jl));

#pragma unroll
        for (int x = 0; x < 2; ++x) {
          l_r[x] += __shfl_xor_sync(0xffffffffu, l_r[x], 1);
          l_r[x] += __shfl_xor_sync(0xffffffffu, l_r[x], 2);
        }
        // O / l, rounded, into this warpgroup's q rows (no longer read), in
        // the swizzled layout a TMA store reads; the store drops rows past T
        const int ra = warp * 16 + g;
        const float inv[2] = {1.f / l_r[0], 1.f / l_r[1]};
        unsigned char* rows = smem + (u % QB) * L::Q_BYTES + r0 * 128;
#pragma unroll
        for (int x = 0; x < D / 8; ++x) {
          const int c = x * 8 + 2 * t4, cc = c % 64;
          unsigned char* box = rows + (c / 64) * L::Q_HALF;
          const int at = (((cc / 8) ^ (ra % 8)) * 16) + (cc % 8) * 2;
          *reinterpret_cast<uint32_t*>(box + ra * 128 + at) =
              pack2<T>(o[x * 4] * inv[0], o[x * 4 + 1] * inv[0]);
          *reinterpret_cast<uint32_t*>(box + (ra + 8) * 128 + at) =
              pack2<T>(o[x * 4 + 2] * inv[1], o[x * 4 + 3] * inv[1]);
        }
        fence_proxy_async();
        named_barrier(1 + wg, WG_THREADS);
        if (tid == 0) {
          for (int hf = 0; hf < L::HALVES; ++hf)
            tma_store_4d(&tm_o, my_q + hf * L::Q_HALF, hf * 64, h, q0 + r0, b);
          tma_store_wait();
        }
        named_barrier(1 + wg, WG_THREADS);
        arrive(empty_q(u));   // the q buffer may take tile u + 2
        if (t4 == 0) {
          float* lb = lse + ((long long)b * H + h) * T_len;
          if (row_a < T_len) lb[row_a] = m_r[0] * LN2 + logf(l_r[0]);
          if (row_b < T_len) lb[row_b] = m_r[1] * LN2 + logf(l_r[1]);
        }
      }
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

template <typename T, int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         float* lse, int* next_tile, int B, int T_len, int H, int KH,
                         int Dv, const Strides& st, float scale, int causal,
                         cudaStream_t stream) {
  using L = Tiles<D>;
  // maps over (Dv, heads, T, B): q in boxes of 64 rows, k/v in tiles of
  // BLOCK_N keys, o stored 64 rows (one warpgroup) at a time
  CUtensorMap tq, tk, tv, to;
  if (!make_tile_map<T>(&tq, q, Dv, H, T_len, B, st.q_h, st.q_t, st.q_b, 64) ||
      !make_tile_map<T>(&tk, k, Dv, KH, T_len, B, st.k_h, st.k_t, st.k_b, L::BLOCK_N) ||
      !make_tile_map<T>(&tv, v, Dv, KH, T_len, B, st.v_h, st.v_t, st.v_b, L::BLOCK_N) ||
      !make_tile_map<T>(&to, o, Dv, H, T_len, B, st.o_h, st.o_t, st.o_b, 64))
    return cudaErrorInvalidValue;
  // per device, looked up once: the shared-memory limit of the function
  // (an attribute) and the number of SMs (one persistent block each)
  constexpr int MAX_DEVICES = 64;
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    e = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  const long long tiles = (long long)((T_len + L::BLOCK_M - 1) / L::BLOCK_M) * H * B;
  const int grid = (int)min(tiles, (long long)sms[dev]);
  flash_fwd_wgmma_kernel<T, D><<<grid, L::THREADS, L::SMEM, stream>>>(
      tq, tk, tv, to, lse, next_tile, T_len, H, KH, B, scale, causal);
  return cudaGetLastError();
}

// ------------------------------------------------------------- float32

constexpr int F32_WARPS = 4;

// one warp per query row, each lane holding D/32 columns; a column past Dv
// reads column Dv - 1 times a zero q and is not written
template <int D>
__global__ void __launch_bounds__(F32_WARPS * 32)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int T_len, int H, int KH, int Dv,
                     Strides st, float scale, int causal) {
  constexpr int E = D / 32;
  const int row = blockIdx.x * F32_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= T_len) return;
  const int kh = h / (H / KH);
  const float* qr = q + b * st.q_b + (long long)row * st.q_t + h * st.q_h;
  const float* kb = k + b * st.k_b + kh * st.k_h;
  const float* vb = v + b * st.v_b + kh * st.v_h;
  float qv[E], acc[E];
  int col[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    col[i] = min(lane + 32 * i, Dv - 1);
    qv[i] = lane + 32 * i < Dv ? qr[col[i]] * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const int n_keys = causal ? row + 1 : T_len;
  for (int c = 0; c < n_keys; ++c) {
    const float* kr = kb + (long long)c * st.k_t;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) s = fmaf(qv[i], kr[col[i]], s);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
    const float mn = fmaxf(m, s);
    const float alpha = __expf(m - mn), p = __expf(s - mn);
    l = l * alpha + p;
    const float* vr = vb + (long long)c * st.v_t;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[i] = fmaf(p, vr[col[i]], acc[i] * alpha);
    m = mn;
  }
  float* orow = o + b * st.o_b + (long long)row * st.o_t + h * st.o_h;
#pragma unroll
  for (int i = 0; i < E; ++i)
    if (lane + 32 * i < Dv) orow[lane + 32 * i] = acc[i] / l;
  if (lane == 0) lse[((long long)b * H + h) * T_len + row] = m + logf(l);
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int T_len, int H, int KH, int Dv,
                       const Strides& st, float scale, int causal,
                       cudaStream_t stream) {
  dim3 grid((T_len + F32_WARPS - 1) / F32_WARPS, H, B);
  flash_fwd_f32_kernel<D><<<grid, F32_WARPS * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, T_len, H, KH,
      Dv, st, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16. D is the kernel width (64, 128
// or 256) and Dv the true head dim, 1 <= Dv <= D, rows of Dv elements whole
// 16-byte chunks. Strides are in elements; the head dim must be
// contiguous, and for 16-bit inputs the base 16-byte aligned and every
// stride a multiple of 8 elements (TMA's rules). lse is [B, H, T] float32,
// contiguous.
extern "C" int dstt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, void* next_tile, int B,
    int T_len, int H, int KH, int D, int Dv, long long q_b, long long q_t,
    long long q_h, long long k_b, long long k_t, long long k_h, long long v_b,
    long long v_t, long long v_h, long long o_b, long long o_t, long long o_h,
    float scale, int causal, int dtype, void* stream) {
  const Strides st{q_b, q_t, q_h, k_b, k_t, k_h, v_b, v_t, v_h, o_b, o_t, o_h};
  float* l = static_cast<float*>(lse);
  int* nt = static_cast<int*>(next_tile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T_len <= 0 || H <= 0 || KH <= 0 || H % KH || Dv < 1 || Dv > D)
    return (int)cudaErrorInvalidValue;
  if (dtype == 2 && D == 64) return (int)launch_wgmma<__nv_bfloat16, 64>(q, k, v, o, l, nt, B, T_len, H, KH, Dv, st, scale, causal, s);
  if (dtype == 2 && D == 128) return (int)launch_wgmma<__nv_bfloat16, 128>(q, k, v, o, l, nt, B, T_len, H, KH, Dv, st, scale, causal, s);
  if (dtype == 2 && D == 256) return (int)launch_wgmma<__nv_bfloat16, 256>(q, k, v, o, l, nt, B, T_len, H, KH, Dv, st, scale, causal, s);
  if (dtype == 1 && D == 64) return (int)launch_wgmma<__half, 64>(q, k, v, o, l, nt, B, T_len, H, KH, Dv, st, scale, causal, s);
  if (dtype == 1 && D == 128) return (int)launch_wgmma<__half, 128>(q, k, v, o, l, nt, B, T_len, H, KH, Dv, st, scale, causal, s);
  if (dtype == 1 && D == 256) return (int)launch_wgmma<__half, 256>(q, k, v, o, l, nt, B, T_len, H, KH, Dv, st, scale, causal, s);
  if (dtype == 0 && D == 64) return (int)launch_f32<64>(q, k, v, o, l, B, T_len, H, KH, Dv, st, scale, causal, s);
  if (dtype == 0 && D == 128) return (int)launch_f32<128>(q, k, v, o, l, B, T_len, H, KH, Dv, st, scale, causal, s);
  if (dtype == 0 && D == 256) return (int)launch_f32<256>(q, k, v, o, l, B, T_len, H, KH, Dv, st, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dstt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
