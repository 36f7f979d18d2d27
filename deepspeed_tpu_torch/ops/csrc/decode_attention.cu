// Decode attention over the dense KV cache for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_decode_kernel`
// (deepspeed_tpu/ops/pallas/decode_attention.py:78, entry
// `decode_attention` :115): one query token per batch row attends the
// cache in its storage layout [B, S, KH, D] (no transpose), positions
// >= lengths[b] masked, scale applied to q in f32, all softmax math in f32,
// output acc / max(l, 1e-30) (zeros for a length-0 row).
//
// What bounds it on the H100: bytes. Each live cache position is read once
// (2.S_live.KH.D.itemsize per layer) and there are only 4.S_live.H.D
// operations, so the least time is the live K/V bytes over 3.35 TB/s.
//
// Design:
//  * one block of 8 warps per (kv head, batch row) holds the whole query
//    group of R = H / KH rows, so a GQA cache is streamed once for the group.
//  * the loop runs over positions < lengths[b] only: the dead tail of the
//    cache costs nothing. Lengths are read on the device (no host sync).
//  * each key row is read with 16-byte vector loads by D/VEC neighbouring
//    lanes; a warp covers 32/(D/VEC) keys per step and issues UNROLL steps
//    of loads before it uses any, to keep enough bytes in flight.
//  * every lane group keeps its own f32 online-softmax state; the groups
//    merge by shuffles, the warps through shared memory at the end.

#include "attention_common.cuh"

namespace {

using namespace dstt;

constexpr int NUM_WARPS = 8;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int UNROLL = 4;

struct Strides {
  long long q_b, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_h;
};

template <typename T, int D, int R>
__global__ void __launch_bounds__(NUM_THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ lengths,
              T* __restrict__ o, int S, Strides st, float scale) {
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int LPK = D / VEC;          // lanes per key row
  constexpr int KPW = 32 / LPK;         // keys per warp per step
  constexpr int STEP = NUM_WARPS * KPW; // keys per block per step
  static_assert(D % VEC == 0 && 32 % LPK == 0, "unsupported head dim");

  __shared__ float sm_m[NUM_WARPS][R];
  __shared__ float sm_l[NUM_WARPS][R];
  __shared__ float sm_acc[NUM_WARPS][R][D];

  const int kh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LPK, d0 = (lane % LPK) * VEC;
  const int len = max(0, min(lengths[b], S));

  float qv[R][VEC], acc[R][VEC], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const uint4 raw = *reinterpret_cast<const uint4*>(q + b * st.q_b + (kh * R + r) * st.q_h + d0);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      qv[r][i] = to_float(e[i]) * scale;
      acc[r][i] = 0.f;
    }
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  const T* kb = kc + b * st.k_b + kh * st.k_h + d0;
  const T* vb = vc + b * st.v_b + kh * st.v_h + d0;
  // the loop bound is uniform across the warp, so the shuffles below always
  // run with all 32 lanes; positions past len are masked instead
  for (int base = warp * KPW; base < len; base += STEP * UNROLL) {
    uint4 kr[UNROLL], vr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int pos = base + u * STEP + grp;
      kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
      if (pos < len) {
        kr[u] = *reinterpret_cast<const uint4*>(kb + pos * st.k_s);
        vr[u] = *reinterpret_cast<const uint4*>(vb + pos * st.v_s);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float s[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const T* ke = reinterpret_cast<const T*>(&kr[u]);
        float acc_s = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc_s = fmaf(qv[r][i], to_float(ke[i]), acc_s);
#pragma unroll
        for (int off = LPK / 2; off > 0; off /= 2) acc_s += __shfl_xor_sync(0xffffffffu, acc_s, off);
        s[u] = base + u * STEP + grp < len ? acc_s : -INFINITY;
      }
      float mn = m[r];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) mn = fmaxf(mn, s[u]);
      const float ref = mn == -INFINITY ? 0.f : mn;
      const float alpha = __expf(m[r] - ref);
      l[r] *= alpha;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[r][i] *= alpha;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float p = __expf(s[u] - ref);
        const T* ve = reinterpret_cast<const T*>(&vr[u]);
        l[r] += p;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[r][i] = fmaf(p, to_float(ve[i]), acc[r][i]);
      }
      m[r] = mn;
    }
  }

  // merge the lane groups of this warp (lanes that differ by multiples of LPK)
#pragma unroll
  for (int off = LPK; off < 32; off *= 2) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mn = fmaxf(m[r], mo);
      const float ref = mn == -INFINITY ? 0.f : mn;
      const float a = __expf(m[r] - ref), c = __expf(mo - ref);
      l[r] = l[r] * a + lo * c;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][i], off);
        acc[r][i] = acc[r][i] * a + ao * c;
      }
      m[r] = mn;
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
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
  for (int idx = threadIdx.x; idx < R * D; idx += NUM_THREADS) {
    const int r = idx / D, d = idx % D;
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
    o[b * st.o_b + (kh * R + r) * st.o_h + d] = from_float<T>(at / fmaxf(lt, 1e-30f));
  }
}

template <typename T, int D, int R>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* o, int B, int S, int KH,
                   const Strides& st, float scale, cudaStream_t stream) {
  dim3 grid(KH, B);
  decode_kernel<T, D, R><<<grid, NUM_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), S, st, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_r(int R, const void* q, const void* k, const void* v,
                     const int* lengths, void* o, int B, int S, int KH,
                     const Strides& st, float scale, cudaStream_t stream) {
  switch (R) {
    case 1: return launch<T, D, 1>(q, k, v, lengths, o, B, S, KH, st, scale, stream);
    case 2: return launch<T, D, 2>(q, k, v, lengths, o, B, S, KH, st, scale, stream);
    case 4: return launch<T, D, 4>(q, k, v, lengths, o, B, S, KH, st, scale, stream);
    case 8: return launch<T, D, 8>(q, k, v, lengths, o, B, S, KH, st, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_d(int D, int R, const void* q, const void* k, const void* v,
                     const int* lengths, void* o, int B, int S, int KH,
                     const Strides& st, float scale, cudaStream_t stream) {
  if (D == 64) return launch_r<T, 64>(R, q, k, v, lengths, o, B, S, KH, st, scale, stream);
  if (D == 128) return launch_r<T, 128>(R, q, k, v, lengths, o, B, S, KH, st, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16. q [B, H, D], caches [B, S, KH, D]
// and o [B, H, D] by element strides (head dim contiguous); lengths [B]
// int32 on the device.
extern "C" int dstt_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths, void* o,
    int B, int S, int H, int KH, int D, long long q_b, long long q_h,
    long long k_b, long long k_s, long long k_h, long long v_b, long long v_s,
    long long v_h, long long o_b, long long o_h, float scale, int dtype,
    void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || H % KH) return (int)cudaErrorInvalidValue;
  const Strides st{q_b, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_h};
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = H / KH;
  switch (dtype) {
    case 0: return (int)launch_d<float>(D, R, q, k, v, len, o, B, S, KH, st, scale, s);
    case 1: return (int)launch_d<__half>(D, R, q, k, v, len, o, B, S, KH, st, scale, s);
    case 2: return (int)launch_d<__nv_bfloat16>(D, R, q, k, v, len, o, B, S, KH, st, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* dstt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
