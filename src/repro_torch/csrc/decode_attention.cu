// Fused decode attention (B10) for Hopper.
//
// decode_attention_fwd replaces decode_attention_pallas (body
// _decode_kernel) in src/repro/kernels/decode_attention/decode_attention.py:
// one new token per kv-head group attends to a ring-buffer KV cache stored
// in bf16, f32 or int8 with f32 per-(token, head) scales; the cache is
// streamed in its stored type and int8 is dequantised in registers
// (x * scale), so an int8 cache moves half the bytes of a bf16 one.
//   Bound on the H100: each cache element is used by G query rows for one
//   multiply-add each (G = 1 on stablelm), ~1 operation per byte, so the
//   launch is bound by the cache read from device memory (3.35 TB/s).
//   Design, and where it differs from the TPU grid:
//   * The TPU grid walks S sequentially per (batch x kv head) with the
//     running max, sum and accumulator in VMEM.  Here one block owns
//     (batch, kv head); its 256 threads split into groups of D / 8 lanes,
//     each lane holding 8 elements of the G resident query rows.  A group
//     takes U consecutive keys at a time, so every warp has several
//     16-byte loads per lane in flight (D is 16, 64, 128 or 256); each
//     group keeps its own online softmax (max, sum, accumulator) in
//     registers, and the groups merge through shared memory once at the
//     end (flash-decoding inside one block).  No atomics; the merge order
//     is fixed.
//   * Validity is the reference's: key s is visible when s <= pos or
//     pos >= S, and with a window when (pos - s) mod S < window, in the
//     real S (nothing is padded to a tile).  Keys that are not visible are
//     never loaded, so a partly filled cache costs only its filled part.
//   * Loads use the read-only path and 16 bytes per lane for bf16 (8 for
//     int8, 2 x 16 for f32); the G x 8 query elements and the G x 8
//     accumulators of a lane live in registers.
//   expf and IEEE division, no fast math.  Untried: a split over S across
//   blocks (flash-decoding across the card) for batch-1 long contexts,
//   which here run B x Hk blocks only.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h2[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float* out) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = (float)c[j];
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename QT, typename CT, int D, int G>
__global__ void __launch_bounds__(THREADS)
decode_fwd_kernel(const QT* __restrict__ q, const CT* __restrict__ kc,
                  const CT* __restrict__ vc, const float* __restrict__ ksc,
                  const float* __restrict__ vsc, QT* __restrict__ o, int S, int Hk,
                  int pos, int window, float scale) {
  constexpr int L = D / 8;             // lanes per key
  constexpr int NG = THREADS / L;      // key groups per block
  constexpr int U = G >= 4 ? 2 : 4;    // keys per group per step
  constexpr bool QUANT = sizeof(CT) == 1;
  extern __shared__ __align__(16) float smem[];
  float* accs = smem;                  // NG x G x D partial accumulators
  float* ms = accs + NG * G * D;       // NG x G running maxima
  float* ls = ms + NG * G;             // NG x G running sums

  const int hk = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x % L, grp = threadIdx.x / L;
  const int e0 = lane * 8;
  const size_t stride = (size_t)Hk * D;  // between consecutive keys

  float qf[G][8], acc[G][8], m[G], l[G];
  const QT* qb = q + ((size_t)b * Hk + hk) * G * D;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load8(qb + g * D + e0, qf[g]);
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }
  const CT* kb = kc + ((size_t)b * S * Hk + hk) * D + e0;
  const CT* vb = vc + ((size_t)b * S * Hk + hk) * D + e0;
  const size_t sc0 = (size_t)b * S * Hk + hk;  // scale of key s: sc0 + s * Hk

  // keys past pos were never written (pos < S): nothing to read there
  const int s_end = pos >= S ? S : min(S, pos + 1);
  const int n_steps = (s_end + NG * U - 1) / (NG * U);
  for (int it = 0; it < n_steps; ++it) {  // uniform trip count: shuffles below
    const int s0 = it * NG * U + grp * U;
    float kf[U][8], vf[U][8];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u;
      bool vis = s < s_end;
      if (vis && window > 0) {
        int age = (pos - s) % S;
        if (age < 0) age += S;
        vis = age < window;
      }
      ok[u] = vis;
      if (vis) {
        load8(kb + (size_t)s * stride, kf[u]);
        load8(vb + (size_t)s * stride, vf[u]);
        if (QUANT) {
          const float a = __ldg(ksc + sc0 + (size_t)s * Hk);
          const float c = __ldg(vsc + sc0 + (size_t)s * Hk);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            kf[u][e] *= a;
            vf[u][e] *= c;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float sc[U];
      float mx = NEG_INF;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) a = fmaf(qf[g][e], kf[u][e], a);
#pragma unroll
        for (int w = L / 2; w > 0; w >>= 1) a += __shfl_xor_sync(0xffffffffu, a, w);
        sc[u] = ok[u] ? a * scale : NEG_INF;
        mx = fmaxf(mx, sc[u]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      float p[U], ps = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = ok[u] ? expf(sc[u] - m_new) : 0.f;
        ps += p[u];
      }
      l[g] = l[g] * alpha + ps;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float a = acc[g][e] * alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) a = fmaf(p[u], vf[u][e], a);
        acc[g][e] = a;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    float* dst = accs + (grp * G + g) * D + e0;
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[e] = acc[g][e];
    if (lane == 0) {
      ms[grp * G + g] = m[g];
      ls[grp * G + g] = l[g];
    }
  }
  __syncthreads();
  QT* ob = o + ((size_t)b * Hk + hk) * G * D;
  for (int idx = threadIdx.x; idx < G * D; idx += THREADS) {
    const int g = idx / D, d = idx % D;
    float mx = NEG_INF;
    for (int n = 0; n < NG; ++n) mx = fmaxf(mx, ms[n * G + g]);
    float lsum = 0.f, out = 0.f;
    for (int n = 0; n < NG; ++n) {
      const float w = expf(ms[n * G + g] - mx);
      lsum = fmaf(ls[n * G + g], w, lsum);
      out = fmaf(accs[(n * G + g) * D + d], w, out);
    }
    store1(ob + idx, out / fmaxf(lsum, 1e-30f));
  }
}

template <typename QT, typename CT, int D, int G>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, void* o, int B, int S, int Hk, int pos, int window,
                   float scale, cudaStream_t st) {
  constexpr int NG = THREADS / (D / 8);
  const size_t smem = sizeof(float) * NG * G * (D + 2);
  cudaError_t e = cudaFuncSetAttribute(decode_fwd_kernel<QT, CT, D, G>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  decode_fwd_kernel<QT, CT, D, G><<<dim3(Hk, B), THREADS, smem, st>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(k), static_cast<const CT*>(v), ks,
      vs, static_cast<QT*>(o), S, Hk, pos, window, scale);
  return cudaGetLastError();
}

template <typename QT, typename CT, int D>
cudaError_t dispatch_g(int G, const void* q, const void* k, const void* v, const float* ks,
                       const float* vs, void* o, int B, int S, int Hk, int pos, int window,
                       float scale, cudaStream_t st) {
  switch (G) {
    case 1: return launch<QT, CT, D, 1>(q, k, v, ks, vs, o, B, S, Hk, pos, window, scale, st);
    case 2: return launch<QT, CT, D, 2>(q, k, v, ks, vs, o, B, S, Hk, pos, window, scale, st);
    case 4: return launch<QT, CT, D, 4>(q, k, v, ks, vs, o, B, S, Hk, pos, window, scale, st);
    case 8: return launch<QT, CT, D, 8>(q, k, v, ks, vs, o, B, S, Hk, pos, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename QT, typename CT>
cudaError_t dispatch_d(int D, int G, const void* q, const void* k, const void* v,
                       const float* ks, const float* vs, void* o, int B, int S, int Hk,
                       int pos, int window, float scale, cudaStream_t st) {
  switch (D) {
    case 16: return dispatch_g<QT, CT, 16>(G, q, k, v, ks, vs, o, B, S, Hk, pos, window, scale, st);
    case 64: return dispatch_g<QT, CT, 64>(G, q, k, v, ks, vs, o, B, S, Hk, pos, window, scale, st);
    case 128: return dispatch_g<QT, CT, 128>(G, q, k, v, ks, vs, o, B, S, Hk, pos, window, scale, st);
    case 256: return dispatch_g<QT, CT, 256>(G, q, k, v, ks, vs, o, B, S, Hk, pos, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hk, G, D) and o in q's type (q_dtype 0: f32, 1: bf16); caches
// (B, S, Hk, D) in q's type, or int8 (cache_int8 = 1) with f32 scales
// (B, S, Hk, 1); pos the cache position of the newest token (>= S once the
// ring has wrapped); window 0 for none.  Returns cudaGetLastError().
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* k_scale, const void* v_scale, void* o,
                                    int B, int S, int Hk, int G, int D, int q_dtype,
                                    int cache_int8, int pos, int window, float scale,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  cudaError_t e;
  if (q_dtype == 0) {
    e = cache_int8 ? dispatch_d<float, int8_t>(D, G, q, k, v, ks, vs, o, B, S, Hk, pos,
                                               window, scale, st)
                   : dispatch_d<float, float>(D, G, q, k, v, ks, vs, o, B, S, Hk, pos,
                                              window, scale, st);
  } else {
    e = cache_int8
            ? dispatch_d<__nv_bfloat16, int8_t>(D, G, q, k, v, ks, vs, o, B, S, Hk, pos,
                                                window, scale, st)
            : dispatch_d<__nv_bfloat16, __nv_bfloat16>(D, G, q, k, v, ks, vs, o, B, S, Hk,
                                                       pos, window, scale, st);
  }
  return (int)e;
}
