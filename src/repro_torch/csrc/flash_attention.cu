// Flash attention forward (B9) for Hopper.
//
// flash_attention_fwd replaces flash_attention_pallas (body _flash_kernel)
// in src/repro/kernels/flash_attention/flash_attention.py: online-softmax
// attention, causal / sliding-window / bidirectional, q rows offset by
// S - T so the last query row attends to the last kv row, f32 softmax and
// accumulation, output in q's type.
//   Bound on the H100: at the LM path's prefill shapes (T = S = 256,
//   head_dim 64) the operations per byte are ~128 / 2 = 64 (each q, k, v
//   element is used by ~T/2 pairs), far below the bf16 tensor-core ridge
//   (~295 per byte), so the floor is the q, k, v, o traffic; this first
//   version runs its two products as fp32 FMAs on the CUDA cores (67
//   TFLOP/s peak), which makes the FMAs, not the bytes, its limit.
//   Design, and where it differs from the TPU grid:
//   * The TPU grid walks the kv axis sequentially with m, l and the
//     accumulator in VMEM scratch.  Here one block owns (batch, query head,
//     64 query rows) and loops over 64-row kv tiles itself, keeping m, l
//     and the accumulator in registers; blocks share nothing, no atomics.
//   * The public layouts q (B, T, H, D) and k, v (B, S, Hk, D) are read as
//     they are: no transpose, no repeat of kv heads (query head h reads kv
//     head h / (H / Hk)), no padding of D to 128 lanes; D is 16 (the smoke
//     configs), 64 (stablelm), 128 or 256 (gemma3).  T and S need not
//     be multiples of the tile: rows past T are neither read nor stored,
//     kv rows past S are zero-filled and masked.
//   * Tiles wholly hidden by the causal or window mask are never loaded:
//     the kv loop runs only over the columns some row of the block sees.
//   * Each of the 256 threads holds a 4 x 4 block of the 64 x 64 score
//     tile (rows ty + 16 i, columns tx + 16 j); the row max and sum are
//     xor-shuffles over the 16 threads of a row.  Shared rows are padded
//     by 4 floats, so the float4 reads of k rows are free of bank
//     conflicts.  Shared memory holds q, k, v in f32 plus the
//     probabilities: 212 KB at D = 256, one block per SM there.
//   Masking uses the reference's constants (masked logits -1e30, l
//   clamped at 1e-30); expf and IEEE division, no fast math.  Untried:
//   bf16 tensor-core products (wgmma) with TMA-fed tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // kv rows per tile
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr int PAD = 4;        // row padding of the shared tiles, floats

template <typename T> struct VecN { static constexpr int N = 16 / sizeof(T); };

__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = __ldg(reinterpret_cast<const float4*>(src));
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* src, float* dst) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h2[j]);
    dst[2 * j] = f.x;
    dst[2 * j + 1] = f.y;
  }
}

// W (1, 2 or 4) consecutive shared floats
template <int W>
__device__ __forceinline__ void lds(const float* src, float* out) {
  if constexpr (W == 4) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  } else if constexpr (W == 2) {
    const float2 a = *reinterpret_cast<const float2*>(src);
    out[0] = a.x; out[1] = a.y;
  } else {
    out[0] = *src;
  }
}

template <int W>
__device__ __forceinline__ void store_w(float* dst, const float* v) {
#pragma unroll
  for (int e = 0; e < W; ++e) dst[e] = v[e];
}

template <int W>
__device__ __forceinline__ void store_w(__nv_bfloat16* dst, const float* v) {
#pragma unroll
  for (int e = 0; e < W; ++e) dst[e] = __float2bfloat16_rn(v[e]);
}

// 64 rows [row0, row0 + 64) of one head into a (64, D + PAD) f32 tile;
// rows at or past n are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ base, int row0, int n,
                                          size_t row_stride, float* tile) {
  constexpr int V = VecN<T>::N;
  constexpr int PER_ROW = D / V;
  for (int i = threadIdx.x; i < 64 * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * V;
    float* dst = tile + r * (D + PAD) + c;
    if (row0 + r < n) {
      load_vec(base + (size_t)(row0 + r) * row_stride + c, dst);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) dst[j] = 0.f;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int Tq, int S, int H, int Hk, int mask_kind,
                 int window, float scale) {
  constexpr int LD = D + PAD;
  constexpr int LP = BK + PAD;
  // a thread's output columns: NJ groups of CW adjacent ones, at
  // tx * CW + 16 * CW * jj (D / 16 columns per thread)
  constexpr int CW = D >= 64 ? 4 : D / 16;
  constexpr int NJ = D / (16 * CW);
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;           // BQ x LD
  float* ks = qs + BQ * LD;   // BK x LD
  float* vs = ks + BK * LD;   // BK x LD
  float* ps = vs + BK * LD;   // BQ x LP probabilities

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int hk = h / (H / Hk);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int off = S - Tq;  // real row coordinate of query t is t + off
  const T* qb = q + ((size_t)b * Tq * H + h) * D;
  const T* kb = k + ((size_t)b * S * Hk + hk) * D;
  const T* vb = v + ((size_t)b * S * Hk + hk) * D;
  load_tile<T, D>(qb, q0, Tq, (size_t)H * D, qs);

  // the kv columns some row of this block can see
  int lo = 0, hi = S - 1;
  if (mask_kind != 2) {
    hi = min(hi, min(q0 + BQ, Tq) - 1 + off);
    if (mask_kind == 1) lo = max(0, q0 + off - window + 1);
  }

  float m_i[4], l_i[4], acc[4][NJ][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < CW; ++e) acc[i][jj][e] = 0.f;
  }

  for (int c0 = (lo / BK) * BK; c0 <= hi; c0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(kb, c0, S, (size_t)Hk * D, ks);
    load_tile<T, D>(vb, c0, S, (size_t)Hk * D, vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&qs[(ty + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&ks[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i + off;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        bool vis = col < S;
        if (mask_kind != 2) {
          vis = vis && row >= col;
          if (mask_kind == 1) vis = vis && row - col < window;
        }
        s[i][j] = vis ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, w);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < CW; ++e) acc[i][jj][e] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&ps[(ty + 16 * i) * LP + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          float vv[CW];
          lds<CW>(&vs[(c + cc) * LD + tx * CW + 16 * CW * jj], vv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y : cc == 2 ? pv[i].z : pv[i].w;
#pragma unroll
            for (int e = 0; e < CW; ++e) acc[i][jj][e] = fmaf(p, vv[e], acc[i][jj][e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= Tq) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
    T* orow = o + (((size_t)b * Tq + t) * H + h) * D;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      float out[CW];
#pragma unroll
      for (int e = 0; e < CW; ++e) out[e] = acc[i][jj][e] / l;
      store_w<CW>(orow + tx * CW + 16 * CW * jj, out);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Tq,
                   int S, int H, int Hk, int mask_kind, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * 64 * (D + PAD) + BQ * (BK + PAD));
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Tq, S, H, Hk, mask_kind, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, void* o, int B,
                       int Tq, int S, int H, int Hk, int mask_kind, int window, float scale,
                       cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Tq, S, H, Hk, mask_kind, window, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, B, Tq, S, H, Hk, mask_kind, window, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, B, Tq, S, H, Hk, mask_kind, window, scale, st);
    case 256: return launch<T, 256>(q, k, v, o, B, Tq, S, H, Hk, mask_kind, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, T, H, D), k and v (B, S, Hk, D), o (B, T, H, D), all contiguous and
// of one type (dtype 0: f32, 1: bf16); mask_kind 0 causal, 1 window,
// 2 bidirectional.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int Tq, int S, int H, int Hk, int D, int dtype,
                                   int mask_kind, int window, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hk <= 0 || H % Hk != 0) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      dtype == 0
          ? dispatch_d<float>(D, q, k, v, o, B, Tq, S, H, Hk, mask_kind, window, scale, st)
          : dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, Tq, S, H, Hk, mask_kind, window,
                                      scale, st);
  return (int)e;
}
