// Squared distances (B1), the one-shot Gram (B7) and the per-gamma kernel
// epilogue (B2) for Hopper.
//
// sq_dists_f32 replaces sq_dists_pallas (symmetric=False) in
// src/repro/kernels/kernel_matrix/kernel_matrix.py: D2 = max(|x|^2 + |z|^2
// - 2 x.z, 0) in fp32, batched over a leading axis so the serving engine's
// per-slot cross-D2 of a whole wave is one launch.
//   Bound on the H100: at serving shapes (8 query rows per slot against
//   2048 support vectors of width 54) each z row is used by only 8 x rows,
//   so the kernel moves 4 bytes of z per 16 flops: it is bound by reading
//   z and writing D2 from device memory, not by arithmetic.
//   Design: one block owns an (8 x 128) output tile; each of its 128
//   threads owns one z row and keeps the 8 cross terms in registers.  The
//   feature axis is staged through shared memory in chunks of 32, padded
//   by one column so the threads of a warp read 32 different banks.  z is
//   read from device memory exactly once per 8 x rows and every output is
//   written once, coalesced along z.  The cross term is plain fp32 FMAs:
//   no tensor cores, so no TF32 rounding on top of the GEMM-form
//   cancellation.
//
// gram_f32 replaces gram_pallas (body _gram_kernel, same file): the one-shot
// Gram K = k_gamma(x, z), (n, d) x (m, d) -> (n, m) f32, Gaussian or
// Laplacian, in ONE pass: each D2 value is computed as in sq_dists_f32
// (clamped at 0, as _d2_tile does) and the gamma epilogue of
// gram_from_d2 is applied in registers before the value is stored, so
// the D2 matrix is never written to device memory.
//   Bound on the H100: at (2048, 54) x (2048, 54) the 0.45 GFLOP of fp32
//   cross terms and the 16.8 MB written take about the same time (~7 us of
//   FMAs, ~5 us of writes); the expf per value comes on top.
//   Design: sq_dists_f32's block and tile (8 x rows by 128 z rows, one z
//   row per thread) instantiated with the epilogue; the same arithmetic in
//   the same order, so K equals gram_from_d2(sq_dists(x, z)) bitwise.
//
// sq_dists_sym_f32 replaces sq_dists_pallas (symmetric=True, the body
// _sq_dists_sym_kernel and the out map _sym_out_map, same file): the train
// Gram's D2 of a whole wave of cells, (B, n, d) -> (B, n, n), one launch.
//   Bound on the H100: at the training wave's shapes (16 slots of 1824
//   rows, d = 54) the 213 MB written outweighs the 2.9 GFLOP of upper-half
//   cross terms at the fp32 (non-tensor-core) rate: device memory writes.
//   Design: one block per (upper tile pair bi <= bj, slot), 32 x 32 tiles,
//   256 threads each holding 4 register accumulators; both row blocks are
//   staged through shared memory in feature chunks of 32.  Each D2 value is
//   computed once and written to (i, j) and (j, i): the tile goes through
//   shared memory so that the mirrored store is coalesced as well.  On a
//   diagonal tile only the values with i <= j are stored, to both places,
//   so the result equals its transpose bitwise with no read-back.  Rows
//   are masked at the ragged edge: n is not padded to the tile.  fp32 FMAs,
//   no tensor cores, as in sq_dists_f32.
//
// gram_from_d2 replaces gram_from_d2_pallas (same file): the elementwise
// epilogue exp(-d2 / max(g^2, 1e-12)) (Gaussian) or
// exp(-sqrt(d2 + 1e-12) / max(g, 1e-12)) (Laplacian), f32 or bf16 in and
// out, G gammas per batch row: (B, N) -> (B, G, N).
//   Bound: each D2 element read once and written G times, a few operations
//   each: device memory bandwidth.
//   Design: the D2 matrix is cut into aligned 16-byte chunks of the flat
//   (B * N) index (V elements: 4 for f32 in and out, 8 when either side is
//   bf16); a grid of as many 256-thread blocks as the card holds at once
//   strides over them.  A thread reads its chunk once and writes it out
//   for each of the G gammas of its batch row, so D2 is read once, not G
//   times.  Stores are 16-byte vectors, marked streaming (evict first),
//   where every output row keeps the chunk's alignment (G == 1, or N a
//   multiple of V); a chunk that straddles two batch rows (N not a
//   multiple of V), the ragged end, or an operand whose base is not
//   16-byte aligned takes the element path.  One kernel per (in, out)
//   type: the kind and the alignment are runtime arguments, branched on
//   once per chunk.
//   The per-element expression is the plain version's: expf/sqrtf and IEEE
//   division (no fast-math, no reciprocal), so the result equals it and
//   the one-shot Gram (gram_f32) bitwise.  bf16 is written with
//   round-to-nearest-even.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int SQ_BN = 8;    // x rows per block (register accumulators)
constexpr int SQ_BM = 128;  // z rows per block, one per thread
constexpr int SQ_DK = 32;   // feature chunk staged in shared memory

// EPI: 0 stores D2 (B1), 1 the Gaussian and 2 the Laplacian kernel of it (B7)
template <int EPI>
__global__ void __launch_bounds__(SQ_BM)
sq_dists_kernel(const float* __restrict__ x, const float* __restrict__ z,
                float* __restrict__ out, int n, int m, int d, float denom) {
  __shared__ float xs[SQ_BN][SQ_DK];
  __shared__ float zs[SQ_BM][SQ_DK + 1];
  __shared__ float xn[SQ_BN];
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * SQ_BN;
  const int j0 = blockIdx.x * SQ_BM;
  const int t = threadIdx.x;
  const float* xb = x + (size_t)b * n * d;
  const float* zb = z + (size_t)b * m * d;

  float cross[SQ_BN];
#pragma unroll
  for (int r = 0; r < SQ_BN; ++r) cross[r] = 0.f;
  float zz = 0.f;
  float xx = 0.f;  // |x_t|^2, kept by threads t < SQ_BN

  for (int k0 = 0; k0 < d; k0 += SQ_DK) {
    for (int e = t; e < SQ_BN * SQ_DK; e += SQ_BM) {
      const int r = e / SQ_DK, c = e % SQ_DK;
      const int gi = i0 + r, gk = k0 + c;
      xs[r][c] = (gi < n && gk < d) ? xb[(size_t)gi * d + gk] : 0.f;
    }
    for (int e = t; e < SQ_BM * SQ_DK; e += SQ_BM) {
      const int r = e / SQ_DK, c = e % SQ_DK;
      const int gj = j0 + r, gk = k0 + c;
      zs[r][c] = (gj < m && gk < d) ? zb[(size_t)gj * d + gk] : 0.f;
    }
    __syncthreads();
    if (t < SQ_BN) {
#pragma unroll 8
      for (int c = 0; c < SQ_DK; ++c) xx = fmaf(xs[t][c], xs[t][c], xx);
    }
#pragma unroll 8
    for (int c = 0; c < SQ_DK; ++c) {
      const float zv = zs[t][c];
      zz = fmaf(zv, zv, zz);
#pragma unroll
      for (int r = 0; r < SQ_BN; ++r) cross[r] = fmaf(xs[r][c], zv, cross[r]);
    }
    __syncthreads();
  }
  if (t < SQ_BN) xn[t] = xx;
  __syncthreads();

  const int j = j0 + t;
  if (j >= m) return;
#pragma unroll
  for (int r = 0; r < SQ_BN; ++r) {
    const int i = i0 + r;
    if (i < n) {
      const float v = fmaxf(xn[r] + zz - 2.f * cross[r], 0.f);
      out[((size_t)b * n + i) * m + j] =
          EPI == 0 ? v : EPI == 1 ? expf(-v / denom) : expf(-sqrtf(v + 1e-12f) / denom);
    }
  }
}

constexpr int SYM_T = 32;   // square tile
constexpr int SYM_RY = 8;   // thread rows: each thread owns SYM_T / SYM_RY rows
constexpr int SYM_DK = 32;  // feature chunk staged in shared memory

__global__ void __launch_bounds__(SYM_T * SYM_RY)
sq_dists_sym_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int n, int d, int n_tiles) {
  __shared__ float xi[SYM_T][SYM_DK + 1];
  __shared__ float xj[SYM_T][SYM_DK + 1];
  __shared__ float tile[SYM_T][SYM_T + 1];
  __shared__ float ni[SYM_T], nj[SYM_T];
  const int b = blockIdx.y;
  int rem = blockIdx.x, bi = 0;            // linear index -> tile pair bi <= bj
  while (rem >= n_tiles - bi) { rem -= n_tiles - bi; ++bi; }
  const int bj = bi + rem;
  const int i0 = bi * SYM_T, j0 = bj * SYM_T;
  const int tid = threadIdx.x, tx = tid % SYM_T, ty = tid / SYM_T;
  const float* xb = x + (size_t)b * n * d;

  float acc[SYM_T / SYM_RY];
#pragma unroll
  for (int q = 0; q < SYM_T / SYM_RY; ++q) acc[q] = 0.f;
  float sq = 0.f;  // |x|^2 of row tx of tile i (ty == 0) or of tile j (ty == 1)

  for (int k0 = 0; k0 < d; k0 += SYM_DK) {
    for (int e = tid; e < SYM_T * SYM_DK; e += SYM_T * SYM_RY) {
      const int r = e / SYM_DK, c = e % SYM_DK, gk = k0 + c;
      xi[r][c] = (i0 + r < n && gk < d) ? xb[(size_t)(i0 + r) * d + gk] : 0.f;
      xj[r][c] = (j0 + r < n && gk < d) ? xb[(size_t)(j0 + r) * d + gk] : 0.f;
    }
    __syncthreads();
    if (ty == 0) {
#pragma unroll 8
      for (int c = 0; c < SYM_DK; ++c) sq = fmaf(xi[tx][c], xi[tx][c], sq);
    } else if (ty == 1) {
#pragma unroll 8
      for (int c = 0; c < SYM_DK; ++c) sq = fmaf(xj[tx][c], xj[tx][c], sq);
    }
#pragma unroll 8
    for (int c = 0; c < SYM_DK; ++c) {
      const float zv = xj[tx][c];
#pragma unroll
      for (int q = 0; q < SYM_T / SYM_RY; ++q)
        acc[q] = fmaf(xi[ty + SYM_RY * q][c], zv, acc[q]);
    }
    __syncthreads();
  }
  if (ty == 0) ni[tx] = sq;
  if (ty == 1) nj[tx] = sq;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < SYM_T / SYM_RY; ++q) {
    const int r = ty + SYM_RY * q;
    tile[r][tx] = fmaxf(ni[r] + nj[tx] - 2.f * acc[q], 0.f);
  }
  __syncthreads();
  float* ob = out + (size_t)b * n * n;
  const bool diag = bi == bj;
#pragma unroll
  for (int q = 0; q < SYM_T / SYM_RY; ++q) {
    const int r = ty + SYM_RY * q;
    // direct: D(i0 + r, j0 + tx) to (i0 + r, j0 + tx)
    if (i0 + r < n && j0 + tx < n && (!diag || r <= tx))
      ob[(size_t)(i0 + r) * n + j0 + tx] = tile[r][tx];
    // mirror: D(i0 + tx, j0 + r) to (j0 + r, i0 + tx)
    if (j0 + r < n && i0 + tx < n && (!diag || tx < r))
      ob[(size_t)(j0 + r) * n + i0 + tx] = tile[tx][r];
  }
}

__device__ __forceinline__ float load_f(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// V consecutive elements, 16-byte aligned, to / from floats
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
#pragma unroll
  for (int j = 0; j < V; j += 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p + j));
    v[j] = a.x; v[j + 1] = a.y; v[j + 2] = a.z; v[j + 3] = a.w;
  }
}
template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  static_assert(V == 8, "bf16 chunks are 8 elements");
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x; v[2 * j + 1] = f.y;
  }
}
// stores marked streaming (evict first): the output is not read back here
template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
#pragma unroll
  for (int j = 0; j < V; j += 4)
    __stcs(reinterpret_cast<float4*>(p + j), make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]));
}
template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  static_assert(V == 8, "bf16 chunks are 8 elements");
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  __stcs(reinterpret_cast<uint4*>(p), u);
}

// kind 0 Gaussian, 1 Laplacian: the expression of the plain version
__device__ __forceinline__ float denom_of(float g, int kind) {
  return kind == 0 ? fmaxf(g * g, 1e-12f) : fmaxf(g, 1e-12f);
}
__device__ __forceinline__ float epilogue(float v, float denom, int kind) {
  return kind == 0 ? expf(-v / denom) : expf(-sqrtf(v + 1e-12f) / denom);
}

constexpr int GRAM_THREADS = 256;

// vec: d2 and out start on 16-byte boundaries (16-byte loads); vec_out:
// every output row keeps the chunk's alignment as well (16-byte stores)
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(GRAM_THREADS)
gram_from_d2_kernel(const Tin* __restrict__ d2, const float* __restrict__ gammas,
                    Tout* __restrict__ out, int G, long long N, long long total, int kind,
                    bool vec, bool vec_out) {
  constexpr int V = 16 / (sizeof(Tin) < sizeof(Tout) ? sizeof(Tin) : sizeof(Tout));
  const bool narrow = total < (1LL << 31);  // 32-bit row division
  const long long chunks = (total + V - 1) / V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < chunks;
       c += stride) {
    const long long f0 = c * V;
    const long long b = narrow ? (long long)((unsigned)f0 / (unsigned)N) : f0 / N;
    const long long e0 = f0 - b * N;
    if (vec && e0 + V <= N) {  // the chunk lies in batch row b
      float v[V];
      load_vec<V>(d2 + f0, v);
      for (int g = 0; g < G; ++g) {
        const float denom = denom_of(__ldg(gammas + b * G + g), kind);
        float k[V];
        // one branch per chunk, not per element: the compiler evaluates
        // only the kind's own expression
        if (kind == 0) {
#pragma unroll
          for (int j = 0; j < V; ++j) k[j] = expf(-v[j] / denom);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) k[j] = expf(-sqrtf(v[j] + 1e-12f) / denom);
        }
        Tout* dst = out + (b * G + g) * N + e0;
        if (vec_out) {
          store_vec<V>(dst, k);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) store_f(dst, j, k[j]);
        }
      }
    } else {  // straddles two rows, or the ragged end, or unaligned operands
      for (int j = 0; j < V && f0 + j < total; ++j) {
        const long long f = f0 + j;
        const long long bb = f / N, e = f - bb * N;
        const float x = load_f(d2, f);
        for (int g = 0; g < G; ++g)
          store_f(out, (bb * G + g) * N + e,
                  epilogue(x, denom_of(__ldg(gammas + bb * G + g), kind), kind));
      }
    }
  }
}

// as many blocks as the card holds at once: asked once per instance, not
// at every launch (B2 launches once per column when serving unfused)
template <typename Tin, typename Tout>
long long resident_blocks() {
  static const long long n = [] {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, gram_from_d2_kernel<Tin, Tout>, GRAM_THREADS, 0) != cudaSuccess)
      return 0LL;
    return (long long)sms * (per_sm > 0 ? per_sm : 1);
  }();
  return n;
}

template <typename Tin, typename Tout>
cudaError_t launch_gram(const void* d2, const float* gammas, void* out, int B, int G,
                        long long N, int kind, cudaStream_t stream) {
  constexpr int V = 16 / (sizeof(Tin) < sizeof(Tout) ? sizeof(Tin) : sizeof(Tout));
  const long long resident = resident_blocks<Tin, Tout>();
  if (resident < 1) return cudaErrorInvalidDevice;
  const long long total = (long long)B * N;
  const long long chunks = (total + V - 1) / V;
  const bool vec = reinterpret_cast<uintptr_t>(d2) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const bool vec_out = vec && (G == 1 || N % V == 0);
  // fewer blocks than the card holds for a small matrix
  long long blocks = (chunks + GRAM_THREADS - 1) / GRAM_THREADS;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  gram_from_d2_kernel<Tin, Tout><<<(unsigned)blocks, GRAM_THREADS, 0, stream>>>(
      static_cast<const Tin*>(d2), gammas, static_cast<Tout*>(out), G, N, total, kind, vec,
      vec_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, n, d), z (B, m, d), out (B, n, m); all fp32, contiguous.
// Limits checked by the Python wrapper: ceil(n / 8) and B at most 65535.
int sq_dists_f32(const float* x, const float* z, float* out, int B, int n,
                 int m, int d, void* stream) {
  dim3 grid((m + SQ_BM - 1) / SQ_BM, (n + SQ_BN - 1) / SQ_BN, B);
  sq_dists_kernel<0><<<grid, SQ_BM, 0, static_cast<cudaStream_t>(stream)>>>(
      x, z, out, n, m, d, 0.f);
  return (int)cudaGetLastError();
}

// x (n, d), z (m, d), out (n, m); fp32 contiguous.  kind: 0 Gaussian RBF,
// 1 Laplacian.  Limits checked by the Python wrapper: ceil(n / 8) at most
// 65535.
int gram_f32(const float* x, const float* z, float* out, int n, int m, int d,
             float gamma, int kind, void* stream) {
  dim3 grid((m + SQ_BM - 1) / SQ_BM, (n + SQ_BN - 1) / SQ_BN, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    sq_dists_kernel<1><<<grid, SQ_BM, 0, s>>>(x, z, out, n, m, d,
                                              fmaxf(gamma * gamma, 1e-12f));
  } else {
    sq_dists_kernel<2><<<grid, SQ_BM, 0, s>>>(x, z, out, n, m, d,
                                              fmaxf(gamma, 1e-12f));
  }
  return (int)cudaGetLastError();
}

// x (B, n, d) fp32 contiguous, out (B, n, n): the D2 of x with itself.
// Limits checked by the Python wrapper: B at most 65535 and the number of
// upper tile pairs below 2^31.
int sq_dists_sym_f32(const float* x, float* out, int B, int n, int d,
                     void* stream) {
  const int n_tiles = (n + SYM_T - 1) / SYM_T;
  const long long pairs = (long long)n_tiles * (n_tiles + 1) / 2;
  dim3 grid((unsigned)pairs, B);
  sq_dists_sym_kernel<<<grid, SYM_T * SYM_RY, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, out, n, d,
                                                             n_tiles);
  return (int)cudaGetLastError();
}

// d2 (B, N) f32 or bf16, gammas (B, G) f32, out (B, G, N) f32 or bf16.
// kind: 0 Gaussian RBF, 1 Laplacian.  Returns the launch's error.
int gram_from_d2(const void* d2, const float* gammas, void* out, int B, int G,
                 long long N, int in_bf16, int out_bf16, int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (in_bf16) {
    e = out_bf16 ? launch_gram<__nv_bfloat16, __nv_bfloat16>(d2, gammas, out, B, G, N, kind, s)
                 : launch_gram<__nv_bfloat16, float>(d2, gammas, out, B, G, N, kind, s);
  } else {
    e = out_bf16 ? launch_gram<float, __nv_bfloat16>(d2, gammas, out, B, G, N, kind, s)
                 : launch_gram<float, float>(d2, gammas, out, B, G, N, kind, s);
  }
  return (int)e;
}

}  // extern "C"
