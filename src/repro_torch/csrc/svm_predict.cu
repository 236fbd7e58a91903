// Fused multi-cell SVM prediction (B3) for Hopper.
//
// svm_predict_cells_f32 replaces svm_predict_cells_pallas in
// src/repro/kernels/svm_predict/svm_predict.py: for each cell (launch
// slot) c, out[c] = sum over support vectors j of
// k_{gamma_p}(x_i, sv_j) * coef[c, j, p], with D2(x_i, sv_j) computed once
// and the Gaussian or Laplacian epilogue replayed per column p with that
// column's gamma.  The kernel matrix is never written to device memory.
//   Bound on the H100: a serving wave reads each slot's whole SV table
//   (2048 x 54 fp32, 442 KB) for at most a few dozen query rows, so the
//   launch is bound by the SV-table read from device memory (a 256-slot
//   wave moves ~113 MB: ~34 us at 3.35 TB/s); the fp32 FMAs and the P
//   expf per (row, SV) pair come second.
//   Design, and where it differs from the TPU grid:
//   * The TPU grid walks the SV axis sequentially and accumulates into the
//     output block.  Here one block owns (slot, ROWS query rows) and loops
//     over the SV table itself in tiles of 256 rows staged in shared
//     memory; blocks never share an output, so there are no atomics and
//     the sum order is fixed: a thread sums its SVs in order, then a fixed
//     xor-shuffle tree and a fixed loop over warps reduce across threads.
//   * Serving waves pad query rows to a multiple of 8, not 128.  The row
//     tile is ROWS = 8 (fewer for many columns), the ragged edge is masked
//     on load and on store, and the SV edge is masked too.
//   * The P = n_tasks * n_sub accumulators for each of the ROWS rows live
//     in registers (ROWS * PMAX = 64 per thread).  A bank with more than
//     64 columns (an all-vs-all bank of 12 or more classes) gets a third
//     grid axis over blocks of 64 columns; each such block re-reads its
//     slot's SV table.
//   * Zero coefficient rows make SV padding exact, as on the TPU.
//   The cross term is plain fp32 FMAs (no TF32); expf/sqrtf and IEEE
//   division, no fast-math.
#include <cuda_runtime.h>

namespace {

constexpr int PR_BS = 256;  // SV rows per tile, one per thread
constexpr int PR_DK = 16;   // feature chunk of the SV tile in shared memory
constexpr int PR_WARPS = PR_BS / 32;
constexpr int PR_ACC = 64;  // ROWS * PMAX accumulators per thread

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int ROWS, int PMAX>
__global__ void __launch_bounds__(PR_BS)
predict_cells_kernel(const float* __restrict__ xt, const float* __restrict__ sv,
                     const float* __restrict__ coefs, const float* __restrict__ gammas,
                     float* __restrict__ out, int m, int k, int d, int dpad, int P,
                     int kind) {
  static_assert(ROWS * PMAX == PR_ACC, "accumulator budget");
  extern __shared__ float dyn[];
  float* xs = dyn;                      // ROWS * dpad, zero past d
  float* cs = dyn + ROWS * dpad;        // PR_BS * pb coefficient tile
  __shared__ float ss[PR_BS][PR_DK + 1];
  __shared__ float red[PR_WARPS][PR_ACC];
  __shared__ float xn[ROWS];
  __shared__ float gden[PMAX];

  const int c = blockIdx.y;
  const int i0 = blockIdx.x * ROWS;
  const int p0 = blockIdx.z * PMAX;     // this block's columns: [p0, p0 + pb)
  const int pb = min(PMAX, P - p0);
  const int t = threadIdx.x;
  const float* xb = xt + (size_t)c * m * d;
  const float* svb = sv + (size_t)c * k * d;
  const float* cb = coefs + (size_t)c * k * P;

  for (int e = t; e < ROWS * dpad; e += PR_BS) {
    const int r = e / dpad, col = e % dpad;
    xs[e] = (i0 + r < m && col < d) ? xb[(size_t)(i0 + r) * d + col] : 0.f;
  }
  if (t < pb) {
    const float g = gammas[(size_t)c * P + p0 + t];
    gden[t] = kind == 0 ? fmaxf(g * g, 1e-12f) : fmaxf(g, 1e-12f);
  }
  __syncthreads();
  if (t < ROWS) {
    float s = 0.f;
    for (int col = 0; col < dpad; ++col) s = fmaf(xs[t * dpad + col], xs[t * dpad + col], s);
    xn[t] = s;
  }

  float acc[ROWS][PMAX];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int p = 0; p < PMAX; ++p) acc[r][p] = 0.f;

  for (int j0 = 0; j0 < k; j0 += PR_BS) {
    float cross[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) cross[r] = 0.f;
    float zz = 0.f;
    for (int k0 = 0; k0 < dpad; k0 += PR_DK) {
      __syncthreads();  // the previous chunk (and coefficient tile) is consumed
      if (k0 == 0) {
        for (int e = t; e < PR_BS * pb; e += PR_BS) {
          const int r = e / pb;
          cs[e] = (j0 + r < k) ? cb[(size_t)(j0 + r) * P + p0 + e % pb] : 0.f;
        }
      }
      for (int e = t; e < PR_BS * PR_DK; e += PR_BS) {
        const int r = e / PR_DK, col = e % PR_DK;
        const int gj = j0 + r, gk = k0 + col;
        ss[r][col] = (gj < k && gk < d) ? svb[(size_t)gj * d + gk] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int col = 0; col < PR_DK; ++col) {
        const float s = ss[t][col];
        zz = fmaf(s, s, zz);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) cross[r] = fmaf(xs[r * dpad + k0 + col], s, cross[r]);
      }
    }
    if (j0 + t < k) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float d2 = fmaxf(xn[r] + zz - 2.f * cross[r], 0.f);
        const float root = kind == 0 ? d2 : sqrtf(d2 + 1e-12f);
#pragma unroll
        for (int p = 0; p < PMAX; ++p) {
          if (p < pb) acc[r][p] = fmaf(expf(-root / gden[p]), cs[t * pb + p], acc[r][p]);
        }
      }
    }
  }

  const int warp = t / 32, lane = t % 32;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int p = 0; p < PMAX; ++p) {
      const float v = warp_sum(acc[r][p]);
      if (lane == 0) red[warp][r * PMAX + p] = v;
    }
  __syncthreads();
  for (int e = t; e < ROWS * pb; e += PR_BS) {
    const int r = e / pb, p = e % pb;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < PR_WARPS; ++w) s += red[w][r * PMAX + p];
    if (i0 + r < m) out[((size_t)c * m + i0 + r) * P + p0 + p] = s;
  }
}

template <int ROWS, int PMAX>
int launch(const float* xt, const float* sv, const float* coefs, const float* gammas,
           float* out, int C, int m, int k, int d, int P, int kind, cudaStream_t stream) {
  const int dpad = (d + PR_DK - 1) / PR_DK * PR_DK;
  const int pb = P < PMAX ? P : PMAX;
  const size_t dyn = sizeof(float) * ((size_t)ROWS * dpad + (size_t)PR_BS * pb);
  auto kern = predict_cells_kernel<ROWS, PMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((m + ROWS - 1) / ROWS, C, (P + PMAX - 1) / PMAX);
  kern<<<grid, PR_BS, dyn, stream>>>(xt, sv, coefs, gammas, out, m, k, d, dpad, P, kind);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// xt (C, m, d), sv (C, k, d), coefs (C, k, P), gammas (C, P), out (C, m, P);
// all fp32, contiguous.  kind: 0 Gaussian RBF, 1 Laplacian.  P >= 1 (more
// than 64 columns run as blocks of 64); C and ceil(P / 64) at most 65535;
// the wrapper bounds d so the shared tiles fit.
int svm_predict_cells_f32(const float* xt, const float* sv, const float* coefs,
                          const float* gammas, float* out, int C, int m, int k,
                          int d, int P, int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 8) return launch<8, 8>(xt, sv, coefs, gammas, out, C, m, k, d, P, kind, s);
  if (P <= 16) return launch<4, 16>(xt, sv, coefs, gammas, out, C, m, k, d, P, kind, s);
  if (P <= 32) return launch<2, 32>(xt, sv, coefs, gammas, out, C, m, k, d, P, kind, s);
  return launch<1, 64>(xt, sv, coefs, gammas, out, C, m, k, d, P, kind, s);
}

}  // extern "C"
