// Nearest-center assignment (B6) for Hopper.
//
// assign_f32 replaces _assign_pallas_padded (body _assign_kernel) in
// src/repro/pipeline/assign.py: for each row x_i of a chunk, the index of
// the center c minimising |x_i|^2 + |c|^2 - 2 x_i.c, computed in fp32 and,
// as in the Pallas body, not clamped at 0.  A tie goes to the LOWEST
// center index, numpy's and torch's argmin rule, which the serving router
// and the overlap cell builder rely on.
//   Bound on the H100: a Covertype chunk (65536 rows x 291 centers x d 54)
//   is 2.1 GFLOP of cross terms against 14 MB read, so it is bound by the
//   fp32 FMA rate (no tensor cores: TF32 would round the cross term to 10
//   bits before the GEMM form cancels); so is a HIGGS-width table (5500
//   centers x d 28: 20 GFLOP).
//   Design, and where it differs from the TPU grid:
//   * On the TPU the whole padded center table stays resident in VMEM for
//     the grid.  A block here has at most 227 KB of shared memory, and a
//     HIGGS-width table (5500 x 28 x 4 B = 616 KB) does not fit, so each
//     block owns 64 rows and walks the center table in tiles of 64 through
//     shared memory, the feature axis in chunks of 32.  Both chunks are
//     stored transposed (feature-major) so that each of the 256 threads
//     reads its 4 rows and its 4 centers as one 16-byte load each and
//     keeps a 4 x 4 tile of cross terms in registers.
//   * Each thread keeps its rows' running (d2, index) in registers and,
//     visiting its centers in ascending order, replaces it only on a
//     strict <.  The 16 threads that share a row merge with xor-shuffles,
//     where the lower index wins on equal d2: the result is the
//     lexicographic minimum of (d2, index) whatever the merge order.
//   * No sentinel center rows (the TPU wrapper pads with 1e17): the center
//     edge is masked, and rows past the chunk are never stored.
//   * The squared norms come from the same shared tiles: |x|^2 on the
//     first pass over the centers, |c|^2 on every tile.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int AS_ROWS = 64;      // rows per block
constexpr int AS_CT = 64;        // centers per shared tile
constexpr int AS_DK = 32;        // feature chunk
constexpr int AS_LD = 68;        // padded tile width: 16-byte aligned rows
constexpr int AS_THREADS = 256;  // 16 x 16 threads, each 4 rows x 4 centers

__global__ void __launch_bounds__(AS_THREADS)
assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
              int* __restrict__ out, int n, int C, int d) {
  __shared__ __align__(16) float xs[AS_DK][AS_LD];   // [feature][row]
  __shared__ __align__(16) float cs[AS_DK][AS_LD];   // [feature][center]
  __shared__ float xn[AS_ROWS];
  __shared__ float cn[AS_CT];
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int r0 = blockIdx.x * AS_ROWS;

  float best[4];
  int bidx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { best[i] = CUDART_INF_F; bidx[i] = 0; }
  float xx = 0.f;  // threads t < AS_ROWS: |x|^2 of row r0 + t

  for (int c0 = 0; c0 < C; c0 += AS_CT) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float cc = 0.f;  // threads AS_ROWS <= t < AS_ROWS + AS_CT: |c|^2
    for (int k0 = 0; k0 < d; k0 += AS_DK) {
      __syncthreads();  // the previous chunk is consumed
      for (int e = t; e < AS_ROWS * AS_DK; e += AS_THREADS) {
        const int r = e / AS_DK, k = e % AS_DK, gr = r0 + r, gk = k0 + k;
        xs[k][r] = (gr < n && gk < d) ? x[(size_t)gr * d + gk] : 0.f;
      }
      for (int e = t; e < AS_CT * AS_DK; e += AS_THREADS) {
        const int r = e / AS_DK, k = e % AS_DK, gc = c0 + r, gk = k0 + k;
        cs[k][r] = (gc < C && gk < d) ? c[(size_t)gc * d + gk] : 0.f;
      }
      __syncthreads();
      if (c0 == 0 && t < AS_ROWS) {
#pragma unroll 8
        for (int k = 0; k < AS_DK; ++k) xx = fmaf(xs[k][t], xs[k][t], xx);
      } else if (t >= AS_ROWS && t < AS_ROWS + AS_CT) {
        const int j = t - AS_ROWS;
#pragma unroll 8
        for (int k = 0; k < AS_DK; ++k) cc = fmaf(cs[k][j], cs[k][j], cc);
      }
#pragma unroll 8
      for (int k = 0; k < AS_DK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[k][4 * ty]);
        const float4 b = *reinterpret_cast<const float4*>(&cs[k][4 * tx]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();  // every thread is past the last tile's epilogue
    if (c0 == 0 && t < AS_ROWS) xn[t] = xx;
    if (t >= AS_ROWS && t < AS_ROWS + AS_CT) cn[t - AS_ROWS] = cc;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cj = c0 + 4 * tx + j;
        if (cj < C) {
          const float v = xn[4 * ty + i] + cn[4 * tx + j] - 2.f * acc[i][j];
          if (v < best[i]) { best[i] = v; bidx[i] = cj; }
        }
      }
  }

  // merge across the 16 lanes (tx) that share rows: (d2, index) lexicographic
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx[i], off);
      if (ov < best[i] || (ov == best[i] && oi < bidx[i])) {
        best[i] = ov;
        bidx[i] = oi;
      }
    }
    const int r = r0 + 4 * ty + i;
    if (tx == 0 && r < n) out[r] = bidx[i];
  }
}

}  // namespace

extern "C" {

// x (n, d), centers (C, d) fp32 contiguous; out (n,) int32.  C >= 1
// (checked by the Python wrapper).
int assign_f32(const float* x, const float* centers, int* out, int n, int C,
               int d, void* stream) {
  dim3 grid((unsigned)(((long long)n + AS_ROWS - 1) / AS_ROWS));
  assign_kernel<<<grid, AS_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, centers, out, n, C, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
