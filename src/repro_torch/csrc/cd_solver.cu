// Gauss-Seidel coordinate-descent epochs (B4, B5) for Hopper.
//
// cd_wave_epoch replaces cd_wave_epoch_pallas (and, at one slot, the
// per-cell cd_epoch_pallas) in src/repro/kernels/cd_solver/cd_solver.py,
// whose shared body _cd_body sweeps coordinates i = 0 .. n-1 in order and,
// for every hyper-parameter column p at once,
//     target   = clip(c[i,p] - g[i,p] / max(K[i,i], 1e-12), lo[i,p], hi[i,p])
//     delta_p  = target - c[i,p];   c[i,p] = target
//     g[:,p]  += K[:,i] * delta_p                (rank-1 gradient update)
// for S slots (cells) x F problems per slot (the CV folds, which share
// their slot's Gram) in one launch.
//
//   Bound on the H100: one epoch is n^2 P multiply-adds per (slot, fold)
//   against n^2 floats of K per slot; at the training wave's shapes (16
//   slots x 5 folds, n = 1824, P = 70) that is 37 GFLOP in fp32 over 213 MB
//   of K, so the arithmetic bounds it, but the sweep is sequential in i:
//   every coordinate waits for the previous one's update of g.
//   Design: columns are independent, so one block owns (column block,
//   fold, slot) and keeps its (n x bc) slice of g resident in shared
//   memory, column-major so that a warp's 32 rows hit 32 banks.  Per
//   coordinate, bc threads form the clipped step from the resident g and
//   publish delta through shared memory; then every thread updates its
//   rows of g for all bc columns, reading K's column i as its coalesced
//   row i: K must be symmetric, as every Gram is (B1-sym makes the
//   training Gram equal its transpose bitwise).  No atomics, and every operation is rounded
//   on its own (__fdiv_rn, __fsub_rn, __fmul_rn, __fadd_rn: no FMA
//   contraction), so the result is bit-identical to the plain PyTorch
//   sweep (kernels/cd_solver/ref.py) run on the card, which rounds after
//   every operation too.  The clip is fminf(fmaxf(.)), the same operations
//   as torch.clamp.  The kernel stores the clipped target, as the Pallas
//   body does.  Padding coordinates with lo == hi == 0 stay at 0.
#include <cuda_runtime.h>

namespace {

constexpr int CD_THREADS = 512;

__global__ void __launch_bounds__(CD_THREADS)
cd_wave_epoch_kernel(const float* __restrict__ k, float* __restrict__ c,
                     float* __restrict__ g, const float* __restrict__ lo,
                     const float* __restrict__ hi, int F, int n, int P,
                     int bc) {
  extern __shared__ float smem[];
  float* gs = smem;                       // (bc, n) column-major g slice
  float* delta = smem + (size_t)bc * n;   // (bc,)
  const int j0 = blockIdx.x * bc;
  const int f = blockIdx.y, s = blockIdx.z;
  const int ncol = min(bc, P - j0);
  const size_t base = ((size_t)s * F + f) * n * P;
  float* cb = c + base;
  float* gb = g + base;
  const float* lob = lo + base;
  const float* hib = hi + base;
  const float* ks = k + (size_t)s * n * n;
  const int tid = threadIdx.x;

  for (int e = tid; e < n * ncol; e += CD_THREADS) {
    const int r = e / ncol, jj = e % ncol;
    gs[(size_t)jj * n + r] = gb[(size_t)r * P + j0 + jj];
  }
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    if (tid < ncol) {
      const size_t o = (size_t)i * P + j0 + tid;
      const float ci = cb[o];
      const float d = fmaxf(ks[(size_t)i * n + i], 1e-12f);
      float t = __fsub_rn(ci, __fdiv_rn(gs[(size_t)tid * n + i], d));
      t = fminf(fmaxf(t, lob[o]), hib[o]);
      delta[tid] = __fsub_rn(t, ci);
      cb[o] = t;
    }
    __syncthreads();
    const float* kcol = ks + (size_t)i * n;   // K[:, i] as row i (K symmetric)
    for (int r = tid; r < n; r += CD_THREADS) {
      const float kv = kcol[r];
      for (int jj = 0; jj < ncol; ++jj) {
        float* gp = gs + (size_t)jj * n + r;
        *gp = __fadd_rn(*gp, __fmul_rn(kv, delta[jj]));
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < n * ncol; e += CD_THREADS) {
    const int r = e / ncol, jj = e % ncol;
    gb[(size_t)r * P + j0 + jj] = gs[(size_t)jj * n + r];
  }
}

}  // namespace

extern "C" {

// k (S, n, n) symmetric per slot; c, g (S, F, n, P) updated in place; lo, hi
// (S, F, n, P); all fp32 contiguous.  bc columns per block, shared memory
// 4 (bc n + bc) bytes.  Limits checked by the Python wrapper: ceil(P / bc)
// below 2^31, F and S at most 65535, the shared memory at most 227 KB.
int cd_wave_epoch(const float* k, float* c, float* g, const float* lo,
                  const float* hi, int S, int F, int n, int P, int bc,
                  void* stream) {
  const size_t smem = sizeof(float) * ((size_t)bc * n + bc);
  cudaError_t err = cudaFuncSetAttribute(
      cd_wave_epoch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((P + bc - 1) / bc, F, S);
  cd_wave_epoch_kernel<<<grid, CD_THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      k, c, g, lo, hi, F, n, P, bc);
  return (int)cudaGetLastError();
}

}  // extern "C"
