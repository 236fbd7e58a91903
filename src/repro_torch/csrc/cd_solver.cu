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
//   Bound on the H100: one epoch is n^2 multiply-adds per column against
//   n^2 floats of K per slot; at the training wave's shapes (16 slots x 5
//   folds x 70 columns, n = 1824) that is 37 G operations in fp32 over 213
//   MB of K, so the arithmetic bounds it (0.56 ms).  Every product and sum
//   is rounded on its own (__fmul_rn, __fadd_rn: no FMA contraction) to stay
//   bitwise equal to the plain sweep (kernels/cd_solver/ref.py run on the
//   card), so the 37 G operations issue as 37 G instructions: ~1.1 ms is
//   the floor under that contract.
//
//   The bits of an element g[r,p] depend only on the order of its updates
//   (deltas 0, 1, .., n-1), and c[i,p] only on g[i,p] after deltas < i.  So
//   the sweep runs in panels of 32 coordinates:
//   * one warp (the sweeper) sweeps panel [i0, i0+32): it holds the panel's
//     rows of g (current with every delta < i0) and updates only them, with
//     the 32 x 32 diagonal block of K, and publishes the panel's deltas;
//   * the other 15 warps (the bulk) hold all n rows of g in registers and
//     apply the panel's deltas to them in coordinate order, each product and
//     sum rounded on its own, reading row i of K for column i (K must be
//     symmetric, as every Gram is: B1-sym makes the training Gram equal its
//     transpose bitwise).  A panel's own rows get the same operations in
//     the same order from the bulk as from the sweeper, so the bulk's copy
//     is the result and the sweeper's is dropped;
//   * look-ahead: the warp that owns the next panel's rows applies the
//     deltas to a copy of those rows first (K from the sweeper's staged
//     block) and hands it to the sweeper, so the sweep of panel q+1
//     overlaps the bulk update of panel q; its registers then take panel
//     q's deltas in the regular pass, so every row still takes panel q's
//     deltas before panel q+1's, in the same operations.
//   The sweeper stages the next panel's c, lo, hi, its diagonal block of K
//   and the block beside it by cp.async while it sweeps; the bulk reads
//   its K rows from L2 (the blocks of a slot walk K together), TU
//   coordinates of loads in flight.  Warps hand over through named
//   barriers (bar.arrive / bar.sync), two buffers each way.  A block owns
//   BC columns of one slot, folds packed together (the slot's F x P
//   columns share its K), so the training wave's 5600 columns make 352
//   blocks: 3 rounds of one block an SM.  g takes R x BC = 64 registers a
//   thread (R = rows a bulk thread owns, 480 R >= n); where 16-column
//   blocks would leave SMs idle (one cell, B5: 22 blocks) the blocks take
//   8 columns.
//   What bounds it on the card: the bulk's rounded products and sums, not
//   the sweep (clock64 stamps in one block showed the sweeper waiting for
//   the bulk most of each panel), at about half the FP32 issue rate.
//   The clip is fminf(fmaxf(.)), the same operations as torch.clamp; the
//   kernel stores the clipped target, as the Pallas body does.  Padding
//   coordinates with lo == hi == 0 stay at 0.
//   Tried and replaced: one block per (16 columns, fold, slot) with g in
//   shared memory and two block barriers a coordinate (23 ms at the
//   training wave: shared-memory bandwidth and global-load latency on the
//   chain of 1824 coordinates, and 4 rounds of 400 blocks).  Tried and no
//   faster: K through a per-thread cp.async ring in shared memory (the
//   bulk's time did not move, so load latency is not what holds it), the
//   coordinate loop not unrolled (instruction fetch is not it either), 4
//   loads in flight at 16 columns.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PANEL = 32;                       // coordinates a panel
constexpr int BULK_WARPS = 15;
constexpr int BULK = 32 * BULK_WARPS;           // 480 bulk threads
constexpr int CD_THREADS = BULK + 32;           // + the sweeper warp
// coordinates of K loads in flight a row slot: 32 registers of loads at
// most, 4 at 4 rows x 8 columns (faster there than 8); a divisor of 32
__host__ __device__ constexpr int tu(int R, int BC) {
  return R == 4 && BC == 8 ? 4 : R <= 4 ? 8 : 32 / R;
}

// named barriers (0 is __syncthreads)
constexpr int BAR_READY_G = 1;   // + buffer: next panel's rows handed over
constexpr int BAR_READY_D = 3;   // + buffer: a panel's deltas published
constexpr int BAR_FREE_D = 5;    // + buffer: the bulk is done with them

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}
// 4-byte asynchronous copy; zero-fills the destination when !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}


// rows of BC + 1 floats where a lane writes a row: no bank conflicts
template <int BC>
struct Smem {
  float kd[2][PANEL][2 * PANEL]; // K[i0+t][i0+u], u < 64: diagonal block,
                                 // then the next panel's (look-ahead)
  float dl[2][PANEL][BC];        // panel's deltas, sweeper -> bulk
  float cs[2][PANEL][BC + 1];    // panel's c (the sweeper's, written back)
  float ls[2][PANEL][BC + 1];
  float hs[2][PANEL][BC + 1];
  float gp[2][PANEL][BC + 1];    // panel's rows of g, bulk -> sweeper
  long long coff[BC];            // column offsets: fold * n * P + p
};

// Stage panel q's c, lo, hi and diagonal block of K into buffer b (sweeper).
template <int BC>
__device__ __forceinline__ void stage_panel(Smem<BC>& sm, int b, int q,
                                            const float* ks, const float* cb,
                                            const float* lob,
                                            const float* hib, int n, int P,
                                            int ncol, int lane) {
  const int i0 = q * PANEL;
  const int i = i0 + lane;
  const bool row_ok = i < n;
  for (int t = 0; t < PANEL; ++t) {
    const bool ok = row_ok && i0 + t < n;
    const bool ok2 = i + PANEL < n && i0 + t < n;
    cp_async4(&sm.kd[b][t][lane],
              ok ? ks + (size_t)(i0 + t) * n + i : ks, ok);
    cp_async4(&sm.kd[b][t][PANEL + lane],
              ok2 ? ks + (size_t)(i0 + t) * n + i + PANEL : ks, ok2);
  }
#pragma unroll
  for (int p = 0; p < BC; ++p) {
    const bool ok = row_ok && p < ncol;
    const size_t o = ok ? (size_t)sm.coff[p] + (size_t)i * P : 0;
    cp_async4(&sm.cs[b][lane][p], cb + o, ok);
    cp_async4(&sm.ls[b][lane][p], lob + o, ok);
    cp_async4(&sm.hs[b][lane][p], hib + o, ok);
  }
  cp_async_commit();
}

// The sweeper: one warp, lane = column p + BC * h, holding rows h*BC + m
// (m < BC) of its column of the panel.
template <int BC>
__device__ void sweeper(Smem<BC>& sm, const float* ks, float* cb,
                        const float* lob, const float* hib, int n, int P,
                        int ncol, int npan) {
  const int lane = threadIdx.x & 31;
  const int p = lane % BC, h = lane / BC;
  stage_panel(sm, 0, 0, ks, cb, lob, hib, n, P, ncol, lane);
  for (int q = 0; q < npan; ++q) {
    const int b = q & 1;
    const int tn = min(PANEL, n - q * PANEL);
    cp_async_wait_all();
    __syncwarp();
    // panel rows from the bulk; the look-ahead is then done with buffer b^1
    bar_sync(BAR_READY_G + b, 64);
    if (q + 1 < npan)
      stage_panel(sm, b ^ 1, q + 1, ks, cb, lob, hib, n, P, ncol, lane);
    if (q >= 2) bar_sync(BAR_FREE_D + b, CD_THREADS);   // deltas of q-2 read
    float gr[BC];
#pragma unroll
    for (int m = 0; m < BC; ++m) gr[m] = sm.gp[b][h * BC + m][p];
#pragma unroll
    for (int t = 0; t < PANEL; ++t) {
      if (t < tn) {
        const int ht = t / BC, mt = t % BC;
        float dl = 0.f;
        if (h == ht) {
          const float ci = sm.cs[b][t][p];
          const float d = fmaxf(sm.kd[b][t][t], 1e-12f);
          float tg = __fsub_rn(ci, __fdiv_rn(gr[mt], d));
          tg = fminf(fmaxf(tg, sm.ls[b][t][p]), sm.hs[b][t][p]);
          dl = __fsub_rn(tg, ci);
          sm.cs[b][t][p] = tg;
          sm.dl[b][t][p] = dl;
        }
        dl = __shfl_sync(0xffffffffu, dl, p + BC * ht);
        // rows <= t are not read again in this panel (the bulk's copy of
        // the panel rows is the result): skip an m when no lane's row needs it
        const float* kt = &sm.kd[b][t][h * BC];
#pragma unroll
        for (int m = 0; m < BC; ++m)
          if ((32 / BC - 1) * BC + m > t)
            gr[m] = __fadd_rn(gr[m], __fmul_rn(kt[m], dl));
      }
    }
    __syncwarp();
    bar_arrive(BAR_READY_D + b, CD_THREADS);
    // write the panel's c back (lane = row)
    const int i = q * PANEL + lane;
    if (lane < tn) {
#pragma unroll
      for (int pp = 0; pp < BC; ++pp)
        if (pp < ncol)
          cb[(size_t)sm.coff[pp] + (size_t)i * P] = sm.cs[b][lane][pp];
    }
    __syncwarp();
  }
  // match the bulk's arrivals for the last two panels
  for (int q = max(npan - 2, 0); q < npan; ++q)
    bar_sync(BAR_FREE_D + (q & 1), CD_THREADS);
}

// the look-ahead: a copy of row slot j (the next panel's rows) takes panel
// q's deltas (buffer b, tn of them), with K from the sweeper's staged block
// (zero past n), and goes to the sweeper; the registers take the same
// operations in the same order in the regular pass
template <int R, int BC>
__device__ __forceinline__ void look_ahead(const float (&gr)[R][BC], int j,
                                           Smem<BC>& sm, int b, int tn,
                                           int lane) {
  float x[BC];
#pragma unroll
  for (int jj = 0; jj < R; ++jj)
    if (jj == j) {
#pragma unroll
      for (int p = 0; p < BC; ++p) x[p] = gr[jj][p];
    }
  for (int t = 0; t < tn; ++t) {
    const float kv = sm.kd[b][t][PANEL + lane];
    const float* dv = sm.dl[b][t];
#pragma unroll
    for (int p = 0; p < BC; ++p) x[p] = __fadd_rn(x[p], __fmul_rn(kv, dv[p]));
  }
#pragma unroll
  for (int p = 0; p < BC; ++p) sm.gp[b ^ 1][lane][p] = x[p];
}

// apply panel q's deltas (buffer b, tn of them) to every row slot, K read
// by rows from global memory (L2: the blocks of a slot walk K together),
// TU coordinates of loads in flight.  FULL: tn == PANEL, no bounds on the
// coordinates where TU divides the panel
template <int R, int BC, bool FULL>
__device__ __forceinline__ void apply_panel(float (&gr)[R][BC],
                                            const Smem<BC>& sm, int b,
                                            const float* kpan, int n, int tn,
                                            int bt) {
  constexpr int TU = tu(R, BC);
  constexpr bool ALL = FULL && PANEL % TU == 0;   // no chunk passes tn
  for (int t0 = 0; t0 < tn; t0 += TU) {
    float kv[TU][R];
#pragma unroll
    for (int u = 0; u < TU; ++u)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = j * BULK + bt;
        kv[u][j] = (r < n && (ALL || t0 + u < tn))
                       ? __ldg(kpan + (size_t)(t0 + u) * n + r)
                       : 0.f;
      }
#pragma unroll
    for (int u = 0; u < TU; ++u) {
      if (ALL || t0 + u < tn) {
        const float* dv = sm.dl[b][t0 + u];
        float d[BC];
#pragma unroll
        for (int p = 0; p < BC; ++p) d[p] = dv[p];
#pragma unroll
        for (int j = 0; j < R; ++j)
#pragma unroll
          for (int p = 0; p < BC; ++p)
            gr[j][p] = __fadd_rn(gr[j][p], __fmul_rn(kv[u][j], d[p]));
      }
    }
  }
}

// R rows a bulk thread (rows j * 480 + bt), BC columns a block.
template <int R, int BC>
__global__ void __launch_bounds__(CD_THREADS, 1)
cd_wave_epoch_kernel(const float* __restrict__ k, float* __restrict__ c,
                     float* __restrict__ g, const float* __restrict__ lo,
                     const float* __restrict__ hi, int F, int n, int P) {
  __shared__ __align__(16) Smem<BC> sm;
  const int s = blockIdx.y;
  const int col0 = blockIdx.x * BC;
  const int ncol = min(BC, F * P - col0);
  const size_t base = (size_t)s * F * n * P;
  const float* ks = k + (size_t)s * n * n;
  const int tid = threadIdx.x;
  if (tid < BC) {
    const int cc = min(col0 + tid, F * P - 1);
    const int f = cc / P;
    sm.coff[tid] = (long long)f * n * P + (cc - f * P);
  }
  __syncthreads();
  const int npan = (n + PANEL - 1) / PANEL;
  if (tid < 32) {
    sweeper<BC>(sm, ks, c + base, lo + base, hi + base, n, P, ncol, npan);
    return;
  }

  // ---- the bulk: 15 warps, g in registers
  const int bt = tid - 32;
  const int w = bt >> 5, lane = bt & 31;
  float* gb = g + base;
  float gr[R][BC];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = j * BULK + bt;
#pragma unroll
    for (int p = 0; p < BC; ++p)
      gr[j][p] = (r < n && p < ncol)
                     ? gb[(size_t)sm.coff[p] + (size_t)r * P] : 0.f;
  }
  if (w == 0) {                        // panel 0's rows: warp 0, slot 0
    look_ahead<R, BC>(gr, 0, sm, 1, 0, lane);   // into buffer 0, no deltas
    __syncwarp();
    bar_arrive(BAR_READY_G, 64);
  }
  for (int q = 0; q < npan; ++q) {
    const int b = q & 1;
    const int i0 = q * PANEL;
    const int tn = min(PANEL, n - i0);
    const float* kpan = ks + (size_t)i0 * n;
    bar_sync(BAR_READY_D + b, CD_THREADS);
    const int qn = q + 1;
    if (qn < npan && w == qn % BULK_WARPS) {
      look_ahead<R, BC>(gr, qn / BULK_WARPS, sm, b, tn, lane);
      __syncwarp();
      bar_arrive(BAR_READY_G + (b ^ 1), 64);
    }
    if (tn == PANEL)
      apply_panel<R, BC, true>(gr, sm, b, kpan, n, tn, bt);
    else
      apply_panel<R, BC, false>(gr, sm, b, kpan, n, tn, bt);
    bar_arrive(BAR_FREE_D + b, CD_THREADS);
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = j * BULK + bt;
    if (r < n) {
#pragma unroll
      for (int p = 0; p < BC; ++p)
        if (p < ncol) gb[(size_t)sm.coff[p] + (size_t)r * P] = gr[j][p];
    }
  }
}

template <int R, int BC>
cudaError_t launch(const float* k, float* c, float* g, const float* lo,
                   const float* hi, int S, int F, int n, int P,
                   cudaStream_t st) {
  dim3 grid((F * P + BC - 1) / BC, S);
  cd_wave_epoch_kernel<R, BC><<<grid, CD_THREADS, 0, st>>>(k, c, g, lo, hi,
                                                           F, n, P);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// k (S, n, n) symmetric per slot; c, g (S, F, n, P) updated in place; lo, hi
// (S, F, n, P); all fp32 contiguous.  rows: the rows a bulk thread owns
// (1, 2, 4, .., 32; 480 rows >= n); cols: the columns a block holds, 16
// (or 8 at rows <= 4, for grids that would leave SMs idle) and 64 / rows
// from 8 rows on.  Limits checked by the Python wrapper: n <= 15360, S at
// most 65535, F P below 2^31.  Returns cudaGetLastError().
int cd_wave_epoch(const float* k, float* c, float* g, const float* lo,
                  const float* hi, int S, int F, int n, int P, int rows,
                  int cols, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CD_LAUNCH(R, BC) \
  if (rows == R && cols == BC) \
    return (int)launch<R, BC>(k, c, g, lo, hi, S, F, n, P, st);
  CD_LAUNCH(1, 16) CD_LAUNCH(2, 16) CD_LAUNCH(4, 16)
  CD_LAUNCH(1, 8) CD_LAUNCH(2, 8) CD_LAUNCH(4, 8)
  CD_LAUNCH(8, 8) CD_LAUNCH(16, 4) CD_LAUNCH(32, 2)
#undef CD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
