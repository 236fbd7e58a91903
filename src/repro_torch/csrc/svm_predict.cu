// Fused multi-cell SVM prediction (B3) for Hopper.
//
// svm_predict_cells_f32 replaces svm_predict_cells_pallas in
// src/repro/kernels/svm_predict/svm_predict.py: for each cell (launch
// slot) c, out[c] = sum over support vectors j of
// k_{gamma_p}(x_i, sv_j) * coef[c, j, p], with D2(x_i, sv_j) computed once
// and the Gaussian or Laplacian epilogue replayed per column p with that
// column's gamma.  The kernel matrix is never written to device memory.
// B8 (svm_predict_pallas, svm_predict.py:63) is this kernel at one cell.
//   Bound on the H100: a serving wave reads each slot's whole SV table
//   (2048 x 54 fp32, 442 KB) and coefficients (57 KB) for 8 query rows:
//   a 256-slot wave moves ~128 MB, 0.038 ms at 3.35 TB/s.  Its fp32 FMAs
//   (~0.45 GFLOP) and P exponentials a (row, SV) pair come second.
//   Design:
//   * One 128-thread block owns (slot, ROWS query rows, up to 64 columns,
//     one split of the SV axis).  Its query rows stay in shared memory,
//     feature-major, for the whole launch (a 16-byte broadcast load gives
//     4 rows of one feature), with their norms.  The SV table streams in
//     tiles of 128 rows (one a thread) through a 2-stage ring, each stage
//     a tile's feature chunk and, with its last chunk, its coefficient
//     rows: the next chunk is in flight while one computes.  The plan
//     (predict_plan in ops.py) alone fixes this layout: the chunk, the row
//     strides and the stage size come in as arguments.  Where a tile is
//     two contiguous 16-byte-aligned spans (its rows whole and at their
//     own stride, all P <= 64 columns in the block, read at stride P with
//     at most a 16-way bank conflict: the serving wave's d 54, P 7), one
//     thread hands both to the TMA unit (cp.async.bulk, completion on an
//     mbarrier); else every thread issues 16-, 8- or 4-byte cp.async
//     copies (as d and the table's alignment allow), the coefficients to
//     an odd stride.  At d 54 a stage is 31 KB and three blocks share an
//     SM: ~93 KB in flight an SM.  A chunk is the whole
//     row up to 64 features (54 for 54: no padding), else 64 (fewer where
//     the rows do not fit in shared memory).  The smem row stride is d,
//     or d padded so that the thread-per-row vector loads are free of bank
//     conflicts.
//   * Slots too few to fill the card split the SV axis
//     (predict_splits() in ops.py): each split writes its ROWS x P partial
//     to a workspace and the block that arrives last at a per-(slot, row
//     tile, column block) ticket sums the partials in split order and
//     resets the ticket.  No atomics touch the values: the output is
//     bitwise the same from run to run.
//   * Epilogue: D2 = max(|x|^2 + |z|^2 - 2 x.z, 0) once a pair; per
//     column one multiply by the block's folded scale s_p = -log2(e) /
//     max(gamma_p^2, 1e-12) (Gaussian; the Laplacian's -log2(e) /
//     max(gamma_p, 1e-12) after one sqrtf(D2 + 1e-12) a pair), one
//     ex2.approx.ftz and one FMA with the coefficient; no division.
//     Error budget against exp(-root / den): the folded scale and the
//     product add at most 1.1 |a| 2^-23 relative (a = root * s_p, the
//     exponent in log2 units: three fp32 roundings times ln 2), ex2.approx
//     at most 2^-22, and results below 2^-126 flush to zero.  For the |a|
//     <= 126 that survive that is well inside the k * eps a term that
//     predict_bound allows (k = 2048 SVs at a serving slot).
//     tests/test_torch_kernels.py holds a plain model of this epilogue to
//     the same budget.
//   * A thread sums its SVs in order; a fixed xor-shuffle tree and a fixed
//     loop over warps reduce across threads; zero-coefficient rows (SV
//     padding) contribute exactly zero.
//   The cross term is plain fp32 FMAs (no TF32).
//   Tried and slower on the H100 (at the serving wave unless named):
//   every thread issuing cp.async copies in place of the TMA spans (the
//   copies and the arithmetic, each fast enough alone, overlapped badly:
//   0.064, 0.065, 0.068, 0.126 ms against 0.049, 0.050, 0.050, 0.121 at
//   P 6, 7, 8, 16, scripts/kernel_turns.py --b3-paths, H100 80GB HBM3 at
//   700 W); the TMA spans at P 32 and 64, whose stride-P coefficient
//   reads take 32-way bank conflicts (0.342 and 1.382 ms against 0.307
//   and 0.927 by copies);
//   a 3-stage ring (two blocks an SM instead of three; B8 slower too);
//   256 threads and 256-row tiles (one block an SM); two SV rows a thread
//   (64-thread blocks: fewer warps hid less at every shape).  At the LM
//   head's wave (4 x 16 x 704 x d 2048, P 3) neither a 3- or 4-stage ring,
//   narrower chunks nor batched query-row loads helped: its 48 blocks
//   each walk 32 short chunks with 4 warps, a latency chain that only
//   more threads on a row's features would cut.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PR_T = 128;             // threads = SV rows a tile
constexpr int PR_WARPS = PR_T / 32;
constexpr int PR_ACC = 64;            // ROWS * PMAX accumulators a thread
constexpr int PR_NST = 2;             // ring stages
constexpr float PR_LOG2E = 1.4426950408889634f;

template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;"
                 ::"r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
  else if (BYTES == 8)
    asm volatile("cp.async.ca.shared.global.L2::128B [%0], [%1], 8, %2;"
                 ::"r"(d), "l"(src), "r"(valid ? 8 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global.L2::128B [%0], [%1], 4, %2;"
                 ::"r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// spins until the phase with the given parity has completed; a copy that
// never lands (a fault) traps after ~10 s instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  do {
    if (clock64() - t0 > 20000000000LL) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// one contiguous span of global memory into shared memory by the TMA unit
// (bytes a multiple of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// PR_T rows x w columns of a row-major src (row stride lds) into dst (row
// stride ldd) in V-float copies, rows >= rvalid zero-filled; the thread's
// (row, column) advances without a division per copy
template <int V>
__device__ __forceinline__ void copy_tile(float* dst, int ldd, const float* src,
                                          int lds, int rvalid, int w) {
  const int upr = w / V;
  const int drow = PR_T / upr, dcu = PR_T - drow * upr;
  int row = threadIdx.x / upr, cu = threadIdx.x - row * upr;
  for (int u = threadIdx.x; u < PR_T * upr; u += PR_T) {
    const bool ok = row < rvalid;
    cp_async<4 * V>(dst + row * ldd + cu * V,
                    ok ? src + (size_t)row * lds + cu * V : src, ok);
    row += drow;
    cu += dcu;
    if (cu >= upr) { cu -= upr; ++row; }
  }
}

// ROWS query-row values of one feature, feature-major in shared memory
template <int ROWS>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[ROWS]) {
  if constexpr (ROWS >= 4) {
#pragma unroll
    for (int r = 0; r < ROWS; r += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + r);
      v[r] = q.x; v[r + 1] = q.y; v[r + 2] = q.z; v[r + 3] = q.w;
    }
  } else if constexpr (ROWS == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

template <int V>
__device__ __forceinline__ void load_sv(const float* p, float (&s)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    s[0] = q.x; s[1] = q.y; s[2] = q.z; s[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    s[0] = q.x; s[1] = q.y;
  } else {
    s[0] = p[0];
  }
}

template <int ROWS, int PMAX, int V, bool BULK>
__global__ void __launch_bounds__(PR_T, 2)
predict_cells_kernel(const float* __restrict__ xt, const float* __restrict__ sv,
                     const float* __restrict__ coefs,
                     const float* __restrict__ gammas, float* __restrict__ out,
                     float* __restrict__ ws, int* __restrict__ tickets, int m,
                     int k, int d, int P, int kind, int dk, int ld,
                     int cld, int stage, int nsplit, int tps) {
  static_assert(ROWS * PMAX == PR_ACC, "accumulator budget");
  extern __shared__ __align__(16) float dyn[];
  __shared__ float red[PR_WARPS][PR_ACC];
  __shared__ float xn[ROWS];
  __shared__ float sc[PMAX];
  __shared__ int last;
  __shared__ uint64_t bars[PR_NST];     // BULK: one a ring stage

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int rtiles = (m + ROWS - 1) / ROWS;
  const int rt = blockIdx.x / nsplit, sp = blockIdx.x - rt * nsplit;
  const int c = blockIdx.y;
  const int i0 = rt * ROWS;
  const int p0 = blockIdx.z * PMAX;     // this block's columns: [p0, p0 + pb)
  const int pb = min(PMAX, P - p0);
  float* xs = dyn;                      // [d][ROWS]
  float* ring = dyn + ((d * ROWS + 3) & ~3);   // stages of `stage` floats:
                                               // PR_T x ld SVs, PR_T x cld
                                               // coefficients

  const int ntile = (k + PR_T - 1) / PR_T;
  const int t0 = sp * tps, t1 = min(ntile, t0 + tps);
  const int nch = (d + dk - 1) / dk;
  const int nitem = (t1 - t0) * nch;
  const float* svb = sv + (size_t)c * k * d;
  const float* cb = coefs + (size_t)c * k * P + p0;

  auto issue = [&](int q) {
    float* s = ring + (q % PR_NST) * stage;
    const int j0 = (t0 + q / nch) * PR_T, kc = q % nch, k0 = kc * dk;
    if (BULK) {             // one chunk: the tile's rows and coefficients
      if (t == 0) {         // are two contiguous spans
        const int rows = min(PR_T, k - j0);
        uint64_t* bar = bars + q % PR_NST;
        mbar_expect_tx(bar, 4u * rows * (d + P));
        bulk_copy(s, svb + (size_t)j0 * d, 4u * rows * d, bar);
        bulk_copy(s + PR_T * ld, cb + (size_t)j0 * P, 4u * rows * P, bar);
      }
      return;
    }
    copy_tile<V>(s, ld, svb + (size_t)j0 * d + k0, d, k - j0, min(dk, d - k0));
    if (kc == nch - 1)       // the coefficients travel with the last chunk
      copy_tile<1>(s + PR_T * ld, cld, cb + (size_t)j0 * P, P, k - j0, pb);
  };
  if (BULK && t == 0) {
    for (int i = 0; i < PR_NST; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int q = 0; q < PR_NST - 1; ++q) {
    if (q < nitem) issue(q);
    if (!BULK) cp_async_commit();
  }

  // the block's query rows, feature-major, and their norms (while the
  // first tiles are in flight)
  {
    const int r = t % ROWS;
    const bool ok = i0 + r < m;
    const float* xr = xt + ((size_t)c * m + i0 + r) * d;
    float part = 0.f;
    for (int f = t / ROWS; f < d; f += PR_T / ROWS) {
      const float v = ok ? xr[f] : 0.f;
      xs[f * ROWS + r] = v;
      part = fmaf(v, v, part);
    }
#pragma unroll
    for (int off = ROWS; off < 32; off <<= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane < ROWS) red[warp][lane] = part;
    if (t < pb) {
      const float g = gammas[(size_t)c * P + p0 + t];
      sc[t] = -PR_LOG2E / (kind == 0 ? fmaxf(g * g, 1e-12f) : fmaxf(g, 1e-12f));
    }
    __syncthreads();
    if (t < ROWS) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < PR_WARPS; ++w) s += red[w][t];
      xn[t] = s;
    }
  }

  float acc[ROWS][PMAX], cross[ROWS], xnr[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    cross[r] = 0.f;
#pragma unroll
    for (int p = 0; p < PMAX; ++p) acc[r][p] = 0.f;
  }
  float zz = 0.f;

  for (int q = 0; q < nitem; ++q) {
    if (BULK) mbar_wait(bars + q % PR_NST, (q / PR_NST) & 1);
    else cp_async_wait_all();
    __syncthreads();  // item q is in; item q - 1's stage is consumed
    if (q == 0) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) xnr[r] = xn[r];
    }
    if (q + PR_NST - 1 < nitem) issue(q + PR_NST - 1);
    if (!BULK) cp_async_commit();
    const float* s = ring + (q % PR_NST) * stage;
    const int kc = q % nch, k0 = kc * dk, w = min(dk, d - k0);
    const float* srow = s + t * ld;
    const float* xk = xs + k0 * ROWS;
#pragma unroll 2
    for (int f = 0; f < w; f += V) {
      float z[V];
      load_sv<V>(srow + f, z);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float xv[ROWS];
        load_rows<ROWS>(xk + (f + v) * ROWS, xv);
        zz = fmaf(z[v], z[v], zz);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) cross[r] = fmaf(xv[r], z[v], cross[r]);
      }
    }
    if (kc == nch - 1) {
      const int j = (t0 + q / nch) * PR_T + t;
      if (j < k) {
        float root[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float d2 = fmaxf(xnr[r] + zz - 2.f * cross[r], 0.f);
          root[r] = kind == 0 ? d2 : sqrtf(d2 + 1e-12f);
        }
        const float* cw = s + PR_T * ld + t * cld;
#pragma unroll
        for (int p = 0; p < PMAX; ++p) {
          if (p < pb) {
            const float wp = cw[p], scp = sc[p];
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
              acc[r][p] = fmaf(ex2(root[r] * scp), wp, acc[r][p]);
          }
        }
      }
      zz = 0.f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) cross[r] = 0.f;
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int p = 0; p < PMAX; ++p) {
      const float v = warp_sum(acc[r][p]);
      if (lane == 0) red[warp][r * PMAX + p] = v;
    }
  __syncthreads();
  if (nsplit == 1) {
    for (int e = t; e < ROWS * pb; e += PR_T) {
      const int r = e / pb, p = e % pb;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < PR_WARPS; ++w) s += red[w][r * PMAX + p];
      if (i0 + r < m) out[((size_t)c * m + i0 + r) * P + p0 + p] = s;
    }
    return;
  }
  // split SV axis: this split's partial, then the last block merges the
  // partials in split order and resets the ticket
  const size_t unit = ((size_t)c * gridDim.z + blockIdx.z) * rtiles + rt;
  float* wsb = ws + unit * nsplit * PR_ACC;
  for (int e = t; e < PR_ACC; e += PR_T) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < PR_WARPS; ++w) s += red[w][e];
    wsb[sp * PR_ACC + e] = s;
  }
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(tickets + unit, 1) == nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = t; e < ROWS * pb; e += PR_T) {
    const int r = e / pb, p = e % pb;
    float s = 0.f;
    for (int j = 0; j < nsplit; ++j)
      s += __ldcg(wsb + j * PR_ACC + r * PMAX + p);
    if (i0 + r < m) out[((size_t)c * m + i0 + r) * P + p0 + p] = s;
  }
  if (t == 0) tickets[unit] = 0;
}

template <int ROWS, int PMAX, int V, bool BULK>
int launch(const float* xt, const float* sv, const float* coefs,
           const float* gammas, float* out, float* ws, int* tickets, int C,
           int m, int k, int d, int P, int kind, int dk, int ld, int cld,
           int stage, int nsplit, int tps, int smem, cudaStream_t stream) {
  auto kern = predict_cells_kernel<ROWS, PMAX, V, BULK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((m + ROWS - 1) / ROWS * nsplit, C, (P + PMAX - 1) / PMAX);
  kern<<<grid, PR_T, smem, stream>>>(xt, sv, coefs, gammas, out, ws, tickets,
                                     m, k, d, P, kind, dk, ld, cld, stage,
                                     nsplit, tps);
  return (int)cudaGetLastError();
}

template <int V, bool BULK, typename... Args>
int launch_v(int P, Args... args) {
  if (P <= 8) return launch<8, 8, V, BULK>(args...);
  if (P <= 16) return launch<4, 16, V, BULK>(args...);
  if (P <= 32) return launch<2, 32, V, BULK>(args...);
  return launch<1, 64, V, BULK>(args...);
}

}  // namespace

extern "C" {

// xt (C, m, d), sv (C, k, d), coefs (C, k, P), gammas (C, P), out (C, m, P);
// all fp32, contiguous; k >= 1.  kind: 0 Gaussian RBF, 1 Laplacian.  P >= 1
// (more than 64 columns run as blocks of 64); C and ceil(P / 64) at most
// 65535.  The wrapper (kernels/svm_predict/ops.py, predict_plan) passes the
// plan: v the copy width in floats (v | d, the SV table v*4-byte aligned),
// bulk != 0 to move each tile as two contiguous spans by the TMA unit (one
// chunk, ld == d, P <= 64 and cld == P, every tile's spans 16-byte
// aligned), dk the feature chunk (a multiple of 4; one chunk when d <= dk),
// ld the shared row stride of a chunk, cld that of the coefficient rows (at
// least min(P, 64)), stage the floats a ring stage (128 ld + 128 cld
// rounded up to 4), nsplit splits of tps SV tiles each, smem the dynamic
// shared memory bytes.  With nsplit > 1, ws holds C * row
// tiles * column blocks * nsplit * 64 floats and tickets one zeroed int a
// (slot, row tile, column block) unit (the kernel leaves them zeroed).
int svm_predict_cells_f32(const float* xt, const float* sv, const float* coefs,
                          const float* gammas, float* out, float* ws,
                          int* tickets, int C, int m, int k, int d, int P,
                          int kind, int v, int bulk, int dk, int ld,
                          int cld, int stage, int nsplit, int tps, int smem,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PR_GO(V, B)                                                          \
  launch_v<V, B>(P, xt, sv, coefs, gammas, out, ws, tickets, C, m, k, d, P, \
                 kind, dk, ld, cld, stage, nsplit, tps, smem, s)
  if (bulk) {
    if (v == 4) return PR_GO(4, true);
    if (v == 2) return PR_GO(2, true);
    return PR_GO(1, true);
  }
  if (v == 4) return PR_GO(4, false);
  if (v == 2) return PR_GO(2, false);
  return PR_GO(1, false);
#undef PR_GO
}

}  // extern "C"
