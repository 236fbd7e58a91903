// Squared distances (B1, B1-sym), the one-shot Gram (B7) and the per-gamma
// kernel epilogue (B2) for Hopper.
//
// sq_dists_f32 replaces sq_dists_pallas (symmetric=False, the body
// _sq_dists_kernel / _d2_tile) in src/repro/kernels/kernel_matrix/
// kernel_matrix.py: D2 = max(|x|^2 + |z|^2 - 2 x.z, 0) in fp32, batched
// over a leading slot axis, (B, n, d) x (B, m, d) -> (B, n, m), one launch.
// sq_dists_sym_f32 replaces its symmetric body (_sq_dists_sym_kernel and
// the out map _sym_out_map): the train Gram's D2 of a whole wave of cells,
// (B, n, d) -> (B, n, n).  gram_f32 replaces gram_pallas (_gram_kernel):
// K = k_gamma(x, z), (n, d) x (m, d) -> (n, m), the D2 tile with the gamma
// epilogue applied in registers, so D2 is never stored.
//
//   Arithmetic contract, which fixes every D2 bit: each pair's cross term
//   is one fp32 FMA chain from 0 over the features in ascending order, each
//   squared norm the same kind of chain, D2 = max((|x|^2 + |z|^2) - 2 x.z,
//   0).  No tensor cores (3xTF32 included): the FMAs are not what bounds
//   these kernels.  So every D2 value is the same whichever kernel, tile or
//   slot computes it: B1-sym(x) equals B1(x, x) bitwise (products and the
//   two norms commute), B1-sym is bitwise symmetric without a read-back,
//   and B7 equals gram_from_d2(sq_dists(x, z)) bitwise.
//
//   The launch plan (sq_dists_plan in kernels/kernel_matrix/ops.py) picks
//   one of two kernels by shape; B1-sym and B7 always take the tile.
//
//   * Few query rows a slot (n <= 16: the serving wave, 256 slots x 8 rows
//     x 2048 SVs x d 54).  Bound by reading z (113 MB at the serving wave,
//     each z row used by only 8 x rows) and writing D2 (17 MB): 0.039 ms at
//     3.35 TB/s; the FMAs take 0.007 ms.  d2_rows_kernel: a grid of as many
//     128-thread blocks as the card holds at once walks the (slot, 8-row
//     tile, 128-row z tile) items in order, each block a contiguous run of
//     them, one z row a thread.  The z tiles stream through a 3-stage ring,
//     two in flight while one computes and is stored: where a tile is one
//     16-byte-aligned contiguous span whose rows read conflict-free at
//     their own stride (d 54), one thread hands it to the TMA unit
//     (cp.async.bulk marked evict-first in L2: z is read once; mbarrier
//     completion), else every thread issues 16-, 8- or 4-byte cp.async
//     copies to a padded stride, in feature chunks of 64 for wide rows.  A
//     slot's 8 x rows sit in shared memory feature-major (two 16-byte
//     broadcast loads a feature); their norms are summed in the first z
//     tile's FMA loop.  Each warp store is one whole 128-byte line of a D2
//     row (streaming; 16-byte stores would need a shuffle transpose for
//     the same lines).
//
//   * Many query rows (the fit's test phase, B7) and the symmetric D2.
//     The training wave (16 x 1824^2) writes 213 MB (0.064 ms) beside 1.44 G
//     upper-half FMAs (0.043 ms at the fp32 rate); the LM head's d 2048 is
//     bound by its FMAs.  d2_tile_kernel: a 256-thread block owns a 128 x
//     128 tile (for B1-sym an upper tile pair bi <= bj of one slot), 8 x 8
//     values a thread in registers, and walks tiles k, k + grid, ... (a
//     grid of as many blocks as the card holds: two an SM).  Each item (a
//     whole tile up to d = 54, else 32 features) lands row-major in a raw
//     buffer: one contiguous span a row block by the TMA unit where it is
//     16-byte aligned at its own stride (d = 2 mod 4: d 54), else 8- or
//     4-byte cp.async copies to a stride of 2 mod 4.  All threads transpose
//     it to feature-major (8-byte reads, 4-byte writes, both conflict-free)
//     and the next item's copy is issued at once, so it lands while this one
//     computes and is stored.  A thread takes its 8 + 8 items of a feature
//     in four 16-byte shared loads for 64 FMAs; the block's row norms are
//     summed from shared memory beside them.  The tile is stored from
//     registers with 16-byte streaming stores where rows keep 16-byte
//     alignment (n, m multiples of 4): a warp covers 8 rows x 64 bytes.
//     B1-sym also stores the mirror (j, i) of an off-diagonal tile: a
//     thread's 4 consecutive rows of one column are 4 consecutive words of
//     the mirrored row, so the mirror is 16-byte stores as well (a warp: 4
//     rows x 128 bytes), with no shared memory; a diagonal tile is stored
//     once, each value to its own place (its values are symmetric by the
//     contract).  Rows are masked at the ragged edge; n is not padded.
//   What holds the tile (H100 80GB HBM3 at 700 W, builds of this file with
//   parts switched off, timed with CUDA events): the
//   8 x 8 tile asks shared memory for 16 floats a thread a feature, as
//   many cycles as its 64 FMAs issue, and the transposition and the 16-
//   byte stores use the same pipe.  At the training wave the FMA side
//   alone took ~0.10 ms (18 % of it on the ragged last tile and the
//   diagonal tiles' lower halves; 1920 tiles over 264 blocks leave the last
//   round 27 % full) and the stores added ~0.03.  Tried and slower: 4-byte
//   cp.async straight to feature-major (~2 floats a cycle an SM: 0.160 ms);
//   FMAs from the row-major buffer with 8-byte loads (twice the load
//   instructions, 128 registers with spills: 0.155); 16 x 8 values a thread
//   at 128 threads (0.150 at two blocks an SM; spills at three); items of
//   28 features at d 54 (0.157); a 2- or 4-stage ring in the few-rows
//   kernel (0.0587 / 0.0544 against 0.0525 at 3 stages, before evict-
//   first).
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

#include "async_copy.cuh"

namespace {

using namespace async_copy;

// --------------------------------------------------- the register tile
constexpr int TL = 128;         // square tile
constexpr int TL_T = 256;       // threads: 16 (tx) x 16 (ty), 8 x 8 values each

// item i (0..7) of a thread's 8 rows (or columns) of the tile: two groups
// of 4 consecutive rows, 64 apart
__device__ __forceinline__ int tl_item(int q, int i) {
  return (i / 4) * 64 + 4 * q + i % 4;
}

// ROWS rows x wp features of a row-major src (row stride lds) into dst (row
// stride ldd) in V-float cp.async copies by T threads, consecutive threads
// on consecutive words of a row; rows >= rvalid and features >= w (a pad)
// zero-filled.  The thread's (row, column) advances without a division per
// copy.
template <int V, int T, int ROWS>
__device__ __forceinline__ void copy_rows(float* dst, int ldd, const float* src,
                                          int lds, int rvalid, int w, int wp) {
  const int upr = wp / V;
  if (upr == 0) return;                      // d == 0: nothing to copy
  const int drow = T / upr, dcu = T - drow * upr;
  int row = threadIdx.x / upr, cu = threadIdx.x - row * upr;
  for (int u = threadIdx.x; u < ROWS * upr; u += T) {
    const bool ok = row < rvalid && cu * V < w;
    cp_async<4 * V>(dst + row * ldd + cu * V,
                    ok ? src + (size_t)row * lds + cu * V : src, ok);
    row += drow;
    cu += dcu;
    if (cu >= upr) { cu -= upr; ++row; }
  }
}

// TL rows x wp features, row-major at stride ld (2 mod 4 words), to
// feature-major dst[k * TL + r]: a warp moves 32 consecutive rows of one
// feature pair, 8-byte reads at an odd float2 stride and 4-byte writes to
// consecutive words, both free of bank conflicts
__device__ __forceinline__ void tl_transpose(float* dst, const float* raw,
                                             int ld, int wp) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int u = warp; u < (TL / 32) * (wp / 2); u += TL_T / 32) {
    const int r = (u % (TL / 32)) * 32 + lane, k = 2 * (u / (TL / 32));
    const float2 v = *reinterpret_cast<const float2*>(raw + r * ld + k);
    dst[k * TL + r] = v.x;
    dst[(k + 1) * TL + r] = v.y;
  }
}

// acc[i][j] += A[row i] . B[row j] over features [0, w), A and B
// feature-major (a thread's 8 + 8 items of a feature in four 16-byte
// loads): one ascending FMA chain a pair; nrm += |S|^2 the same way, S the
// thread's own norm row
__device__ __forceinline__ void tl_fma(const float* __restrict__ A,
                                       const float* __restrict__ B,
                                       const float* __restrict__ S, int w,
                                       int tx, int ty, float (&acc)[8][8],
                                       float& nrm) {
  const float* a = A + 4 * ty;
  const float* b = B + 4 * tx;
#pragma unroll 2
  for (int k = 0; k < w; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + k * TL);
    const float4 a1 = *reinterpret_cast<const float4*>(a + k * TL + 64);
    const float4 b0 = *reinterpret_cast<const float4*>(b + k * TL);
    const float4 b1 = *reinterpret_cast<const float4*>(b + k * TL + 64);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
#pragma unroll 4
  for (int k = 0; k < w; ++k) {
    const float v = S[k * TL];
    nrm = fmaf(v, v, nrm);
  }
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));
}

struct Tile {
  int b, i0, j0;
};

// tile t of the launch: SYM the upper pairs bi <= bj of each slot, else the
// (row tile, column tile) grid of each slot
template <bool SYM>
__device__ __forceinline__ Tile tl_tile(int t, int ti, int tj) {
  Tile r;
  if (SYM) {
    const int pairs = ti * (ti + 1) / 2;
    r.b = t / pairs;
    int rem = t - r.b * pairs, bi = 0;
    while (rem >= ti - bi) { rem -= ti - bi; ++bi; }
    r.i0 = bi * TL;
    r.j0 = (bi + rem) * TL;
  } else {
    r.b = t / (ti * tj);
    const int u = t - r.b * ti * tj;
    r.i0 = (u / tj) * TL;
    r.j0 = (u - (u / tj) * tj) * TL;
  }
  return r;
}

// EPI: 0 stores D2 (B1), 1 the Gaussian and 2 the Laplacian kernel of it
// (B7).  SYM: the upper tile pairs of x with itself, each off-diagonal tile
// also stored mirrored (B1-sym).  A persistent grid: block k walks tiles k,
// k + grid, ... in items of dk features.  An item's two row blocks land
// row-major (stride ld) in a raw buffer, are transposed to feature-major
// for the FMAs, and the next item's copy is issued at once, so it lands
// while this one computes and is stored.  BULK: one item a tile, each row
// block one contiguous span moved by the TMA unit (ld == d); else
// per-thread V-float copies.  vec: output rows keep 16-byte alignment.
template <int EPI, bool SYM, int V, bool BULK>
__global__ void __launch_bounds__(TL_T, 2)
d2_tile_kernel(const float* __restrict__ x, const float* __restrict__ z,
               float* __restrict__ out, int n, int m, int d, int dk, int ld,
               int tiles, float denom, bool vec) {
  extern __shared__ __align__(16) float sm[];
  __shared__ __align__(16) float na[TL];
  __shared__ __align__(16) float nb[TL];
  __shared__ uint64_t bar;                   // BULK: the raw buffer's
  const int mm = SYM ? n : m;                // columns of the output
  const int ti = (n + TL - 1) / TL, tj = (mm + TL - 1) / TL;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = (warp & 3) * 4 + (lane & 3), ty = (warp >> 2) * 8 + (lane >> 2);
  const int nch = d > 0 ? (d + dk - 1) / dk : 1;
  const int ntile = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / gridDim.x;
  const int nitem = ntile * nch;
  const int dkp = dk + (dk & 1);             // features a chunk, even
  float* raw = sm;                           // A rows, B rows: 2 TL x ld
  float* comp = sm + 2 * TL * ld;            // A, B feature-major: 2 dkp x TL

  auto issue = [&](int q) {
    const Tile tl = tl_tile<SYM>(blockIdx.x + (q / nch) * gridDim.x, ti, tj);
    const int k0 = (q % nch) * dk, w = min(dk, d - k0);
    const bool same = SYM && tl.i0 == tl.j0;
    const float* xa = x + ((size_t)tl.b * n + tl.i0) * d + k0;
    const float* zb = (SYM ? x + ((size_t)tl.b * n + tl.j0) * d
                           : z + ((size_t)tl.b * m + tl.j0) * d) + k0;
    if (BULK) {
      if (tid == 0) {
        const uint32_t ba = 4u * min(TL, n - tl.i0) * d;
        const uint32_t bb = same ? 0u : 4u * min(TL, mm - tl.j0) * d;
        mbar_expect_tx(&bar, ba + bb);
        bulk_copy(raw, xa, ba, &bar);
        if (!same) bulk_copy(raw + TL * ld, zb, bb, &bar);
      }
    } else {
      const int wp = w + (w & 1);
      copy_rows<V, TL_T, TL>(raw, ld, xa, d, n - tl.i0, w, wp);
      if (!same) copy_rows<V, TL_T, TL>(raw + TL * ld, ld, zb, d, mm - tl.j0, w, wp);
      cp_async_commit();
    }
  };
  if (BULK && tid == 0) {
    mbar_init(&bar);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (nitem > 0) issue(0);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float nrm = 0.f;   // thread t: |row|^2 of row t of A (t < TL) or of B
  for (int q = 0; q < nitem; ++q) {
    const Tile tl = tl_tile<SYM>(blockIdx.x + (q / nch) * gridDim.x, ti, tj);
    const bool same = SYM && tl.i0 == tl.j0;
    const int c = q % nch, w = min(dk, d - c * dk), wp = w + (w & 1);
    if (BULK) mbar_wait(&bar, q & 1);
    else cp_async_wait<0>();
    __syncthreads();   // item q is in; the last item's FMAs are done
    tl_transpose(comp, raw, ld, wp);
    if (!same) tl_transpose(comp + dkp * TL, raw + TL * ld, ld, wp);
    __syncthreads();   // item q is feature-major; the raw buffer is free
    if (q + 1 < nitem) issue(q + 1);
    const float* A = comp;
    const float* B = same ? comp : comp + dkp * TL;
    tl_fma(A, B, (tid < TL ? A : B) + tid % TL, w, tx, ty, acc, nrm);
    if (c < nch - 1) continue;

    // the tile's epilogue
    (tid < TL ? na : nb)[tid % TL] = nrm;
    nrm = 0.f;
    __syncthreads();
    float nbv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) nbv[j] = nb[tl_item(tx, j)];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float nai = na[tl_item(ty, i)];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = fmaxf(nai + nbv[j] - 2.f * acc[i][j], 0.f);
        acc[i][j] = EPI == 0 ? v
                  : EPI == 1 ? expf(-v / denom)
                             : expf(-sqrtf(v + 1e-12f) / denom);
      }
    }
    float* ob = out + (size_t)tl.b * n * mm;
    // (i, j) to (i, j): a warp stores 8 rows x 64 bytes an instruction
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = tl.i0 + tl_item(ty, i);
      if (r >= n) continue;
      float* orow = ob + (size_t)r * mm;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = tl.j0 + 64 * h + 4 * tx;
        if (vec) {
          if (col < mm)
            store4(orow + col, acc[i][4 * h], acc[i][4 * h + 1],
                   acc[i][4 * h + 2], acc[i][4 * h + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < mm) __stcs(orow + col + e, acc[i][4 * h + e]);
        }
      }
    }
    // mirror: (i, j) to (j, i); tile bi < bj is whole, so only j is
    // masked.  A warp stores 4 rows x 128 bytes an instruction.
    if (SYM && !same) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = tl.j0 + tl_item(tx, j);
        if (r >= n) continue;
        float* orow = ob + (size_t)r * n;
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const int col = tl.i0 + tl_item(ty, 4 * g);
          if (vec) {
            store4(orow + col, acc[4 * g][j], acc[4 * g + 1][j],
                   acc[4 * g + 2][j], acc[4 * g + 3][j]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) __stcs(orow + col + e, acc[4 * g + e][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
}

// ------------------------------------------------ the few-rows stream
constexpr int RW_T = 128;     // threads = z rows a tile
constexpr int RW_ROWS = 8;    // x rows a block holds
constexpr int RW_NST = 3;     // ring stages

template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&s)[V]) {
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

// cross[r] += x_r . z over features [0, w) of the chunk (xk: the chunk's x
// rows, feature-major; zr: this thread's z row), zz += |z|^2; NORM also
// sums the x rows' norms (the first z tile of an x row tile)
template <int V, bool NORM>
__device__ __forceinline__ void rw_fma(const float* __restrict__ xk,
                                       const float* __restrict__ zr, int w,
                                       float (&cross)[RW_ROWS], float& zz,
                                       float (&xn)[RW_ROWS]) {
#pragma unroll 2
  for (int f = 0; f < w; f += V) {
    float zv[V];
    load_v<V>(zr + f, zv);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float4 p = *reinterpret_cast<const float4*>(xk + (f + v) * RW_ROWS);
      const float4 q = *reinterpret_cast<const float4*>(xk + (f + v) * RW_ROWS + 4);
      const float xv[RW_ROWS] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
      zz = fmaf(zv[v], zv[v], zz);
#pragma unroll
      for (int r = 0; r < RW_ROWS; ++r) cross[r] = fmaf(xv[r], zv[v], cross[r]);
      if (NORM) {
#pragma unroll
        for (int r = 0; r < RW_ROWS; ++r) xn[r] = fmaf(xv[r], xv[r], xn[r]);
      }
    }
  }
}

// Items u in [0, items) are (slot, x row tile of 8, z tile of RW_T) in that
// order, each in nch chunks of dk features; block b walks items [b ipb,
// (b + 1) ipb).  BULK: each item one chunk, one contiguous 16-byte-aligned
// span copied by the TMA unit, rows at stride ld == d.
template <int V, bool BULK>
__global__ void __launch_bounds__(RW_T)
d2_rows_kernel(const float* __restrict__ x, const float* __restrict__ z,
               float* __restrict__ out, int n, int m, int d, int dk, int ld,
               int stage, long long items, int ipb) {
  extern __shared__ __align__(16) float dyn[];
  __shared__ uint64_t bars[RW_NST];           // BULK: one a ring stage
  float* xs = dyn;                             // [d][RW_ROWS]
  float* ring = dyn + RW_ROWS * d;             // RW_NST x stage floats
  const int t = threadIdx.x;
  const int rtiles = (n + RW_ROWS - 1) / RW_ROWS;
  const int ntile = (m + RW_T - 1) / RW_T;
  const int nch = (d + dk - 1) / dk;
  const long long u0 = (long long)blockIdx.x * ipb;
  const int nitem = (int)(min(items, u0 + ipb) - u0) * nch;

  auto issue = [&](int q) {
    const long long u = u0 + q / nch;
    const long long key = u / ntile;          // slot * rtiles + row tile
    const int j0 = (int)(u - key * ntile) * RW_T, k0 = (q % nch) * dk;
    const float* src = z + ((size_t)(key / rtiles) * m + j0) * d + k0;
    float* s = ring + (q % RW_NST) * stage;
    if (BULK) {
      if (t == 0) {
        const uint32_t bytes = 4u * min(RW_T, m - j0) * d;
        uint64_t* bar = bars + q % RW_NST;
        mbar_expect_tx(bar, bytes);
        bulk_copy_once(s, src, bytes, bar);
      }
    } else {
      const int w = min(dk, d - k0);
      copy_rows<V, RW_T, RW_T>(s, ld, src, d, m - j0, w, w);
    }
  };
  if (BULK && t == 0) {
    for (int i = 0; i < RW_NST; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  for (int q = 0; q < RW_NST - 1; ++q) {
    if (q < nitem) issue(q);
    if (!BULK) cp_async_commit();
  }

  float cross[RW_ROWS], xn[RW_ROWS], zz = 0.f;
#pragma unroll
  for (int r = 0; r < RW_ROWS; ++r) cross[r] = xn[r] = 0.f;
  long long cur = -1;
  bool first = false;
  for (int q = 0; q < nitem; ++q) {
    const long long u = u0 + q / nch;
    const long long key = u / ntile;
    const int kc = q % nch;
    if (kc == 0 && key != cur) {
      // a new (slot, row tile): its x rows, feature-major, with their norms
      // summed in this z tile's loop
      __syncthreads();                         // the old rows are read
      const int i0 = (int)(key % rtiles) * RW_ROWS;
      const float* xb = x + ((size_t)(key / rtiles) * n + i0) * d;
      const int nv = min(RW_ROWS, n - i0) * d;
      for (int e = t; e < RW_ROWS * d; e += RW_T) {
        const int r = e / d;
        xs[(e - r * d) * RW_ROWS + r] = e < nv ? xb[e] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RW_ROWS; ++r) xn[r] = 0.f;
      cur = key;
      first = true;
    }
    if (BULK) mbar_wait(bars + q % RW_NST, (q / RW_NST) & 1);
    else cp_async_wait<RW_NST - 2>();
    __syncthreads();   // item q is in; item q - 1's stage is consumed
    if (q + RW_NST - 1 < nitem) issue(q + RW_NST - 1);
    if (!BULK) cp_async_commit();
    const int k0 = kc * dk, w = min(dk, d - k0);
    const float* zr = ring + (q % RW_NST) * stage + t * ld;
    if (first) rw_fma<V, true>(xs + k0 * RW_ROWS, zr, w, cross, zz, xn);
    else rw_fma<V, false>(xs + k0 * RW_ROWS, zr, w, cross, zz, xn);
    if (kc == nch - 1) {
      const int j = (int)(u - key * ntile) * RW_T + t;
      const int i0 = (int)(key % rtiles) * RW_ROWS;
      if (j < m) {
        float* o = out + ((size_t)(key / rtiles) * n + i0) * m + j;
#pragma unroll
        for (int r = 0; r < RW_ROWS; ++r)
          if (i0 + r < n)
            __stcs(o + (size_t)r * m, fmaxf(xn[r] + zz - 2.f * cross[r], 0.f));
      }
      zz = 0.f;
#pragma unroll
      for (int r = 0; r < RW_ROWS; ++r) cross[r] = 0.f;
      first = false;
    }
  }
}

// dynamic shared memory beyond 48 KB, and the largest carveout, so that
// the blocks the plan counts on fit an SM
template <typename K>
cudaError_t set_smem(K kern, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// as many blocks as the card holds at once (at most `work`)
template <typename K>
cudaError_t resident(K kern, int threads, int smem, long long work,
                     long long* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                         smem)) != cudaSuccess)
    return e;
  const long long r = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *blocks = work < r ? work : r;
  return cudaSuccess;
}

template <int EPI, bool SYM, int V, bool BULK>
int launch_tile_v(const float* x, const float* z, float* out, int B, int n,
                  int m, int d, int dk, int ld, int smem, float denom,
                  cudaStream_t stream) {
  auto kern = d2_tile_kernel<EPI, SYM, V, BULK>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const long long ti = (n + TL - 1) / TL, tj = ((SYM ? n : m) + TL - 1) / TL;
  const long long tiles = B * (SYM ? ti * (ti + 1) / 2 : ti * tj);
  long long blocks = 0;
  if ((e = resident(kern, TL_T, smem, tiles, &blocks)) != cudaSuccess) return (int)e;
  const bool vec = (SYM ? n : m) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  kern<<<(unsigned)blocks, TL_T, smem, stream>>>(x, z, out, n, m, d, dk, ld,
                                                 (int)tiles, denom, vec);
  return (int)cudaGetLastError();
}

template <int EPI, bool SYM>
int launch_tile(const float* x, const float* z, float* out, int B, int n,
                int m, int d, int v, int bulk, int dk, int ld, int smem,
                float denom, cudaStream_t stream) {
  if (bulk)
    return launch_tile_v<EPI, SYM, 1, true>(x, z, out, B, n, m, d, dk, ld,
                                            smem, denom, stream);
  if (v == 2)
    return launch_tile_v<EPI, SYM, 2, false>(x, z, out, B, n, m, d, dk, ld,
                                             smem, denom, stream);
  return launch_tile_v<EPI, SYM, 1, false>(x, z, out, B, n, m, d, dk, ld,
                                           smem, denom, stream);
}

template <int V, bool BULK>
int launch_rows(const float* x, const float* z, float* out, int B, int n,
                int m, int d, int dk, int ld, int stage, int smem,
                cudaStream_t stream) {
  auto kern = d2_rows_kernel<V, BULK>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const long long items = (long long)B * ((n + RW_ROWS - 1) / RW_ROWS) *
                          ((m + RW_T - 1) / RW_T);
  long long res = 0;
  if ((e = resident(kern, RW_T, smem, items, &res)) != cudaSuccess) return (int)e;
  const long long ipb = (items + res - 1) / res;
  const long long blocks = (items + ipb - 1) / ipb;
  kern<<<(unsigned)blocks, RW_T, smem, stream>>>(x, z, out, n, m, d, dk, ld,
                                                 stage, items, (int)ipb);
  return (int)cudaGetLastError();
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

// x (B, n, d), z (B, m, d), out (B, n, m); all fp32, contiguous; n, m >= 1.
// The wrapper (kernels/kernel_matrix/ops.py, sq_dists_plan) passes the
// plan: rows != 0 streams z past 8 x rows a block, else the 128 x 128
// register tile.  v: the copy width in floats (v | d, the copied tables
// v*4-byte aligned); bulk != 0: each tile's rows as contiguous spans by the
// TMA unit (one chunk, ld == d, the spans 16-byte aligned); dk the feature
// chunk, ld the shared row stride, smem the dynamic shared memory bytes.
// Limit checked by the wrapper: the tile count below 2^31.
int sq_dists_f32(const float* x, const float* z, float* out, int B, int n,
                 int m, int d, int rows, int v, int bulk, int dk, int ld,
                 int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!rows)
    return launch_tile<0, false>(x, z, out, B, n, m, d, v, bulk, dk, ld,
                                 smem, 0.f, s);
  const int stage = (RW_T * ld + 3) / 4 * 4;
#define RW_GO(V, BULK) \
  launch_rows<V, BULK>(x, z, out, B, n, m, d, dk, ld, stage, smem, s)
  if (bulk) {
    if (v == 4) return RW_GO(4, true);
    if (v == 2) return RW_GO(2, true);
    return RW_GO(1, true);
  }
  if (v == 4) return RW_GO(4, false);
  if (v == 2) return RW_GO(2, false);
  return RW_GO(1, false);
#undef RW_GO
}

// x (n, d), z (m, d), out (n, m); fp32 contiguous.  kind: 0 Gaussian RBF,
// 1 Laplacian.  v, bulk, dk, ld, smem: sq_dists_f32's tile plan.
int gram_f32(const float* x, const float* z, float* out, int n, int m, int d,
             float gamma, int kind, int v, int bulk, int dk, int ld, int smem,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    return launch_tile<1, false>(x, z, out, 1, n, m, d, v, bulk, dk, ld, smem,
                                 fmaxf(gamma * gamma, 1e-12f), s);
  return launch_tile<2, false>(x, z, out, 1, n, m, d, v, bulk, dk, ld, smem,
                               fmaxf(gamma, 1e-12f), s);
}

// x (B, n, d) fp32 contiguous, out (B, n, n): the D2 of x with itself.
// v, bulk, dk, ld, smem: sq_dists_f32's tile plan.  Limit checked by the
// wrapper: the upper tile pairs below 2^31.
int sq_dists_sym_f32(const float* x, float* out, int B, int n, int d, int v,
                     int bulk, int dk, int ld, int smem, void* stream) {
  return launch_tile<0, true>(x, x, out, B, n, n, d, v, bulk, dk, ld, smem,
                              0.f, static_cast<cudaStream_t>(stream));
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
