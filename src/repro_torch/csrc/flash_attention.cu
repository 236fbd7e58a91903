// Flash attention forward (B9) for Hopper.
//
// flash_attention_fwd replaces flash_attention_pallas (body _flash_kernel)
// in src/repro/kernels/flash_attention/flash_attention.py: online-softmax
// attention, causal / sliding-window / bidirectional, q rows offset by
// S - T so the last query row attends to the last kv row, f32 softmax and
// accumulation, output in q's type.  Two kernels, chosen by the type:
//
// bf16 (flash_fwd_tc_kernel): the LM path's kernel, on the tensor cores.
//   Bound on the H100: at the LM path's prefill shapes (T = S = 256,
//   head_dim 64) each q, k, v element is used by ~T/2 pairs, ~64
//   operations per byte, below the bf16 tensor-core ridge (~295 per
//   byte): the floor is the q, k, v, o traffic.  At T = S = 4096 it is
//   ~1000 operations per byte: the tensor cores' rate.
//   Design:
//   * One warpgroup (128 threads) owns (batch, query head, 64 query rows)
//     and loops over kv tiles of BK rows; blocks share nothing, no
//     atomics.  The grid runs the heads fastest: blocks that run together
//     read the same kv rows of neighbouring heads (adjacent in the (B, S,
//     Hk, D) layout; at B = 1 this ran markedly faster than q tiles
//     first); the q tiles go last-first, so the blocks with the most kv
//     tiles start first.
//   * S = Q K^T is wgmma m64nBKk16 (bf16 x bf16 -> f32) with both operands
//     in shared memory: Q stays resident for the whole kv loop, K tiles
//     come from a ring.  O += P V is a second wgmma, m64nDk16, with A = P
//     from registers and B = V from shared memory read MN-major (no
//     transpose in memory).  O is accumulated in f32 registers.
//   * P is rounded to bf16 in registers before P V, as the TPU kernel's
//     jax.lax.dot(p, v) does on the MXU at jax's default precision (one
//     bf16 pass): at most 2^-8 relative per p (bf16's unit roundoff); l sums
//     the f32 p.
//   * Online softmax in f32 on the accumulator fragment's own layout: a
//     thread holds two rows, each row's max and sum are xor-shuffles over
//     the 4 threads that share it.  Logits are scaled into the log2
//     domain and exponentiated by ex2.approx (one special-function op
//     where expf takes ~10 instructions): the softmax, not the tensor
//     cores, sets this kernel's pace.  A tile that every row of the block
//     sees whole is not masked.  The reference's constants: masked logits
//     -1e30, l clamped at 1e-30, IEEE division by l; a row that has seen
//     no visible column yet keeps p = 0.
//   * q, k, v reach shared memory by TMA (cp.async.bulk.tensor.3d, tensor
//     maps built per call through cudaGetDriverEntryPoint, so nothing
//     links libcuda) in panels as wide as the widest swizzle span that
//     divides D, with the swizzle the wgmma descriptors name: 64 columns
//     and 128-byte swizzle at D = 64, 128, 256; 32 columns and 64-byte
//     swizzle at D = 160 (5 panels); 16 columns and 32-byte swizzle at
//     D = 16 and 80 (1 and 5 panels).  A box never reaches past its head's
//     last column into the next head's.  The maps view q as (B, T, H * D) and k, v as (B, S,
//     Hk * D) with a box of (1, rows, 64): the public layouts are read in
//     place, query head h reads kv head h / (H / Hk), and rows past T or
//     S are zero-filled by TMA (S is a dimension of its own, so batch b's
//     tail is never batch b + 1's head).  K and V share a ring of 2
//     stages with one mbarrier each; the tile two ahead is loaded while
//     this one is computed, and several blocks share an SM.
//   * Tiles wholly hidden by the causal or window mask are never loaded.
//   * The output goes through shared memory (the Q region, 16-byte chunks
//     XOR-swizzled by row) and is stored in 16-byte rows; rows past T are
//     never stored.
//   Per head_dim (nvcc -Xptxas -v: no spills at D <= 128 and 256): BK 64 at
//   D <= 160 (shared 8 / 16 KB of Q + 2 x 2 x 8 / 16 KB, 92 / 129 registers
//   at D 64 / 128: 5 / 2 blocks an SM; D = 16: 68 registers; D = 160: 20 +
//   80 KB, O 80 registers a thread, 2 blocks an SM) and BK 32 at D = 256
//   (32 + 2 x 2 x 16 KB = 96 KB, 170 registers, 2 blocks an SM; O alone is
//   128 f32 registers a thread).  bf16 at D = 8 (below the 16-wide K step
//   of a bf16 wgmma) runs the CUDA-core kernel below in bf16.  Tried and slower on the card (PERF.md):
//   BK 32 or 3 stages at D = 64, 2 warpgroups sharing the ring, and
//   issuing the next tile's S before this tile's softmax.
//
// f32 (flash_fwd_kernel): the f32 configurations' kernel, fp32 FMAs on the
//   CUDA cores, where the products must not round to bf16 or TF32; also
//   bf16 at D = 8 (loaded to f32, P kept in f32, the output rounded once).
//   Bound on the H100: 4 D operations a visible (row, column) pair at 67
//   TFLOP/s of fp32 FMA (hubert-xlarge's 4 x 1024 x 16 heads at D 80,
//   bidirectional: 0.321 ms) where q, k, v and o take 0.02 ms to move.
//   What holds it below that, as measured on the card (PERF.md):
//   operands reach the FMAs from shared memory at 128 bytes a cycle an SM,
//   so a warp's 16-byte load costs 4 of those cycles where the SM retires
//   4 warp FMAs a cycle, and the online softmax is a chain of shuffles and
//   exps.  The design:
//   * One block of 256 threads owns (batch, query head, 64 query rows)
//     and walks a run of kv tiles of BK rows, keeping the rows' offset m,
//     sum and output in registers.  In S = Q K^T a thread holds rows ty +
//     16 i (i < 4) and keys tx + 16 j (j < BK / 16).
//   * P V: a thread's columns are runs 4 tx + 64 jj of its four rows (one
//     float4 of V feeds 16 FMAs) and the D % 64 columns past them one at a
//     time, 64 NJ + tx + 16 e of its four rows (one float feeds 4 FMAs);
//     P comes as float4s of 4 keys of a row.  Runs of 4 of those columns
//     for one row a thread (4 floats of V and one of P for 4 FMAs) ran 16 %
//     slower at D 80 and 12 % at D 160.
//   * K and V reach shared memory by 16-byte cp.async (async_copy.cuh)
//     through a ring of NP = 2 stages of a K and a V tile: tile j + 1's
//     copies are in flight while tile j is computed.  One barrier a tile
//     publishes the landed stage and frees the one the next copies
//     overwrite; between a row's P and its use in P V only a __syncwarp,
//     since the 16 threads that write a row of P are the ones that read
//     it.  Rows past S are zero-filled by the copy and masked; rows past T
//     are neither read nor stored; tiles wholly hidden by the mask are never
//     loaded; a tile every row of the block sees whole is not masked.  bf16
//     (D 8) is loaded and widened by the threads into the same ring.
//   * The softmax moves a row's offset m only when one of its scores
//     passes m + RESCALE_AT (8), found by each thread on its own scores
//     and one warp vote: then the warp takes its rows' true max (shuffles
//     over a row's 16 threads) and rescales; else p = exp(s - m) <= e^8 with
//     no shuffle, no exp of the rescale and no multiply of the output.  A
//     thread sums its own p; the row's 16 partial sums meet once, at the
//     end.  The result differs from a max taken at every tile by rounding.
//   * Shared memory: q (64 x (D + 4)), the ring (2 x 2 x BK x (D + 4)) and
//     P (64 x (BK + 4)), f32, rows padded by 4 floats so the float4 reads
//     of k rows are free of bank conflicts.  Per head dim: BK, bytes,
//     blocks an SM (the occupancy calculator on the card), registers and
//     spills (nvcc -Xptxas -v, sm_90a): 8: 64, 32 KB, 2, 126, none (bf16:
//     99, none); 16: 64, 42 KB, 2, 128, none; 64: 64, 102 KB, 2, 128,
//     none; 80: 48 (a 64-row stage pair would leave one block an SM), 97
//     KB, 2, 128, 8 bytes; 128: 32, 108 KB, 2, 128, none; 160: 32, 132
//     KB, 1, 168, none; 256: 32, 204 KB, 1, 205, none.  __launch_bounds__
//     holds D <= 128 to 128 registers (two blocks).
//   * A split over the keys when a row's blocks would leave SMs idle (the
//     wrapper's split_count, from T, S, H, D, the mask, the window and the
//     SM count, never B, so a row's bits do not depend on what shares its
//     launch): split sp of nsplit takes a run of ceil(n / nsplit) of the
//     block's n visible kv tiles (the splits past the last run return),
//     writes its unnormalised output, offset and sum to a workspace, and a
//     per-(batch, q tile, head) ticket (atomicAdd) picks the block that
//     arrives last; it merges the partials in split order, so the output
//     is the same bits in every run, and resets its ticket to 0.  One
//     launch either way.
//   The reference's constants: masked logits -1e30, l clamped at 1e-30, a
//   row that has seen no visible column keeps p = 0 (so a row that sees
//   none gives 0); expf and IEEE division, no fast math.
//   Tried on the card and slower or no faster (PERF.md): synchronous
//   loads (the earlier kernel); a ring of single K or V tiles with two
//   barriers a tile; 8 rows a thread at 128 threads (fewer floats a FMA in
//   P V, but half the warps for the softmax's latency); BK 64 at D 128 (one
//   block an SM); the row max and sum by shuffles at every tile.  Untried:
//   3xTF32 on the tensor cores.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float SEEN = -1e20f;  // a running max above this came from a visible logit
constexpr float RESCALE_AT = 8.f;  // f32 kernel: a score this far above a row's m moves m
constexpr int BQ = 64;        // query rows per block
constexpr int PAD = 4;        // row padding of its shared tiles, floats
constexpr int THREADS = 256;  // the f32 kernel: 16 x 16 threads
constexpr int RM = 4;         // its query rows a thread
constexpr int SPLIT_MAX = 32; // its splits over the keys (the wrapper's cap)

// the f32 kernel's tiling per head dim (the header's table)
template <int D>
struct CcCfg {
  static_assert(D % 8 == 0 && D <= 256, "head_dim must be a multiple of 8");
  static constexpr int BK = D >= 128 ? 32 : D == 80 ? 48 : 64;   // kv rows a tile
  static constexpr int NP = 2;                      // ring stages of a K and a V tile
  static constexpr int LD = D + PAD;               // shared row of q, k, v
  static constexpr int LP = BK + PAD;              // shared row of P
  static constexpr int KN = BK / 16;               // keys a thread holds in S
  static constexpr int NJ = D / 64;                // its runs of 4 columns
  static constexpr int EC = (D % 64 + 15) / 16;    // its columns past them
  static constexpr int MIN_BLOCKS = D >= 160 ? 1 : 2;   // as shared memory allows
  static constexpr int SMEM = 4 * (BQ * LD + 2 * NP * BK * LD + BQ * LP);
  static constexpr int PART = BQ * D + 2 * BQ;     // floats of a split's partial
};

// ROWS rows [row0, row0 + ROWS) of one head into a (ROWS, D + PAD) f32
// tile, rows at or past n zero-filled: f32 by 16-byte cp.async (in flight
// until the caller waits), bf16 loaded and widened here
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(const float* __restrict__ base, int row0, int n,
                                          size_t stride, float* tile) {
  constexpr int PER_ROW = D / 4;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 4;
    const bool ok = row0 + r < n;
    const float* src = ok ? base + (size_t)(row0 + r) * stride + c : base;
    async_copy::cp_async<16>(tile + r * (D + PAD) + c, src, ok);
  }
}

template <int ROWS, int D>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ base, int row0,
                                          int n, size_t stride, float* tile) {
  constexpr int PER_ROW = D / 8;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    float* dst = tile + r * (D + PAD) + c;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) u = __ldg(reinterpret_cast<const uint4*>(base + (size_t)(row0 + r) * stride + c));
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float2 f0 = __bfloat1622float2(h2[0]), f1 = __bfloat1622float2(h2[1]);
    const float2 f2 = __bfloat1622float2(h2[2]), f3 = __bfloat1622float2(h2[3]);
    reinterpret_cast<float4*>(dst)[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
    reinterpret_cast<float4*>(dst)[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
  }
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& a, int c) {
  return c == 0 ? a.x : c == 1 ? a.y : c == 2 ? a.z : a.w;
}

__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* v) {
#pragma unroll
  for (int e = 0; e < 4; ++e) dst[e] = __float2bfloat16_rn(v[e]);
}

__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* dst, float v) { *dst = __float2bfloat16_rn(v); }

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, CcCfg<D>::MIN_BLOCKS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ ws, int* __restrict__ cnt, int Tq,
                 int S, int H, int Hk, int mask_kind, int window, float scale, int nsplit) {
  using C = CcCfg<D>;
  constexpr int BK = C::BK, NP = C::NP, LD = C::LD, LP = C::LP, KN = C::KN, NJ = C::NJ,
                EC = C::EC;
  extern __shared__ __align__(16) float smem[];
  __shared__ int last;
  float* qs = smem;                // BQ x LD
  float* ring = qs + BQ * LD;          // NP x (K, V) x BK x LD
  float* ps = ring + 2 * NP * BK * LD; // BQ x LP probabilities

  // blocks: heads fastest, then the splits; the q tiles last-first, so the
  // blocks with the most kv tiles start first
  const int nqt = gridDim.y, qt = nqt - 1 - blockIdx.y;
  const int h = blockIdx.x % H, sp = blockIdx.x / H, b = blockIdx.z, q0 = qt * BQ;
  const int hk = h / (H / Hk);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int off = S - Tq;  // real row coordinate of query t is t + off

  // the kv tiles some row of this block can see, and this split's run
  int lo = 0, hi = S - 1;
  if (mask_kind != 2) {
    hi = min(hi, min(q0 + BQ, Tq) - 1 + off);
    if (mask_kind == 1) lo = max(0, q0 + off - window + 1);
  }
  const int n_tiles = hi >= lo ? hi / BK - lo / BK + 1 : 0;
  const int chunk = max(1, (n_tiles + nsplit - 1) / nsplit);
  const int nsp = max(1, (n_tiles + chunk - 1) / chunk);
  if (sp >= nsp) return;
  const int t_begin = lo / BK + sp * chunk;
  const int n_run = max(0, min(n_tiles - sp * chunk, chunk));

  const T* qb = q + ((size_t)b * Tq * H + h) * D;
  const T* kb = k + ((size_t)b * S * Hk + hk) * D;
  const T* vb = v + ((size_t)b * S * Hk + hk) * D;
  // tile j of the run: its K and V into stage j % NP, one copy group
  auto issue = [&](int j) {
    float* st = ring + (j % NP) * 2 * BK * LD;
    load_tile<BK, D>(kb, (t_begin + j) * BK, S, (size_t)Hk * D, st);
    load_tile<BK, D>(vb, (t_begin + j) * BK, S, (size_t)Hk * D, st + BK * LD);
  };
  load_tile<BQ, D>(qb, q0, Tq, (size_t)H * D, qs);
#pragma unroll
  for (int j = 0; j < NP - 1; ++j) {
    if (j < n_run) issue(j);
    async_copy::cp_async_commit();
  }

  // a thread's rows ty + 16 i; its columns 4 tx + 64 jj (+ 0..3) and
  // 64 NJ + tx + 16 e (those below D)
  float m_i[RM], l_i[RM], acc[RM][NJ > 0 ? NJ : 1][4], ext[RM][EC > 0 ? EC : 1];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jj][e] = 0.f;
#pragma unroll
    for (int e = 0; e < EC; ++e) ext[i][e] = 0.f;
  }

  for (int jt = 0; jt < n_run; ++jt) {
    async_copy::cp_async_wait<NP - 2>();
    // tile jt's K and V landed for every thread; stage (jt - 1) % NP is free
    __syncthreads();
    if (jt + NP - 1 < n_run) issue(jt + NP - 1);
    async_copy::cp_async_commit();
    const float* tile = ring + (jt % NP) * 2 * BK * LD;   // K, then V
    const int c0 = (t_begin + jt) * BK;
    {
      // S = Q K^T for rows ty + 16 i, keys tx + 16 j
      float s[RM][KN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < KN; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 qv[RM], kv[KN];
#pragma unroll
        for (int i = 0; i < RM; ++i) qv[i] = lds4(qs + (ty + 16 * i) * LD + d);
#pragma unroll
        for (int j = 0; j < KN; ++j) kv[j] = lds4(tile + (tx + 16 * j) * LD + d);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < KN; ++j) {
            float a = s[i][j];
            a = fmaf(qv[i].x, kv[j].x, a);
            a = fmaf(qv[i].y, kv[j].y, a);
            a = fmaf(qv[i].z, kv[j].z, a);
            a = fmaf(qv[i].w, kv[j].w, a);
            s[i][j] = a;
          }
      }
      // online softmax; a tile that every row of the block sees whole is
      // not masked.  The rows' offsets m move only when a score passes m +
      // RESCALE_AT (or m is still unset): then the warp's rows take their
      // true max (shuffles over the row's 16 threads) and rescale l and
      // the output; else p = exp(s - m) <= e^RESCALE_AT with no shuffle.
      // The result differs from a max taken every tile by rounding only.
      const bool whole =
          c0 + BK <= S &&
          (mask_kind == 2 ||
           (c0 + BK - 1 <= q0 + off &&
            (mask_kind == 0 || min(q0 + BQ, Tq) - 1 + off - c0 < window)));
      float mx[RM];
      bool grow = false;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int row = q0 + ty + 16 * i + off;
        mx[i] = NEG_INF;
#pragma unroll
        for (int j = 0; j < KN; ++j) {
          const int col = c0 + tx + 16 * j;
          const bool vis = whole || (col < S && (mask_kind == 2 ||
                                                 (row >= col && (mask_kind == 0 ||
                                                                 row - col < window))));
          s[i][j] = vis ? s[i][j] * scale : NEG_INF;
          mx[i] = fmaxf(mx[i], s[i][j]);
        }
        grow |= mx[i] > m_i[i] + RESCALE_AT;
      }
      if (__any_sync(0xffffffffu, grow)) {
#pragma unroll
        for (int i = 0; i < RM; ++i) {
#pragma unroll
          for (int w = 8; w > 0; w >>= 1)
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], w));
          const float m_new = fmaxf(m_i[i], mx[i]);
          const float alpha = expf(m_i[i] - m_new);
          m_i[i] = m_new;
          l_i[i] *= alpha;
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][jj][e] *= alpha;
#pragma unroll
          for (int e = 0; e < EC; ++e) ext[i][e] *= alpha;
        }
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const bool seen = m_i[i] > SEEN;
#pragma unroll
        for (int j = 0; j < KN; ++j) {
          const float p = seen ? expf(s[i][j] - m_i[i]) : 0.f;
          ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
          l_i[i] += p;   // this thread's keys; the row's sum at the end
        }
      }
    }
    // the rows of P a thread reads are its half-warp's own
    __syncwarp();
    {
      // O += P V over the tile's keys, 4 at a time
      const float* vt = tile + BK * LD;
#pragma unroll 2
      for (int c = 0; c < BK; c += 4) {
        float4 pv[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i) pv[i] = lds4(ps + (ty + 16 * i) * LP + c);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float* vr = vt + (c + cc) * LD;
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) {
            const float4 vv = lds4(vr + 4 * tx + 64 * jj);
#pragma unroll
            for (int i = 0; i < RM; ++i) {
              const float p = comp(pv[i], cc);
              acc[i][jj][0] = fmaf(p, vv.x, acc[i][jj][0]);
              acc[i][jj][1] = fmaf(p, vv.y, acc[i][jj][1]);
              acc[i][jj][2] = fmaf(p, vv.z, acc[i][jj][2]);
              acc[i][jj][3] = fmaf(p, vv.w, acc[i][jj][3]);
            }
          }
#pragma unroll
          for (int e = 0; e < EC; ++e) {
            // D 8: columns 0..7, the threads tx >= 8 read column tx - 8 and drop it
            const float ve = vr[NJ * 64 + (D % 64 < 16 ? (tx & 7) : tx + 16 * e)];
#pragma unroll
            for (int i = 0; i < RM; ++i) ext[i][e] = fmaf(comp(pv[i], cc), ve, ext[i][e]);
          }
        }
      }
    }
  }
  async_copy::cp_async_wait_all();
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int w = 8; w > 0; w >>= 1) l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], w);

  const bool ext_ok = D % 64 >= 16 || tx < 8;   // D 8: the threads of columns 0..7
  if (nsp == 1) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int t = q0 + ty + 16 * i;
      if (t >= Tq) continue;
      const float l = fmaxf(l_i[i], 1e-30f);
      T* orow = o + (((size_t)b * Tq + t) * H + h) * D;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        float out[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) out[e] = acc[i][jj][e] / l;
        store4(orow + 4 * tx + 64 * jj, out);
      }
#pragma unroll
      for (int e = 0; e < EC; ++e)
        if (ext_ok) store1(orow + NJ * 64 + tx + 16 * e, ext[i][e] / l);
    }
    return;
  }

  // split over keys: this split's partial (output rows, then the rows' max
  // and sum) into the workspace of (batch, q tile, head)
  const size_t pair = ((size_t)b * nqt + qt) * H + h;
  float* wb = ws + pair * nsplit * C::PART;
  float* wp = wb + (size_t)sp * C::PART;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) store4(wp + r * D + 4 * tx + 64 * jj, acc[i][jj]);
#pragma unroll
    for (int e = 0; e < EC; ++e)
      if (ext_ok) wp[r * D + NJ * 64 + tx + 16 * e] = ext[i][e];
    if (tx == 0) {
      wp[BQ * D + r] = m_i[i];
      wp[BQ * D + BQ + r] = l_i[i];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(cnt + pair, 1) == nsp - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: each split's weight a row, then the outputs, summed in
  // split order
  float* wgt = ps;     // BQ x nsp
  float* lsum = ring;  // BQ
  if (tid < BQ) {
    float mx = NEG_INF;
    for (int j = 0; j < nsp; ++j) mx = fmaxf(mx, __ldcg(wb + (size_t)j * C::PART + BQ * D + tid));
    float l = 0.f;
    for (int j = 0; j < nsp; ++j) {
      const float* pj = wb + (size_t)j * C::PART + BQ * D;
      const float w = mx > SEEN ? expf(__ldcg(pj + tid) - mx) : 0.f;
      wgt[tid * nsp + j] = w;
      l = fmaf(__ldcg(pj + BQ + tid), w, l);
    }
    lsum[tid] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  for (int i = tid; i < BQ * (D / 4); i += THREADS) {
    const int r = i / (D / 4), c = i % (D / 4) * 4, t = q0 + r;
    if (t >= Tq) continue;
    float out[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < nsp; ++j) {
      const float w = wgt[r * nsp + j];
      const float4 a = __ldcg(reinterpret_cast<const float4*>(wb + (size_t)j * C::PART + r * D + c));
      out[0] = fmaf(a.x, w, out[0]);
      out[1] = fmaf(a.y, w, out[1]);
      out[2] = fmaf(a.z, w, out[2]);
      out[3] = fmaf(a.w, w, out[3]);
    }
    const float l = lsum[r];
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] /= l;
    store4(o + (((size_t)b * Tq + t) * H + h) * D + c, out);
  }
  if (tid == 0) cnt[pair] = 0;
}

// The shared-memory opt-in holds for the current device: set it once for
// each device a launch function meets (bit d of *done), not at every call.
template <typename K>
cudaError_t smem_opt_in(K kernel, int bytes, unsigned long long* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && ((*done >> dev) & 1ull))) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < 64) *done |= 1ull << dev;
  return e;
}

// the f32 kernel's opt-in: its shared memory, and the largest carveout, so
// that MIN_BLOCKS blocks share an SM
template <typename T, int D>
cudaError_t cc_opt_in() {
  static unsigned long long opted_in = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && ((opted_in >> dev) & 1ull))) return e;
  e = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, CcCfg<D>::SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && dev < 64) opted_in |= 1ull << dev;
  return e;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* ws, int* cnt,
                   int B, int Tq, int S, int H, int Hk, int mask_kind, int window, float scale,
                   int nsplit, cudaStream_t stream) {
  using C = CcCfg<D>;
  static_assert(SPLIT_MAX <= C::LP, "the merge's weights fit where P was");
  if (nsplit < 1 || nsplit > SPLIT_MAX || (nsplit > 1 && (ws == nullptr || cnt == nullptr)))
    return cudaErrorInvalidValue;
  const cudaError_t e = cc_opt_in<T, D>();
  if (e != cudaSuccess) return e;
  const dim3 grid(H * nsplit, (Tq + BQ - 1) / BQ, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), ws, cnt, Tq, S, H, Hk, mask_kind, window, scale, nsplit);
  return cudaGetLastError();
}

#define CC_ARGS q, k, v, o, ws, cnt, B, Tq, S, H, Hk, mask_kind, window, scale, nsplit, st
template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, void* o, float* ws,
                       int* cnt, int B, int Tq, int S, int H, int Hk, int mask_kind, int window,
                       float scale, int nsplit, cudaStream_t st) {
  switch (D) {
    case 8: return launch<T, 8>(CC_ARGS);
    case 16: return launch<T, 16>(CC_ARGS);
    case 64: return launch<T, 64>(CC_ARGS);
    case 80: return launch<T, 80>(CC_ARGS);
    case 128: return launch<T, 128>(CC_ARGS);
    case 160: return launch<T, 160>(CC_ARGS);
    case 256: return launch<T, 256>(CC_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int D>
int blocks_per_sm() {
  int n = 0;
  if (cc_opt_in<T, D>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_fwd_kernel<T, D>, THREADS,
                                                    CcCfg<D>::SMEM) != cudaSuccess)
    return -1;
  return n;
}


// ------------------------------------------------------------------ bf16
// the tensor-core kernel's tiling per head_dim
template <int D>
struct TcCfg {
  static_assert(D % 16 == 0 && D <= 256, "the wgmma kernel takes multiples of 16");
  static constexpr int BQ = 64;                    // query rows: one warpgroup
  static constexpr int BK = D == 256 ? 32 : 64;    // kv rows per tile
  // panel width (columns): the widest swizzle span that divides D, so a
  // head's panels end at its last column (80: 5 x 16, 160: 5 x 32)
  static constexpr int PW = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;
  static constexpr int ROWB = PW * 2;              // bytes of a panel row
  static constexpr int NS = 2;                     // ring stages
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;      // one K or one V tile
  // descriptor swizzle: 1 = 128 B, 2 = 64 B, 3 = 32 B (the panel row)
  static constexpr int LAYOUT = PW == 64 ? 1 : PW == 32 ? 2 : 3;
  static constexpr int SMEM = Q_BYTES + NS * 2 * KV_BYTES + 8 * (NS + 1) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// spins until the phase with the given parity has completed; a copy that
// never lands (a fault) traps after ~10 s instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  do {
    if (clock64() - t0 > 20000000000LL) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout (1: 128 B, 2: 64 B, 3: 32 B)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving register reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x N f32, N / 2 registers a thread) [+]= A (64 x 16) B (16 x N).
// ss: A and B K-major in shared memory (scale_d 0 overwrites D);
// rs: A from registers (the m16n8k16 A fragment of each warp's 16 rows),
// B MN-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n80(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n160(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 32) wgmma_ss_n32(d, da, db, scale_d);
  else wgmma_ss_n64(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  static_assert(N == 16 || N == 64 || N == 80 || N == 128 || N == 160 || N == 256,
                "no wgmma wrapper for this N");
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 80) wgmma_rs_n80(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else if constexpr (N == 160) wgmma_rs_n160(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// 2^x on the special-function unit (relative error ~2^-22, far below the
// bf16 rounding of P that follows)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int D>
__device__ __forceinline__ void issue_kv(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                         uint32_t kdst, uint32_t bar, int hk, int c0, int b) {
  using C = TcCfg<D>;
  mbar_expect_tx(bar, 2 * C::KV_BYTES);
#pragma unroll
  for (int p = 0; p < D / C::PW; ++p) {
    tma_load_3d(kdst + p * C::BK * C::ROWB, kmap, bar, hk * D + p * C::PW, c0, b);
    tma_load_3d(kdst + C::KV_BYTES + p * C::BK * C::ROWB, vmap, bar, hk * D + p * C::PW, c0, b);
  }
}

template <int D>
__global__ void __launch_bounds__(128, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                    int Tq, int S, int H, int Hk, int mask_kind, int window, float scale) {
  using C = TcCfg<D>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms are 1024-byte aligned
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t q_s = base;
  const uint32_t kv_s = base + C::Q_BYTES;  // stage s: K at + 2 s KV_BYTES, V after it
  const uint32_t bars = kv_s + C::NS * 2 * C::KV_BYTES;  // q, then one per stage

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;
  const int hk = h / (H / Hk);
  const int off = S - Tq;  // real row coordinate of query t is t + off

  // the kv columns some row of this block can see
  int lo = 0, hi = S - 1;
  if (mask_kind != 2) {
    hi = min(hi, min(q0 + C::BQ, Tq) - 1 + off);
    if (mask_kind == 1) lo = max(0, q0 + off - window + 1);
  }
  const int c_first = (lo / BK) * BK;
  const int n_tiles = hi >= c_first ? (hi - c_first) / BK + 1 : 0;

  if (tid == 0) {  // the first copies are in flight before the block syncs
#pragma unroll
    for (int i = 0; i <= C::NS; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bars, C::Q_BYTES);
#pragma unroll
    for (int p = 0; p < D / C::PW; ++p)
      tma_load_3d(q_s + p * C::BQ * C::ROWB, &qmap, bars, h * D + p * C::PW, q0, b);
    for (int j = 0; j < C::NS && j < n_tiles; ++j)
      issue_kv<D>(&kmap, &vmap, kv_s + j * 2 * C::KV_BYTES, bars + 8 * (j + 1), hk,
                  c_first + j * BK, b);
  }
  __syncthreads();  // the barriers are initialised

  // fragment coordinates: this thread's rows r_loc and r_loc + 8 of the
  // tile; value e of a 64 x N fragment sits in column 8 (e / 4) + cq + e % 2
  // of row r_loc + 8 ((e / 2) % 2)
  const int r_loc = warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  const int row0 = q0 + r_loc + off, row1 = row0 + 8;
  // the columns rows row0 and row1 see: [lo, hi]
  const int lo0 = mask_kind == 1 ? row0 - window + 1 : 0;
  const int lo1 = mask_kind == 1 ? row1 - window + 1 : 0;
  const int hi0 = mask_kind == 2 ? S - 1 : min(row0, S - 1);
  const int hi1 = mask_kind == 2 ? S - 1 : min(row1, S - 1);
  const int r_first = q0 + off, r_last = q0 + C::BQ - 1 + off;
  const float scale_log2 = scale * 1.4426950408889634f;  // e^(x s) = 2^(x s log2 e)
  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  mbar_wait(bars, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j % C::NS;
    const int c0 = c_first + j * BK;
    mbar_wait(bars + 8 * (stage + 1), (j / C::NS) & 1);
    const uint32_t ks = kv_s + stage * 2 * C::KV_BYTES, vs = ks + C::KV_BYTES;

    // S = Q K^T over D in steps of 16
    float s[BK / 2];
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) s[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk * 16 / C::PW, byte = (kk * 16 % C::PW) * 2;
      const uint64_t da = gmma_desc(q_s + p * C::BQ * C::ROWB + byte, 16, 8 * C::ROWB, C::LAYOUT);
      const uint64_t db = gmma_desc(ks + p * BK * C::ROWB + byte, 16, 8 * C::ROWB, C::LAYOUT);
      wgmma_ss<BK>(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // online softmax in the log2 domain: the row max over the raw logits
    // (masked ones -1e30), then p = 2^(s * scale log2 e - m) in one FFMA
    // and one ex2; a tile that every row of the block sees whole skips
    // the mask
    const bool whole = c0 + BK <= S && (mask_kind == 2 || (c0 + BK - 1 <= r_first &&
                                                          (mask_kind != 1 || r_last - c0 < window)));
    if (!whole) {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int col = c0 + 8 * (e / 4) + cq + (e & 1);
        const bool vis = (e & 2) ? (col >= lo1 && col <= hi1) : (col >= lo0 && col <= hi0);
        s[e] = vis ? s[e] : NEG_INF;
      }
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      if (e & 2) mx1 = fmaxf(mx1, s[e]);
      else mx0 = fmaxf(mx0, s[e]);
    }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
    const float a0 = exp2_approx(m0 - mn0), a1 = exp2_approx(m1 - mn1);
    // a row that has seen no visible logit yet keeps p = 0 (its max is the
    // masked value, which fmaf would not cancel exactly)
    const float nb0 = mn0 > SEEN ? -mn0 : 0.f, nb1 = mn1 > SEEN ? -mn1 : 0.f;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const float pe = exp2_approx(fmaf(s[e], scale_log2, (e & 2) ? nb1 : nb0));
      s[e] = pe;
      if (e & 2) rs1 += pe;
      else rs0 += pe;
    }
    uint32_t pa[BK / 4];  // P in bf16 as the A fragments of BK / 16 k-steps
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, w);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, w);
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] *= (e & 2) ? a1 : a0;

    // O += P V over the tile's kv rows in steps of 16
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = gmma_desc(vs + kk * 16 * C::ROWB, BK * C::ROWB, 8 * C::ROWB, C::LAYOUT);
      wgmma_rs<D>(acc, pa + 4 * kk, db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(pa);

    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && j + C::NS < n_tiles)
      issue_kv<D>(&kmap, &vmap, ks, bars + 8 * (stage + 1), hk, c0 + C::NS * BK, b);
  }

  // O / l through shared memory (the Q region): 16-byte chunk c of row r
  // at r * 2D + 16 (c ^ (r % CH)), then 16-byte rows to device memory; CH
  // is the largest power of two up to 8 dividing NCH, so c ^ (r % CH)
  // stays inside the row
  constexpr int NCH = D / 8;  // 16-byte chunks a row
  constexpr int CH = NCH % 8 == 0 ? 8 : NCH % 4 == 0 ? 4 : NCH % 2 == 0 ? 2 : 1;
  __syncthreads();
  const float il0 = fmaxf(l0, 1e-30f), il1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int e = 0; e < D / 2; e += 2) {
    const int r = r_loc + ((e & 2) ? 8 : 0);
    const float l = (e & 2) ? il1 : il0;
    const int c = e / 4;
    *reinterpret_cast<uint32_t*>(gbase + r * 2 * D + 16 * (c ^ (r % CH)) + 2 * cq) =
        pack_bf16(acc[e] / l, acc[e + 1] / l);
  }
  __syncthreads();
  for (int i = tid; i < C::BQ * NCH; i += 128) {
    const int r = i / NCH, c = i % NCH, t = q0 + r;
    if (t < Tq)
      *reinterpret_cast<uint4*>(o + (((size_t)b * Tq + t) * H + h) * D + 8 * c) =
          *reinterpret_cast<const uint4*>(gbase + r * 2 * D + 16 * (c ^ (r % CH)));
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a bf16 (B, rows, width) tensor, boxes of (1, box_rows, box_w)
bool make_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr, int B, int rows, int width,
              int box_w, int box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 2, (cuuint64_t)rows * width * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_w, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, int B, int Tq, int S,
                      int H, int Hk, int mask_kind, int window, float scale,
                      cudaStream_t stream) {
  using C = TcCfg<D>;
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const CUtensorMapSwizzle swz = C::PW == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : C::PW == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap qm, km, vm;
  if (!make_map(enc, &qm, q, B, Tq, H * D, C::PW, C::BQ, swz) ||
      !make_map(enc, &km, k, B, S, Hk * D, C::PW, C::BK, swz) ||
      !make_map(enc, &vm, v, B, S, Hk * D, C::PW, C::BK, swz))
    return cudaErrorInvalidValue;
  static unsigned long long opted_in = 0;
  const cudaError_t e = smem_opt_in(flash_fwd_tc_kernel<D>, C::SMEM, &opted_in);
  if (e != cudaSuccess) return e;
  const dim3 grid(H, (Tq + C::BQ - 1) / C::BQ, B);
  flash_fwd_tc_kernel<D><<<grid, 128, C::SMEM, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), Tq, S, H, Hk, mask_kind, window, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(int D, const void* q, const void* k, const void* v, void* o, int B,
                        int Tq, int S, int H, int Hk, int mask_kind, int window, float scale,
                        cudaStream_t st) {
  switch (D) {
    case 16: return launch_tc<16>(q, k, v, o, B, Tq, S, H, Hk, mask_kind, window, scale, st);
    case 64: return launch_tc<64>(q, k, v, o, B, Tq, S, H, Hk, mask_kind, window, scale, st);
    case 80: return launch_tc<80>(q, k, v, o, B, Tq, S, H, Hk, mask_kind, window, scale, st);
    case 128: return launch_tc<128>(q, k, v, o, B, Tq, S, H, Hk, mask_kind, window, scale, st);
    case 160: return launch_tc<160>(q, k, v, o, B, Tq, S, H, Hk, mask_kind, window, scale, st);
    case 256: return launch_tc<256>(q, k, v, o, B, Tq, S, H, Hk, mask_kind, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, T, H, D), k and v (B, S, Hk, D), o (B, T, H, D), all contiguous,
// 16-byte aligned and of one type (dtype 0: f32, 1: bf16); mask_kind 0
// causal, 1 window, 2 bidirectional.  f32, and bf16 at D = 8 (below the
// 16-wide K step of a bf16 wgmma), run the CUDA-core kernel with nsplit
// splits over the keys (1 to 32); nsplit > 1 needs ws (B ceil(T / 64) H
// nsplit (64 D + 128) floats, no initial value) and cnt (B ceil(T / 64) H
// ints, zero; left zero).  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* ws, void* cnt, int B, int Tq, int S, int H, int Hk,
                                   int D, int dtype, int mask_kind, int window, float scale,
                                   int nsplit, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hk <= 0 || H % Hk != 0) return (int)cudaErrorInvalidValue;
  float* w = static_cast<float*>(ws);
  int* c = static_cast<int*>(cnt);
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_d<float>(D, q, k, v, o, w, c, B, Tq, S, H, Hk, mask_kind, window, scale,
                          nsplit, st);
  else if (D == 8)
    e = launch<__nv_bfloat16, 8>(q, k, v, o, w, c, B, Tq, S, H, Hk, mask_kind, window, scale,
                                 nsplit, st);
  else if (nsplit != 1)
    e = cudaErrorInvalidValue;
  else
    e = dispatch_tc(D, q, k, v, o, B, Tq, S, H, Hk, mask_kind, window, scale, st);
  return (int)e;
}

// blocks of the CUDA-core kernel an SM holds at head dim D (dtype 0 f32, 1
// bf16), by the occupancy calculator; -1 for a head dim it has no instance of
extern "C" int flash_attention_cc_blocks_per_sm(int D, int dtype) {
  if (dtype != 0) return D == 8 ? blocks_per_sm<__nv_bfloat16, 8>() : -1;
  switch (D) {
    case 8: return blocks_per_sm<float, 8>();
    case 16: return blocks_per_sm<float, 16>();
    case 64: return blocks_per_sm<float, 64>();
    case 80: return blocks_per_sm<float, 80>();
    case 128: return blocks_per_sm<float, 128>();
    case 160: return blocks_per_sm<float, 160>();
    case 256: return blocks_per_sm<float, 256>();
    default: return -1;
  }
}
