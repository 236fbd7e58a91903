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
//   fp32 FMA rate (0.032 ms at 67 TFLOP/s); so is a HIGGS-width table
//   (5500 centers x d 28: 20 GFLOP, 0.30 ms).  No tensor cores, 3xTF32
//   included: they would change the bits of the cross term and so the
//   owners.
//   Arithmetic contract, which fixes every owner bit for bit:
//   each pair's cross term is one fp32 FMA chain from 0 over the features
//   in ascending order, each squared norm the same, d2 = (|x|^2 + |c|^2) -
//   2 x.c.  Zero features padded at the end leave a chain unchanged (it
//   never holds -0), so tiling and padding change no pair's value.  The
//   owner is the lexicographic minimum of (d2, index): a thread visits its
//   centers in ascending order and replaces its best only on a strict <,
//   merges take the lower index on equal d2, whatever their order.
//   Design:
//   * One 256-thread block computes a 256 x 64 tile of cross terms, 8 x 8
//     a thread: operand A row-major in shared memory (each thread reads
//     its 8 items two features at a time, 8-byte loads, row stride = 2
//     mod 4 words so the 4 items a warp reads lie in 4 bank pairs), B
//     feature-major (two 16-byte loads a feature give a thread its 8
//     items; 8 lanes read 128 contiguous bytes).  A feature pair costs 12
//     shared loads for 128 FMAs.  The feature loop runs over d rounded up
//     to 2 (54 for 54), not to a chunk of 32.
//   * Resident table (the wrapper's choice, assign_resident() in ops.py:
//     when table, norms and two row tiles fit in shared memory; Covertype's
//     291 x 54 does): A = rows, B = centers.  A persistent grid of one
//     block an SM loads the whole table once, feature-major, with |c|^2
//     beside it, and walks row tiles of 256; the next row tile is in
//     flight (cp.async, 8 bytes where d is even) while this one computes.
//     |x|^2 is summed in the first center tile's FMA loop.
//   * Streamed table (HIGGS width, 5500 x 28 = 616 KB): A = centers, B =
//     rows.  A block owns 64 rows and streams the table in tiles of 256
//     centers (and chunks of 32 features, for wide d) through a 3-stage
//     cp.async ring; |c|^2 is summed in each center tile's FMA loop, |x|^2
//     in the first.  The 32 threads that share a row merge through
//     shuffles and shared memory.
//   * Edges: rows past n and centers past C are zero-filled and never
//     win (masked) or stored; no sentinel center rows.
//   What bounds the 8 x 8 tile on this card: shared memory hands a warp
//   at most 32 floats a cycle, so a feature pair's 16 + 16 floats a thread
//   take as many cycles as its 128 FMAs issue, and the two pipes do not
//   overlap fully.  Tried and slower on the H100: 16 A items a thread (16
//   x 8 at 128 threads spilled; at 256 threads over 512-row tiles, one
//   feature a step, no faster), unrolling the resident feature loop, one
//   thread a center loading the table in a serial chain (in place of 16
//   independent loads a thread).  The compare epilogue and, at HIGGS
//   width, the inline |c|^2 each cost a few per cent.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int AS_THREADS = 256;  // 32 (ta) x 8 (tb) threads
constexpr int AS_A = 256;        // A items a tile: 4ta + i and 128 + 4ta + i
constexpr int AS_B = 64;         // B items a tile: 4tb + j and 32 + 4tb + j
constexpr int AS_KC = 32;        // streamed path: feature chunk
constexpr int AS_NST = 3;        // streamed path: ring stages
constexpr int AS_XST = 2;        // resident path: row-tile stages
constexpr int AS_LOADS = 16;     // resident path: table loads in flight

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               ::"r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async8(float* dst, const float* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;"
               ::"r"(d), "l"(src), "r"(valid ? 8 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// rows [0, nrows) x columns [0, w) of a row-major src (row stride lds) into
// dst (row stride ldd) in units of vw floats (1 or 2); rows >= rvalid and
// columns >= wvalid are zero-filled.  The thread's (row, column) advances
// without a division per copy.
__device__ __forceinline__ void copy_rows(float* dst, int ldd, const float* src,
                                          int lds, int nrows, int rvalid,
                                          int w, int wvalid, int vw) {
  const int upr = w / vw;
  const int drow = AS_THREADS / upr, dcol = (AS_THREADS - drow * upr) * vw;
  int r = threadIdx.x / upr, col = (threadIdx.x - r * upr) * vw;
  for (int u = threadIdx.x; u < nrows * upr; u += AS_THREADS) {
    const bool ok = r < rvalid && col < wvalid;
    const float* s = ok ? src + (size_t)r * lds + col : src;
    if (vw == 2) cp_async8(dst + r * ldd + col, s, ok);
    else cp_async4(dst + r * ldd + col, s, ok);
    r += drow;
    col += dcol;
    if (col >= w) { col -= w; ++r; }
  }
}

// the same window stored transposed, dst[col * ldd + r], AS_B rows, 4 bytes
// a copy with consecutive threads on consecutive rows (no bank conflicts)
__device__ __forceinline__ void copy_cols(float* dst, int ldd, const float* src,
                                          int lds, int rvalid, int w,
                                          int wvalid) {
  for (int u = threadIdx.x; u < AS_B * w; u += AS_THREADS) {
    const int col = u / AS_B, r = u % AS_B;
    const bool ok = r < rvalid && col < wvalid;
    cp_async4(dst + col * ldd + r, ok ? src + (size_t)r * lds + col : src, ok);
  }
}

__device__ __forceinline__ int a_item(int ta, int i) {
  return i < 4 ? 4 * ta + i : 128 + 4 * ta + i - 4;
}
__device__ __forceinline__ int b_item(int tb, int j) {
  return j < 4 ? 4 * tb + j : 32 + 4 * tb + j - 4;
}

// one feature pair (k, k + 1) of acc[i][j] += A[a_item(i)] * B[b_item(j)];
// NA / NB also sum the squared norms of the thread's A / B items
template <bool NA, bool NB>
__device__ __forceinline__ void fma_pair(const float* __restrict__ a, int lda,
                                         const float* __restrict__ b, int ldb,
                                         int k, float (&acc)[8][8],
                                         float (&na)[8], float (&nb)[8]) {
  float2 av[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    av[i] = *reinterpret_cast<const float2*>(a + i * lda + k);
    av[4 + i] = *reinterpret_cast<const float2*>(a + (128 + i) * lda + k);
  }
  const float4 p0 = *reinterpret_cast<const float4*>(b + k * ldb);
  const float4 p1 = *reinterpret_cast<const float4*>(b + k * ldb + 32);
  const float4 q0 = *reinterpret_cast<const float4*>(b + (k + 1) * ldb);
  const float4 q1 = *reinterpret_cast<const float4*>(b + (k + 1) * ldb + 32);
  const float b0[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
  const float b1[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i].x, b0[j], acc[i][j]);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i].y, b1[j], acc[i][j]);
  if (NA) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      na[i] = fmaf(av[i].x, av[i].x, na[i]);
      na[i] = fmaf(av[i].y, av[i].y, na[i]);
    }
  }
  if (NB) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      nb[j] = fmaf(b0[j], b0[j], nb[j]);
      nb[j] = fmaf(b1[j], b1[j], nb[j]);
    }
  }
}

// acc[i][j] += sum over features [0, nk) of A[a_item(i)] * B[b_item(j)], one
// ascending FMA chain a pair; nk is even.  The resident path runs the loop
// as written (UNROLL2 false: faster there), the streamed path unrolled by 2.
template <bool NA, bool NB, bool UNROLL2>
__device__ __forceinline__ void tile_fma(const float* __restrict__ A, int lda,
                                         const float* __restrict__ B, int ldb,
                                         int nk, int ta, int tb,
                                         float (&acc)[8][8], float (&na)[8],
                                         float (&nb)[8]) {
  const float* a = A + 4 * ta * lda;
  const float* b = B + 4 * tb;
  if constexpr (UNROLL2) {
#pragma unroll 2
    for (int k = 0; k < nk; k += 2)
      fma_pair<NA, NB>(a, lda, b, ldb, k, acc, na, nb);
  } else {
#pragma unroll 1
    for (int k = 0; k < nk; k += 2)
      fma_pair<NA, NB>(a, lda, b, ldb, k, acc, na, nb);
  }
}

__device__ __forceinline__ void lexmin(float& v, int& i, float ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// resident table: A = a row tile of x (row-major, ring), B = the centers
// (feature-major, [dp][cp]) with their norms cn[cp]
__device__ void assign_resident(const float* __restrict__ x,
                                const float* __restrict__ c,
                                int* __restrict__ out, int n, int C, int d,
                                int dp, int cp, int lda, int vw, float* sm) {
  float* cs = sm;                        // [dp][cp]
  float* cn = cs + (size_t)dp * cp;      // [cp]
  float* xr = cn + cp;                   // AS_XST x [AS_A][lda]
  const int t = threadIdx.x, ta = t / 8, tb = t % 8;
  const int ntile = (n + AS_A - 1) / AS_A;
  const int stage = AS_A * lda;
  int rt = blockIdx.x;
  copy_rows(xr, lda, x + (size_t)rt * AS_A * d, d, AS_A, n - rt * AS_A, dp, d,
            vw);
  cp_async_commit();
  // the table, once, feature-major: element (k, j) at cs[k * cp + j], so
  // consecutive threads store consecutive words; AS_LOADS loads in flight
  const int total = dp * cp;
  for (int u0 = t; u0 < total; u0 += AS_LOADS * AS_THREADS) {
    float v[AS_LOADS];
#pragma unroll
    for (int q = 0; q < AS_LOADS; ++q) {
      const int u = u0 + q * AS_THREADS, k = u / cp, j = u - k * cp;
      v[q] = (u < total && j < C && k < d) ? __ldg(c + (size_t)j * d + k) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < AS_LOADS; ++q)
      if (u0 + q * AS_THREADS < total) cs[u0 + q * AS_THREADS] = v[q];
  }
  __syncthreads();
  // |c|^2: one ascending chain a center
  for (int j = t; j < cp; j += AS_THREADS) {
    float s = 0.f;
    for (int k = 0; k < dp; ++k) s = fmaf(cs[k * cp + j], cs[k * cp + j], s);
    cn[j] = s;
  }
  for (int it = 0; rt < ntile; ++it, rt += gridDim.x) {
    const int nxt = rt + gridDim.x;
    if (nxt < ntile)
      copy_rows(xr + ((it + 1) % AS_XST) * stage, lda,
                x + (size_t)nxt * AS_A * d, d, AS_A, n - nxt * AS_A, dp, d, vw);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this row tile (and, first time, the table) is in
    const float* A = xr + (it % AS_XST) * stage;
    float best[8], xn[8], unused[8], acc[8][8];
    int bidx[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      best[i] = CUDART_INF_F;
      bidx[i] = 0;
      xn[i] = 0.f;
    }
    for (int c0 = 0; c0 < C; c0 += AS_B) {
      zero_acc(acc);
      if (c0 == 0)
        tile_fma<true, false, false>(A, lda, cs, cp, dp, ta, tb, acc, xn,
                                     unused);
      else
        tile_fma<false, false, false>(A, lda, cs + c0, cp, dp, ta, tb, acc,
                                      xn, unused);
#pragma unroll
      for (int j = 0; j < 8; ++j) {        // ascending center index
        const int cj = c0 + b_item(tb, j);
        if (cj < C) {
          const float ccj = cn[cj];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float v = xn[i] + ccj - 2.f * acc[i][j];
            if (v < best[i]) { best[i] = v; bidx[i] = cj; }
          }
        }
      }
    }
    // the 8 lanes (tb) that share rows: (d2, index) lexicographic
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        lexmin(best[i], bidx[i], __shfl_xor_sync(0xffffffffu, best[i], off),
               __shfl_xor_sync(0xffffffffu, bidx[i], off));
      const int r = rt * AS_A + a_item(ta, i);
      if (tb == 0 && r < n) out[r] = bidx[i];
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }
}

// streamed table: A = a tile of centers (row-major chunk, ring), B = the
// block's 64 rows (feature-major: loaded once when d fits one chunk, else a
// chunk a stage beside A's)
__device__ void assign_streamed(const float* __restrict__ x,
                                const float* __restrict__ c,
                                int* __restrict__ out, int n, int C, int d,
                                int dp, int lda, int vw, float* sm) {
  __shared__ float rv[AS_THREADS / 32][AS_B];
  __shared__ int ri[AS_THREADS / 32][AS_B];
  const int t = threadIdx.x, ta = t / 8, tb = t % 8;
  const int r0 = blockIdx.x * AS_B;
  const int nch = (dp + AS_KC - 1) / AS_KC;
  const bool one = nch == 1;
  const int stage = AS_A * lda + (one ? 0 : AS_KC * AS_B);
  float* bres = sm + AS_NST * stage;
  const int nct = (C + AS_A - 1) / AS_A;
  const int nitem = nct * nch;
  auto issue = [&](int q) {
    float* s = sm + (q % AS_NST) * stage;
    const int ct = q / nch, k0 = (q % nch) * AS_KC;
    const int w = min(AS_KC, dp - k0), wv = min(w, d - k0);
    copy_rows(s, lda, c + (size_t)ct * AS_A * d + k0, d, AS_A, C - ct * AS_A,
              w, wv, vw);
    if (!one)
      copy_cols(s + AS_A * lda, AS_B, x + (size_t)r0 * d + k0, d, n - r0, w,
                wv);
  };
  if (one) copy_cols(bres, AS_B, x + (size_t)r0 * d, d, n - r0, dp, d);
  for (int q = 0; q < AS_NST - 1; ++q) {
    if (q < nitem) issue(q);
    cp_async_commit();
  }
  float best[8], xn[8], cn[8], acc[8][8];
  int bidx[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    best[j] = CUDART_INF_F;
    bidx[j] = 0;
    xn[j] = 0.f;
  }
  for (int q = 0; q < nitem; ++q) {
    cp_async_wait<AS_NST - 2>();
    __syncthreads();  // item q is in; item q - 1's stage is consumed
    if (q + AS_NST - 1 < nitem) issue(q + AS_NST - 1);
    cp_async_commit();
    const float* s = sm + (q % AS_NST) * stage;
    const int ct = q / nch, kc = q % nch, k0 = kc * AS_KC;
    const int w = min(AS_KC, dp - k0);
    const float* B = one ? bres : s + AS_A * lda;
    if (kc == 0) {
      zero_acc(acc);
#pragma unroll
      for (int i = 0; i < 8; ++i) cn[i] = 0.f;
    }
    if (ct == 0)
      tile_fma<true, true, true>(s, lda, B, AS_B, w, ta, tb, acc, cn, xn);
    else
      tile_fma<true, false, true>(s, lda, B, AS_B, w, ta, tb, acc, cn, xn);
    if (kc == nch - 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {    // ascending center index
        const int ci = ct * AS_A + a_item(ta, i);
        if (ci < C) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float v = xn[j] + cn[i] - 2.f * acc[i][j];
            if (v < best[j]) { best[j] = v; bidx[j] = ci; }
          }
        }
      }
    }
  }
  // the threads (ta) that share rows: 4 in a warp, then across the warps
  const int warp = t / 32, lane = t % 32;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int off = 8; off < 32; off <<= 1)
      lexmin(best[j], bidx[j], __shfl_xor_sync(0xffffffffu, best[j], off),
             __shfl_xor_sync(0xffffffffu, bidx[j], off));
    if (lane < 8) {
      rv[warp][b_item(tb, j)] = best[j];
      ri[warp][b_item(tb, j)] = bidx[j];
    }
  }
  __syncthreads();
  if (t < AS_B && r0 + t < n) {
    float v = rv[0][t];
    int i = ri[0][t];
#pragma unroll
    for (int w = 1; w < AS_THREADS / 32; ++w) lexmin(v, i, rv[w][t], ri[w][t]);
    out[r0 + t] = i;
  }
}

template <bool RESIDENT>
__global__ void __launch_bounds__(AS_THREADS, 1)
assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
              int* __restrict__ out, int n, int C, int d, int dp, int cp,
              int lda, int vw) {
  extern __shared__ __align__(16) float sm[];
  if (RESIDENT) assign_resident(x, c, out, n, C, d, dp, cp, lda, vw, sm);
  else assign_streamed(x, c, out, n, C, d, dp, lda, vw, sm);
}

}  // namespace

extern "C" {

// x (n, d), centers (C, d) fp32 contiguous; out (n,) int32.  n, C >= 1.
// The wrapper (kernels/assign/ops.py, assign_plan) picks the path and
// passes its shape: resident != 0: grid blocks walking row tiles of 256,
// cp = C rounded up to 4 (the table's row stride); else one block per 64
// rows.  dp = d rounded up to 2; lda = the A operand's row stride (2 mod
// 4); vw = 2 when x (resident) or the centers (streamed) may be copied 8
// bytes at a time, else 1; smem bytes.
int assign_f32(const float* x, const float* centers, int* out, int n, int C,
               int d, int resident, int grid, int dp, int cp, int lda, int vw,
               int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kern = resident ? assign_kernel<true> : assign_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, AS_THREADS, smem, s>>>(x, centers, out, n, C, d, dp, cp, lda,
                                      vw);
  return (int)cudaGetLastError();
}

}  // extern "C"
