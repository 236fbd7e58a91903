// Fused decode attention (B10) for Hopper.
//
// decode_attention_fwd replaces decode_attention_pallas (body
// _decode_kernel) in src/repro/kernels/decode_attention/decode_attention.py:
// one new token per kv-head group attends to a ring-buffer KV cache stored
// in bf16, f32 or int8 with f32 per-(token, head) scales; the cache is
// streamed in its stored type and int8 is dequantised in registers
// (x * scale), so an int8 cache moves half the bytes of a bf16 one.
//   Bound on the H100: each cache element is used by G query rows for one
//   multiply-add each (G = 1 on stablelm), ~1 operation per byte, so the
//   launch is bound by the cache read from device memory (3.35 TB/s); at
//   the LM path's step (B 8, S 320) the 21 MB cache is small enough that
//   latency, not bandwidth, sets the pace.
//   Design, and where it differs from the TPU grid:
//   * The TPU grid walks S sequentially per (batch x kv head) with the
//     running max, sum and accumulator in VMEM.  Here a block owns (HB kv
//     heads, batch, split): a contiguous run of the visible keys.  The
//     wrapper turns the reference's validity (key s is visible when s <=
//     pos or pos >= S, and with a window when (pos - s) mod S < window)
//     into one run of ring positions s0, s0 + 1, .. (mod S) of nvis keys,
//     so no key outside it is loaded or even looked at.
//   * Long runs: every thread issues 16-byte cp.async copies (LDGSTS, with
//     the L2 fetching whole 128-byte lines) of K and V rows, and of the int8
//     scales, into a ring of shared-memory stages, one tile of TK keys a
//     stage; the next tile is in flight while the block computes this one.
//     The ring holds every tile of a split when they fit in 6 stages, else
//     2 (more blocks an SM beat a deeper ring at long context).  cp.async
//     over TMA: the keys of a head are rows strided by Hk D elements, which
//     16-byte copies take as they are, no tensor map is encoded on the host
//     for each call (decode is host-bound), and a copy in flight holds no
//     register.  With bf16 queries and D <= 64 a block reads HB adjacent
//     heads, whose rows of a key are one contiguous run: 2 for int8 (its
//     64-byte rows fill a 128-byte line), 4 for int8 and 2 for bf16 over
//     long runs (the wrapper's heads_per_block).
//   * Short runs of a bf16 or f32 cache (one split, at most 6 tiles): the
//     direct path.  Each group loads its keys straight into registers with
//     16-byte loads, the next step's while it computes this one, and no
//     block barrier comes before the merge: the ring's barrier a tile and
//     its trip through shared memory cost more than they hide there.
//   * Groups of query heads: an instance takes G = 1, 2, 4, 5 or 8 query
//     heads a kv head, every lane holding all G query rows in registers
//     (at G 8 the direct path already spills).  A group of 16 (qwen3-moe)
//     runs as ng = 2 slices of 8 in one launch: adjacent blocks take the
//     two slices of one kv head, so the second read of its keys finds
//     them in L2 while the first block streams them.
//   * The compute: groups of L lanes take a key, each lane E elements (16
//     for int8 at G <= 2 where 16 divides D, else 8), so a lane reads 16
//     bytes of bf16 or int8 per key (32 of f32; 8 of int8 at D = 8); L is a
//     power of two, and where D / E is not (D = 80, 160) the lanes past it
//     are masked out of loads and sums; every group keeps its own online softmax (max,
//     sum, accumulator) in registers, and a head's groups merge through
//     shared memory once at the end in a fixed order, with one expf a
//     group.  int8 becomes f32 through a byte permute into 2^23 + u and one
//     subtraction (exact), and its scales multiply the dot product and p
//     once a key, not each element.
//   * A split over the keys when the blocks would leave SMs idle (the
//     wrapper's split_count: B = 1 at long context): each split writes its
//     (max, sum, accumulator) to a workspace, and a per-(batch, head block)
//     ticket (atomicAdd) picks the block that arrives last; it merges the
//     partials in split order, so the output is the same bits whatever the
//     arrival order, and resets its ticket to 0 for the next call.
//   * The partials mode (flash-decoding over a cache split over the
//     sequence): the same launch on one block of the ring writes its output
//     in f32 (po) and the log-sum-exp of its keys' logits (plse, m + log l)
//     instead of o, so the caller can merge the blocks; the default mode's
//     arithmetic and stores are unchanged.
//   The reference's -1e30 for masked logits and the 1e-30 floor on the sum
//   stay.  expf and IEEE division, no fast math.
//   Tried on the card and slower: a ring at the LM path's step (depth 1 to
//   5, 128 or 256 threads, 1 to 4 keys a group a tile: all slower than a
//   register kernel there); 3 or 4 stages at long context; .L2::256B; 4
//   heads a block for the int8 step (too few blocks); a split count
//   rounded up (a second wave of blocks at B = 1).  Untried: TMA tensor
//   maps, a persistent grid.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int NST_MAX = 6;          // ring stages when every tile fits
constexpr int SPLIT_MAX = 64;       // the wrapper's cap on splits
constexpr int G_MAX = 8;            // the largest group of one launch

__host__ __device__ constexpr int pow2_ceil(int x) { return x <= 1 ? 1 : 2 * pow2_ceil((x + 1) / 2); }

// Tile geometry of one (cache type, head dim, group, heads a block)
// instance: NG groups of L lanes, HB heads side by side (a key's HB rows are
// adjacent in the cache), so KS = NG / HB key slots a head, U keys a slot a
// tile.  A key's D elements lie on its first LA lanes, E each; L is LA
// rounded up to a power of two (the shuffle reductions and the groups
// need one that divides the warp), so at D = 80 and 160 the lanes from LA
// on load nothing and add zeros (bf16: 10 of 16, 20 of 32 lanes busy).
template <typename CT, int D, int G, int HB>
struct Tile {
  static constexpr int ES = sizeof(CT);
  static constexpr bool QUANT = ES == 1;
  static constexpr int E = ES == 4 ? 8 : (QUANT && G <= 2 && D % 16 == 0 ? 16 : 8);
  static constexpr int LA = D / E;             // lanes that hold a key's elements
  static constexpr int L = pow2_ceil(LA);      // lanes a key
  static_assert(D % E == 0 && L <= 32, "head_dim must be a multiple of 8, at most 256");
  static constexpr int NG = THREADS / L;       // key groups a block
  static constexpr int KS = NG / HB;           // key slots a head
  static constexpr int U = ES == 4 ? 1 : 2;    // keys a slot a tile
  static constexpr int TK = KS * U;            // keys a tile
  static constexpr int ROW = D * ES;           // bytes of a key's row
  static constexpr int ROWB = HB * ROW;        // bytes of a key, HB heads
  static constexpr int KV = TK * ROWB;         // bytes of K (or V) a stage
  static constexpr int CP = ROWB % 16 == 0 ? 16 : 8;   // bytes a copy (int8 D = 8: 8)
  static constexpr int STG = 2 * KV + (QUANT ? 8 * TK * HB : 0);
  static constexpr int MERGE = 4 * NG * G * (D + 3);
};

// 16-byte asynchronous copy with the L2 fetching whole 128-byte lines;
// zero-fills the destination when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;"
               ::"r"(d), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global.L2::128B [%0], [%1], 8, %2;"
               ::"r"(d), "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}
template <int CP>
__device__ __forceinline__ void cp_async_row(void* dst, const void* src, bool valid) {
  if constexpr (CP == 16) cp_async16(dst, src, valid);
  else cp_async8(dst, src, valid);
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global.L2::128B [%0], [%1], 4, %2;"
               ::"r"(d), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until at most n groups are pending (n < NST_MAX)
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 5;" ::: "memory"); break;
  }
}

// E elements at p (16-byte aligned) as floats
template <int E>
__device__ __forceinline__ void to_float(const float* p, float* out) {
#pragma unroll
  for (int j = 0; j < E / 4; ++j) {
    const float4 a = reinterpret_cast<const float4*>(p)[j];
    out[4 * j] = a.x; out[4 * j + 1] = a.y;
    out[4 * j + 2] = a.z; out[4 * j + 3] = a.w;
  }
}
template <int E>
__device__ __forceinline__ void to_float(const __nv_bfloat16* p, float* out) {
#pragma unroll
  for (int j = 0; j < E / 8; ++j) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[j];
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      out[8 * j + 2 * i] = f.x;
      out[8 * j + 2 * i + 1] = f.y;
    }
  }
}
// signed bytes: (x ^ 0x80) lands in the low byte of 2^23 = 0x4B000000, so
// the float is 2^23 + 128 + x; subtracting 2^23 + 128 is exact
__device__ __forceinline__ void bytes4(uint32_t w, float* out) {
  const uint32_t x = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out[j] = __int_as_float(__byte_perm(x, 0x4B000000u, 0x7540u | j)) -
             8388736.0f;
}
template <int E>
__device__ __forceinline__ void to_float(const int8_t* p, float* out) {
  if (E == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    bytes4(u.x, out); bytes4(u.y, out + 4);
    bytes4(u.z, out + 8); bytes4(u.w, out + 12);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    bytes4(u.x, out); bytes4(u.y, out + 4);
  }
}

// the log-sum-exp of no key
__device__ __forceinline__ float neg_inf() {
  return -__int_as_float(0x7f800000);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Online softmax over U keys for one group: kp[u], vp[u] point at this
// lane's E elements of key u's K and V rows (shared memory or registers),
// ok[u] whether key u is visible, ksc/vsc its int8 scales.
template <typename CT, int G, int E, int L, int U, bool QUANT>
__device__ __forceinline__ void attend(const CT* const (&kp)[U],
                                       const CT* const (&vp)[U],
                                       const bool (&ok)[U],
                                       const float (&ksc)[U],
                                       const float (&vsc)[U],
                                       const float (&qf)[G][E],
                                       float (&acc)[G][E], float (&m)[G],
                                       float (&l)[G], float scale) {
  float sc[G][U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float kf[E];
    to_float<E>(kp[u], kf);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float a = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) a = fmaf(qf[g][e], kf[e], a);
#pragma unroll
      for (int w = L / 2; w > 0; w >>= 1)
        a += __shfl_xor_sync(0xffffffffu, a, w);
      if (QUANT) a *= ksc[u];
      sc[g][u] = ok[u] ? a * scale : NEG_INF;
    }
  }
  float p[G][U];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mx = NEG_INF;
#pragma unroll
    for (int u = 0; u < U; ++u) mx = fmaxf(mx, sc[g][u]);
    const float m_new = fmaxf(m[g], mx);
    const float alpha = expf(m[g] - m_new);
    float ps = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      p[g][u] = ok[u] ? expf(sc[g][u] - m_new) : 0.f;
      ps += p[g][u];
    }
    l[g] = l[g] * alpha + ps;
    m[g] = m_new;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float vf[E];
    to_float<E>(vp[u], vf);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float w = QUANT ? p[g][u] * vsc[u] : p[g][u];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = fmaf(w, vf[e], acc[g][e]);
    }
  }
}

// The direct path's registers: UD keys' K and V rows of one lane.
template <typename CT, int E, int UD>
struct Rows {
  static constexpr int N = E * sizeof(CT) / 16;   // 16-byte pieces a row
  uint4 k[UD][N], v[UD][N];
};

// DIRECT: the direct path, else the ring (each its own instance, so neither
// path's registers limit the other's occupancy)
template <typename QT, typename CT, int D, int G, int HB, bool DIRECT>
__global__ void __launch_bounds__(THREADS)
decode_fwd_kernel(const QT* __restrict__ q, const CT* __restrict__ kc,
                  const CT* __restrict__ vc, const float* __restrict__ ksc,
                  const float* __restrict__ vsc, QT* __restrict__ o,
                  float* __restrict__ po, float* __restrict__ plse,
                  float* __restrict__ ws, int* __restrict__ cnt, int S, int Hk,
                  int ng, int s0, int nvis, int chunk, int nst, float scale) {
  using T = Tile<CT, D, G, HB>;
  constexpr int E = T::E, L = T::L, NG = T::NG, KS = T::KS, U = T::U;
  constexpr int TK = T::TK;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float sw[SPLIT_MAX * G_MAX * HB];
  __shared__ float mg[G_MAX * HB];
  __shared__ int last;

  const int hc = blockIdx.x / ng, gsl = blockIdx.x % ng;  // head block, slice
  const int b = blockIdx.y, sp = blockIdx.z;
  const int nsp = gridDim.z;
  const int tid = threadIdx.x, lane = tid % L, grp = tid / L;
  const bool act = lane < T::LA;                // a lane past LA holds nothing
  const int le = act ? lane * E : 0;            // its first element (idle: 0)
  const int hh = grp % HB, ks = grp / HB;       // this group's head, slot
  const int hk0 = hc * HB;                      // the block's first head
  const int k_beg = sp * chunk;
  const int k_end = min(nvis, k_beg + chunk);
  const int nt = (k_end - k_beg + TK - 1) / TK;
  const size_t row0 = (size_t)b * S;   // key s: ((row0 + s) Hk + hk) rows

  float qf[G][E], acc[G][E], m[G], l[G];
  // query rows of (b, head, slice): G rows of the head's ng G
  const QT* qb = q + (((size_t)b * Hk + hk0 + hh) * ng + gsl) * G * D + le;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    to_float<E>(qb + g * D, qf[g]);
    if (!act) {                                // idle lanes add zeros
#pragma unroll
      for (int e = 0; e < E; ++e) qf[g][e] = 0.f;
    }
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  // tile t into stage t % nst: each key's HB rows are one contiguous run
  auto issue = [&](int t) {
    unsigned char* kd = smem + (t % nst) * T::STG;
    unsigned char* vd = kd + T::KV;
    const int base = k_beg + t * TK;
    for (int c = tid; c < T::KV / T::CP; c += THREADS) {
      const int kk = c / (T::ROWB / T::CP), part = c % (T::ROWB / T::CP);
      const int kidx = base + kk;
      const bool ok = kidx < k_end;
      int s = s0 + kidx;
      if (s >= S) s -= S;
      const size_t off =
          ok ? ((row0 + s) * Hk + hk0) * (size_t)T::ROW + part * T::CP : 0;
      cp_async_row<T::CP>(kd + c * T::CP,
                          reinterpret_cast<const unsigned char*>(kc) + off, ok);
      cp_async_row<T::CP>(vd + c * T::CP,
                          reinterpret_cast<const unsigned char*>(vc) + off, ok);
    }
    if (T::QUANT) {            // scales: [TK][HB] for K, then for V
      float* sd = reinterpret_cast<float*>(vd + T::KV);
      for (int c = tid; c < TK * HB; c += THREADS) {
        const int kidx = base + c / HB;
        const bool ok = kidx < k_end;
        int s = s0 + kidx;
        if (s >= S) s -= S;
        const size_t off = ok ? (row0 + s) * Hk + hk0 + c % HB : 0;
        cp_async4(sd + c, ksc + off, ok);
        cp_async4(sd + TK * HB + c, vsc + off, ok);
      }
    }
  };

  if constexpr (DIRECT) {
    // direct path (bf16/f32 cache, one head, one split, few keys): a group
    // takes UD consecutive keys a step straight into registers with 16-byte
    // loads, the next step's while it computes this one; no block barrier
    constexpr int UD = 64 / (E * (int)sizeof(CT));
    const int n_steps = (k_end - k_beg + NG * UD - 1) / (NG * UD);
    const CT* kb = kc + (row0 * Hk + hk0) * D + le;
    const CT* vb = vc + (row0 * Hk + hk0) * D + le;
    const size_t stride = (size_t)Hk * D;
    Rows<CT, E, UD> r[2];
    auto load = [&](Rows<CT, E, UD>& x, int it) {
#pragma unroll
      for (int u = 0; u < UD; ++u) {
        const int kidx = k_beg + (it * NG + grp) * UD + u;
        int s = s0 + kidx;
        if (s >= S) s -= S;
        const bool vis = act && kidx < k_end;
        const uint4* kq =
            reinterpret_cast<const uint4*>(kb + (size_t)s * stride);
        const uint4* vq =
            reinterpret_cast<const uint4*>(vb + (size_t)s * stride);
#pragma unroll
        for (int j = 0; j < Rows<CT, E, UD>::N; ++j) {
          x.k[u][j] = vis ? __ldg(kq + j) : make_uint4(0, 0, 0, 0);
          x.v[u][j] = vis ? __ldg(vq + j) : make_uint4(0, 0, 0, 0);
        }
      }
    };
    auto use = [&](const Rows<CT, E, UD>& x, int it) {
      const CT* kp[UD];
      const CT* vp[UD];
      bool ok[UD];
      float one[UD];
#pragma unroll
      for (int u = 0; u < UD; ++u) {
        ok[u] = k_beg + (it * NG + grp) * UD + u < k_end;
        kp[u] = reinterpret_cast<const CT*>(x.k[u]);
        vp[u] = reinterpret_cast<const CT*>(x.v[u]);
        one[u] = 1.f;
      }
      attend<CT, G, E, L, UD, false>(kp, vp, ok, one, one, qf, acc, m, l,
                                     scale);
    };
    if (n_steps > 0) load(r[0], 0);
    for (int it = 0; it < n_steps; it += 2) {   // uniform: shuffles inside
      if (it + 1 < n_steps) load(r[1], it + 1);
      use(r[0], it);
      if (it + 1 < n_steps) {
        if (it + 2 < n_steps) load(r[0], it + 2);
        use(r[1], it + 1);
      }
    }
  } else {
    for (int t = 0; t < nst; ++t) {
      if (t < nt) issue(t);
      cp_async_commit();
    }
    for (int t = 0; t < nt; ++t) {
      cp_async_wait(nst - 1);
      __syncthreads();          // tile t landed for every thread

      const unsigned char* kd = smem + (t % nst) * T::STG;
      const unsigned char* vd = kd + T::KV;
      const float* kss = reinterpret_cast<const float*>(vd + T::KV);
      const int base = k_beg + t * TK;
      const CT* kp[U];
      const CT* vp[U];
      bool ok[U];
      float ksu[U], vsu[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kk = u * KS + ks;
        const int o = kk * T::ROWB + hh * T::ROW;
        ok[u] = base + kk < k_end;
        kp[u] = reinterpret_cast<const CT*>(kd + o) + le;
        vp[u] = reinterpret_cast<const CT*>(vd + o) + le;
        ksu[u] = T::QUANT ? kss[kk * HB + hh] : 1.f;
        vsu[u] = T::QUANT ? kss[TK * HB + kk * HB + hh] : 1.f;
      }
      attend<CT, G, E, L, U, T::QUANT>(kp, vp, ok, ksu, vsu, qf, acc, m, l,
                                       scale);
      if (t + nst < nt) {       // refill this stage once every thread is done
        __syncthreads();
        issue(t + nst);
      }
      cp_async_commit();
    }
    cp_async_wait(0);
  }
  __syncthreads();            // the ring becomes the merge's scratch

  // merge a head's KS groups in slot order: weights exp(m_n - M) once a
  // group; group n = slot * HB + head
  float* accs = reinterpret_cast<float*>(smem);   // NG x G x D
  float* ms = accs + NG * G * D;                   // NG x G
  float* ls = ms + NG * G;
  float* wt = ls + NG * G;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float* dst = accs + (grp * G + g) * D + le;
    if (act) {
#pragma unroll
      for (int e = 0; e < E; ++e) dst[e] = acc[g][e];
    }
    if (lane == 0) {
      ms[grp * G + g] = m[g];
      ls[grp * G + g] = l[g];
    }
  }
  __syncthreads();
  if (tid < HB * G) {         // tid = head * G + g
    const int h = tid / G, g = tid % G;
    float mx = NEG_INF;
    for (int n = 0; n < KS; ++n) mx = fmaxf(mx, ms[(n * HB + h) * G + g]);
    mg[tid] = mx;
  }
  __syncthreads();
  for (int i = tid; i < NG * G; i += THREADS)   // i = group * G + g
    wt[i] = expf(ms[i] - mg[(i / G) % HB * G + i % G]);
  __syncthreads();
  float* wsb = ws + ((size_t)b * ng + gsl) * Hk * nsp * G * (D + 2);
  // element d of output row r = (b, head, slice, g): normalised in q's
  // type, or (partials mode) in f32 with the row's log-sum-exp mx + log l
  auto put = [&](size_t r, int d, float out, float lsum, float mx) {
    const float val = out / fmaxf(lsum, 1e-30f);
    if (po == nullptr) {
      store1(o + r * D + d, val);
    } else {
      po[r * D + d] = val;
      if (d == 0) plse[r] = lsum > 0.f ? mx + logf(lsum) : neg_inf();
    }
  };
  for (int i = tid; i < HB * G * D; i += THREADS) {
    const int h = i / (G * D), g = i / D % G, d = i % D;
    float lsum = 0.f, out = 0.f;
    for (int n = 0; n < KS; ++n) {
      const int r = (n * HB + h) * G + g;
      const float w = wt[r];
      lsum = fmaf(ls[r], w, lsum);
      out = fmaf(accs[r * D + d], w, out);
    }
    const int hk = hk0 + h;
    if (nsp == 1) {
      put(((((size_t)b * Hk + hk) * ng + gsl) * G + g), d, out, lsum,
          mg[h * G + g]);
    } else {                  // partial of (b, hk), split sp
      float* wp = wsb + ((size_t)hk * nsp + sp) * G * (D + 2) + g * (D + 2);
      wp[d] = out;
      if (d == 0) {
        wp[D] = mg[h * G + g];
        wp[D + 1] = lsum;
      }
    }
  }
  if (nsp == 1) return;

  // split over keys: the last block of this (batch, head chunk) merges the
  // partials in split order and resets the ticket
  __threadfence();
  __syncthreads();
  const int pair = (b * ng + gsl) * (Hk / HB) + hc;
  if (tid == 0) last = atomicAdd(cnt + pair, 1) == nsp - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* wb = wsb + (size_t)hk0 * nsp * G * (D + 2);   // [h][j][g][D+2]
  if (tid < HB * G) {
    const int h = tid / G, g = tid % G;
    float mx = NEG_INF;
    for (int j = 0; j < nsp; ++j)
      mx = fmaxf(mx, __ldcg(wb + ((h * nsp + j) * G + g) * (D + 2) + D));
    mg[tid] = mx;
  }
  __syncthreads();
  for (int i = tid; i < HB * nsp * G; i += THREADS) {   // i = (h nsp + j) G + g
    const int g = i % G, h = i / (nsp * G);
    sw[i] = expf(__ldcg(wb + i * (D + 2) + D) - mg[h * G + g]);
  }
  __syncthreads();
  for (int i = tid; i < HB * G * D; i += THREADS) {
    const int h = i / (G * D), g = i / D % G, d = i % D;
    float lsum = 0.f, out = 0.f;
    for (int j = 0; j < nsp; ++j) {
      const int r = (h * nsp + j) * G + g;
      const float w = sw[r];
      const float* pj = wb + r * (D + 2);
      lsum = fmaf(__ldcg(pj + D + 1), w, lsum);
      out = fmaf(__ldcg(pj + d), w, out);
    }
    put(((((size_t)b * Hk + hk0 + h) * ng + gsl) * G + g), d, out, lsum,
        mg[h * G + g]);
  }
  if (tid == 0) cnt[pair] = 0;
}

template <typename QT, typename CT, int D, int G, int HB, bool DIRECT>
cudaError_t run(const void* q, const void* k, const void* v, const float* ks,
                const float* vs, void* o, float* po, float* plse, float* ws,
                int* cnt, int B, int S,
                int Hk, int ng, int s0, int nvis, int nsplit, int chunk,
                int nst, int smem, int smem_max, float scale,
                cudaStream_t st) {
  static unsigned opted = 0;   // devices with the shared-memory opt-in set
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (!(opted >> dev & 1u)) {
    e = cudaFuncSetAttribute(decode_fwd_kernel<QT, CT, D, G, HB, DIRECT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_max);
    if (e != cudaSuccess) return e;
    opted |= 1u << dev;
  }
  decode_fwd_kernel<QT, CT, D, G, HB, DIRECT>
      <<<dim3(Hk / HB * ng, B, nsplit), THREADS, smem, st>>>(
          static_cast<const QT*>(q), static_cast<const CT*>(k),
          static_cast<const CT*>(v), ks, vs, static_cast<QT*>(o), po, plse, ws,
          cnt, S,
          Hk, ng, s0, nvis, chunk, nst, scale);
  return cudaGetLastError();
}

template <typename QT, typename CT, int D, int G, int HB>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, void* o, float* po, float* plse, float* ws,
                   int* cnt, int B, int S,
                   int Hk, int ng, int s0, int nvis, int nsplit, int chunk,
                   float scale, cudaStream_t st) {
  using T = Tile<CT, D, G, HB>;
  // the direct path for a bf16/f32 cache whose one split has at most 6
  // tiles; else a ring of every tile when they fit in 6 stages, or of 2
  // (long contexts: more blocks an SM beat a deeper ring)
  const int nt = (chunk + T::TK - 1) / T::TK;
  if constexpr (!T::QUANT && HB == 1) {
    if (nsplit == 1 && nt <= NST_MAX)
      return run<QT, CT, D, G, HB, true>(q, k, v, ks, vs, o, po, plse, ws,
                                         cnt, B, S,
                                         Hk, ng, s0, nvis, nsplit, chunk, 0,
                                         T::MERGE, T::MERGE, scale, st);
  }
  const int nst = nt <= NST_MAX ? max(nt, 1) : 2;
  return run<QT, CT, D, G, HB, false>(
      q, k, v, ks, vs, o, po, plse, ws, cnt, B, S, Hk, ng, s0, nvis, nsplit,
      chunk, nst, max(nst * T::STG, T::MERGE),
      max(NST_MAX * T::STG, T::MERGE), scale, st);
}

#define DEC_ARGS q, k, v, ks, vs, o, po, plse, ws, cnt, B, S, Hk, ng, s0, \
                 nvis, nsplit, chunk, scale, st

template <typename QT, typename CT, int D, int HB>
cudaError_t dispatch_g(int G, const void* q, const void* k, const void* v,
                       const float* ks, const float* vs, void* o, float* po,
                       float* plse, float* ws, int* cnt, int B, int S, int Hk,
                       int ng, int s0,
                       int nvis, int nsplit, int chunk, float scale,
                       cudaStream_t st) {
  switch (G) {
    case 1: return launch<QT, CT, D, 1, HB>(DEC_ARGS);
    case 2: return launch<QT, CT, D, 2, HB>(DEC_ARGS);
    case 4: return launch<QT, CT, D, 4, HB>(DEC_ARGS);
    case 5: return launch<QT, CT, D, 5, HB>(DEC_ARGS);
    case 8: return launch<QT, CT, D, 8, HB>(DEC_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

// The instances of one head dim at one kv head a block: the query and
// cache types.
template <int D>
cudaError_t dispatch_one(int q_dtype, int cache_int8, const void* q,
                         const void* k, const void* v, const float* ks,
                         const float* vs, void* o, float* po, float* plse,
                         float* ws, int* cnt, int G,
                         int B, int S, int Hk, int ng, int s0, int nvis,
                         int nsplit, int chunk, float scale, cudaStream_t st) {
  using BF = __nv_bfloat16;
  if (cache_int8)
    return q_dtype == 0 ? dispatch_g<float, int8_t, D, 1>(G, DEC_ARGS)
                        : dispatch_g<BF, int8_t, D, 1>(G, DEC_ARGS);
  return q_dtype == 0 ? dispatch_g<float, float, D, 1>(G, DEC_ARGS)
                      : dispatch_g<BF, BF, D, 1>(G, DEC_ARGS);
}

// The blocks of 2 and 4 kv heads (bf16 queries; D 16 and 64 only).
template <int D>
cudaError_t dispatch_multi(int cache_int8, int heads, const void* q,
                           const void* k, const void* v, const float* ks,
                           const float* vs, void* o, float* po,
                           float* plse, float* ws, int* cnt, int G, int B,
                           int S, int Hk, int ng, int s0,
                           int nvis, int nsplit, int chunk, float scale,
                           cudaStream_t st) {
  using BF = __nv_bfloat16;
  if (cache_int8)
    return heads == 2 ? dispatch_g<BF, int8_t, D, 2>(G, DEC_ARGS)
                      : dispatch_g<BF, int8_t, D, 4>(G, DEC_ARGS);
  return dispatch_g<BF, BF, D, 2>(G, DEC_ARGS);
}

}  // namespace

// The build compiles this file as one object a part, all started
// together and then linked: runtime.build_parts counts the
// "#if BUILD_PART ==" blocks below and passes -DBUILD_PART=p to part p.
// Each part defines the instances of its head dim (part 2 the multi-head
// blocks), part 0 also the entry point, so every head dim of the switch
// is defined in exactly one block.
#ifndef BUILD_PART
#error "decode_attention.cu is built in parts: pass -DBUILD_PART=<part>"
#endif
#define DIM_PARAMS                                                            \
  const void *q, const void *k, const void *v, const float *ks,               \
      const float *vs, void *o, float *po, float *plse, float *ws, int *cnt,   \
      int G, int B, int S,                                                     \
      int Hk, int ng, int s0, int nvis, int nsplit, int chunk, float scale,    \
      cudaStream_t st
#define DIM_ARGS q, k, v, ks, vs, o, po, plse, ws, cnt, G, B, S, Hk, ng, s0, \
                 nvis, nsplit, chunk, scale, st
#define DIM_DECL(D) \
  cudaError_t dim_##D(int q_dtype, int cache_int8, DIM_PARAMS);
#define DIM_DEF(D)                                                       \
  cudaError_t decode_parts::dim_##D(int q_dtype, int cache_int8,         \
                                    DIM_PARAMS) {                        \
    return dispatch_one<D>(q_dtype, cache_int8, DIM_ARGS);               \
  }
#define MULTI_DECL(D) \
  cudaError_t multi_##D(int cache_int8, int heads, DIM_PARAMS);
#define MULTI_DEF(D)                                                     \
  cudaError_t decode_parts::multi_##D(int cache_int8, int heads,         \
                                      DIM_PARAMS) {                      \
    return dispatch_multi<D>(cache_int8, heads, DIM_ARGS);               \
  }
namespace decode_parts {
DIM_DECL(8) DIM_DECL(16) DIM_DECL(64) DIM_DECL(80) DIM_DECL(128)
DIM_DECL(160) DIM_DECL(256) MULTI_DECL(16) MULTI_DECL(64)
}  // namespace decode_parts

// one head dim a part (the multi-head blocks of D 16 and 64 in a part of
// their own), so that no part holds more than ~30 kernel instances
#if BUILD_PART == 0
DIM_DEF(16)
#endif
#if BUILD_PART == 1
DIM_DEF(64)
#endif
#if BUILD_PART == 2
MULTI_DEF(16)
MULTI_DEF(64)
#endif
#if BUILD_PART == 3
DIM_DEF(8)
#endif
#if BUILD_PART == 4
DIM_DEF(80)
#endif
#if BUILD_PART == 5
DIM_DEF(128)
#endif
#if BUILD_PART == 6
DIM_DEF(160)
#endif
#if BUILD_PART == 7
DIM_DEF(256)
#endif

#if BUILD_PART == 0
// q (B, Hk, ng G, D) and o in q's type (q_dtype 0: f32, 1: bf16): a kv
// head's ng G query heads run as ng slices of G (1, 2, 4, 5 or 8), each
// slice its own blocks (a group of 16 is ng 2 slices of 8); caches (B, S,
// Hk, D) in q's type, or int8 (cache_int8 = 1) with f32 scales (B, S, Hk,
// 1); every operand 16-byte aligned.  The visible keys are the
// ring positions s0, s0 + 1, .. (mod S), nvis of them, cut into nsplit
// runs of chunk keys (the last may be shorter, none empty).  heads: kv
// heads a block (1; 2 or 4 with an int8 cache, 2 with a bf16 one, for bf16
// queries, D 16 or 64 and Hk a multiple).  Partials mode: out_f32 (q's
// shape, f32) and lse (B, Hk, ng G, f32) non-null take the output
// normalised over these keys and their log-sum-exp, and o is not written
// (it may be null).  nsplit > 1 needs
// ws (B ng Hk nsplit G (D + 2) floats, no initial value) and cnt (B ng Hk /
// heads ints, zero; left zero); nsplit <= 64.  Returns cudaGetLastError().
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* k_scale,
                                    const void* v_scale, void* o,
                                    void* out_f32, void* lse, void* ws_,
                                    void* cnt_, int B, int S, int Hk, int G,
                                    int ng, int D, int q_dtype, int cache_int8,
                                    int heads, int s0, int nvis, int nsplit,
                                    int chunk, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  float* ws = static_cast<float*>(ws_);
  int* cnt = static_cast<int*>(cnt_);
  float* po = static_cast<float*>(out_f32);
  float* plse = static_cast<float*>(lse);
  if ((po == nullptr) != (plse == nullptr)) return (int)cudaErrorInvalidValue;
  if (nsplit < 1 || nsplit > SPLIT_MAX || G > G_MAX || ng < 1 || heads < 1 ||
      Hk % heads || (heads > 1 && ((D != 16 && D != 64) || q_dtype == 0)) ||
      (heads == 4 && !cache_int8) || heads > 4 || heads == 3)
    return (int)cudaErrorInvalidValue;
  using namespace decode_parts;
  if (heads > 1)   // D 16 or 64, checked above
    return (int)(D == 16 ? multi_16(cache_int8, heads, DIM_ARGS)
                         : multi_64(cache_int8, heads, DIM_ARGS));
  switch (D) {
    case 8: return (int)dim_8(q_dtype, cache_int8, DIM_ARGS);
    case 16: return (int)dim_16(q_dtype, cache_int8, DIM_ARGS);
    case 64: return (int)dim_64(q_dtype, cache_int8, DIM_ARGS);
    case 80: return (int)dim_80(q_dtype, cache_int8, DIM_ARGS);
    case 128: return (int)dim_128(q_dtype, cache_int8, DIM_ARGS);
    case 160: return (int)dim_160(q_dtype, cache_int8, DIM_ARGS);
    case 256: return (int)dim_256(q_dtype, cache_int8, DIM_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif
