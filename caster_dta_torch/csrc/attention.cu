// Blockwise masked multi-head attention, forward only, for Hopper (sm_90a).
//
// K4  masked_mha: out[b, h, i, :] = sum_j p_ij v[b, h, j, :] / sum_j p_ij with
//     p_ij = exp(s_ij - max_j s_ij) and s_ij = (q[b, h, i, :] . k[b, h, j, :])
//     * scale, except that a key marked in mask[b, j] gets s_ij = -1e9 exactly
//     (the logit is replaced, not shifted). All in f32; no weights come out.
//     A fully masked row therefore averages v over all Lk keys, as the dense
//     softmax over constant -1e9 logits does.
//     Replaces the Pallas kernel caster_dta_tpu/ops/pallas_attention.py
//     ::_mha_kernel (per query block, an online softmax over 128-key chunks
//     with MXU products; its third mask value, -2e9 for the keys that pad Lk
//     to the block, exists only for that tiling: these kernels give a key
//     past Lk no weight at all).
//     On this card the function is bound by f32 operations at the served
//     shapes (hd = 16: 4 operations per key and head dim against 8 bytes of k
//     and v that every query row of a block shares).
//
// Head dims up to 16 (the served model has 16): masked_mha_rows_kernel.
//     A lane owns R query rows (q, running max, running sum and 16
//     accumulators of each in registers), so a warp covers 32 R rows of one
//     graph-head, and every k or v value a lane reads serves R rows. Blocks of
//     4 warps stage K, V and the mask of 128 keys at a time in shared memory
//     (16-byte copies; the mask as a bias per key: 0 for a real key, -1e9 for
//     a masked one, -inf past the key range) and read them back as broadcast
//     float4 loads, which every lane of a warp takes from one address and so
//     cause no bank conflicts: 8 loads a key for R x 32 FFMAs. The softmax is
//     online over steps of KS keys, as the JAX kernel's over its chunks: the
//     R x KS scores in registers, one max and one rescale of each row a step,
//     then p = exp(s - m) and p v for every key of the step: no branch on the
//     data but one, the same in every lane: a step of masked keys alone is
//     skipped where the graph has a real key (its weights are exactly 0).
//     The exponent is ex2.approx (one MUFU instruction) with log2(e) folded
//     into the scale (and into -1e9). Where the query tile is short, the 4
//     warps take the same rows and split each staged chunk's keys between
//     them (s_in splits), merged through shared memory in split order; where
//     graph-heads times query tiles leave the card under one block an SM,
//     s_out blocks share a tile, each over its own range of keys: each writes
//     its partial (m, l, acc) to a scratch buffer, and the last to finish (an
//     atomic ticket on a per-tile counter, which it sets back to 0) merges
//     them in split order. Every sum runs in an order fixed by the shapes, so
//     two runs give the same bits. Served as R = 2, KS = 8 at 128 registers,
//     4 blocks an SM. The H100's times (scripts/k4_times.py) fit a cost of 4
//     cycles of the SM's shared-memory pipe for each broadcast float4 load,
//     as if each lane's 16 bytes were its own: 32 cycles a key and warp
//     against 16 for its 64 FFMAs at R = 2, so the loads, not the FFMAs, set
//     the time; R = 4 (254 registers, 2 blocks an SM) loses on latency.
// Head dims 17 to 128: masked_mha_kernel<G>, the first version. G
//     neighbouring lanes own a query row, 16 head dims each; `splits` such
//     groups share a row and take every splits-th key; one accurate expf a
//     key, a branch on a new maximum.
//
// Plain C interface, loaded with ctypes (caster_dta_torch/ops/cuda_attention.py).
// Each entry point launches one kernel on the caller's stream and returns
// cudaGetLastError() after its launch.
//
// For measurement only (scripts/k4_times.py), never in the library:
// K4_ABLATE_LOADS stages constants in place of K, V and the mask (no device
// loads but q's), K4_ABLATE_EXP takes p = s - m and no rescale (no ex2),
// K4_ABLATE_PRODUCTS takes one product a score and adds p alone to the
// accumulators (no FFMA chains, one k load a key and no v loads).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float K4_NEG = -1e9f;
constexpr double K4_LOG2E = 1.4426950408889634;

// ---- K4 on register-blocked query rows (hd <= 16) ----

// ---- PTX ----
// 2^x in one MUFU instruction; a result below 2^-126 flushes to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// ---- end of PTX ----

constexpr int RT_D = 16;              // head dims a lane holds, zero padded
constexpr int RT_F = RT_D + 2;        // a row's partial softmax: m, l, acc
constexpr int RT_WARPS = 4;
constexpr int RT_THREADS = 32 * RT_WARPS;
constexpr int RT_CHUNK = 128;         // keys staged at a time

struct RowsArgs {
  const float* q;
  const float* k;
  const float* v;
  const uint8_t* mask;                // [B, Lk], 1 = masked key, or null
  float* out;
  float* partial;                     // s_out > 1: [tiles x BH][s_out][RT_F][rows a block]
  int* counters;                      // s_out > 1: one per (graph-head, tile), 0 between launches
  int H, Lq, Lk, hd;
  float scale2, neg2;                 // the scale and -1e9, times log2(e)
  int s_in, s_out, tiles;
  int vec;                            // hd = 16 and 16-byte aligned rows: float4 copies
};

// One step of the online softmax over keys j0 .. j0 + KS - 1 of the stage.
// With skip_masked (the graph has a real key), a step of masked keys alone
// is skipped: each of its weights would be exp2(-1e9 log2(e) - m) = 0 once a
// real key sets m, and a rescale by 0 when it comes later, so the sums keep
// the same bits (for real logits above -1e9 + 88, where that exp2 flushes
// to 0).
template <int R, int KS>
__device__ __forceinline__ void softmax_step(const float* sk, const float* sv, const float* sbias,
                                             int j0, bool skip_masked,
                                             const float (&qr)[R][RT_D],
                                             float (&acc)[R][RT_D], float (&m)[R], float (&l)[R],
                                             float scale2) {
  float bias[KS];
#pragma unroll
  for (int j = 0; j < KS; j += 4) {
    const float4 b4 = *reinterpret_cast<const float4*>(sbias + j0 + j);
    bias[j] = b4.x;
    bias[j + 1] = b4.y;
    bias[j + 2] = b4.z;
    bias[j + 3] = b4.w;
  }
  if (skip_masked) {
    bool real = false;
#pragma unroll
    for (int j = 0; j < KS; ++j) real |= bias[j] == 0.f;
    if (!real) return;                  // the same keys in every lane: no divergence
  }
  float p[R][KS];
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const float4* kr = reinterpret_cast<const float4*>(sk + (j0 + j) * RT_D);
#ifndef K4_ABLATE_PRODUCTS
    float kk[RT_D];
#pragma unroll
    for (int i = 0; i < RT_D / 4; ++i) {
      const float4 x = kr[i];
      kk[4 * i] = x.x;
      kk[4 * i + 1] = x.y;
      kk[4 * i + 2] = x.z;
      kk[4 * i + 3] = x.w;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < RT_D; ++d) dot = fmaf(qr[r][d], kk[d], dot);
      p[r][j] = dot;
    }
#else
    const float k0 = kr[0].x;
#pragma unroll
    for (int r = 0; r < R; ++r) p[r][j] = qr[r][0] * k0;
#endif
  }
  // the logits (in log2 units): a masked key's replaced, a key past the range -inf
#pragma unroll
  for (int j = 0; j < KS; ++j) {
#pragma unroll
    for (int r = 0; r < R; ++r) p[r][j] = bias[j] == 0.f ? p[r][j] * scale2 : bias[j];
  }
  // one max a row (a tree: max is exact), one rescale, then the weights;
  // every step holds a key of the range, so the new max is finite
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float t[KS];
#pragma unroll
    for (int j = 0; j < KS; ++j) t[j] = p[r][j];
#pragma unroll
    for (int w = KS / 2; w > 0; w /= 2) {
#pragma unroll
      for (int j = 0; j < w; ++j) t[j] = fmaxf(t[j], t[j + w]);
    }
    const float mx = fmaxf(m[r], t[0]);
#ifndef K4_ABLATE_EXP
    const float c = ex2(m[r] - mx);         // 0 at the first step (m = -inf)
    l[r] *= c;
#pragma unroll
    for (int d = 0; d < RT_D; ++d) acc[r][d] *= c;
#endif
    m[r] = mx;
#pragma unroll
    for (int j = 0; j < KS; ++j) {
#ifndef K4_ABLATE_EXP
      p[r][j] = ex2(p[r][j] - mx);
#else
      p[r][j] = p[r][j] - mx;
#endif
    }
  }
#pragma unroll
  for (int j = 0; j < KS; ++j) {
#ifndef K4_ABLATE_PRODUCTS
    const float4* vr = reinterpret_cast<const float4*>(sv + (j0 + j) * RT_D);
    float vv[RT_D];
#pragma unroll
    for (int i = 0; i < RT_D / 4; ++i) {
      const float4 x = vr[i];
      vv[4 * i] = x.x;
      vv[4 * i + 1] = x.y;
      vv[4 * i + 2] = x.z;
      vv[4 * i + 3] = x.w;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      l[r] += p[r][j];
#pragma unroll
      for (int d = 0; d < RT_D; ++d) acc[r][d] = fmaf(p[r][j], vv[d], acc[r][d]);
    }
#else
#pragma unroll
    for (int r = 0; r < R; ++r) {
      l[r] += p[r][j];
#pragma unroll
      for (int d = 0; d < RT_D; ++d) acc[r][d] += p[r][j];
    }
#endif
  }
}

// Stage keys c0 .. c0 + n - 1 of one graph-head: k and v rows of RT_D floats
// (zero past hd and past n), and the bias of each of the RT_CHUNK slots.
__device__ __forceinline__ void stage_chunk(int vec, int hd, float neg2, const float* k_bh,
                                            const float* v_bh, const uint8_t* mask_b, int c0,
                                            int n, float* sk, float* sv, float* sbias) {
#ifdef K4_ABLATE_LOADS
  for (int i = threadIdx.x; i < RT_CHUNK * RT_D; i += RT_THREADS) {
    sk[i] = 0.f;
    sv[i] = 0.f;
  }
  for (int j = threadIdx.x; j < RT_CHUNK; j += RT_THREADS) sbias[j] = j < n ? 0.f : -INFINITY;
  return;
#endif
  if (vec) {
    const float4* k4 = reinterpret_cast<const float4*>(k_bh + (int64_t)c0 * RT_D);
    const float4* v4 = reinterpret_cast<const float4*>(v_bh + (int64_t)c0 * RT_D);
    float4* sk4 = reinterpret_cast<float4*>(sk);
    float4* sv4 = reinterpret_cast<float4*>(sv);
    const int have = n * (RT_D / 4);
    for (int i = threadIdx.x; i < have; i += RT_THREADS) {
      sk4[i] = k4[i];
      sv4[i] = v4[i];
    }
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = have + threadIdx.x; i < RT_CHUNK * (RT_D / 4); i += RT_THREADS) {
      sk4[i] = zero;
      sv4[i] = zero;
    }
  } else {
    for (int i = threadIdx.x; i < RT_CHUNK * RT_D; i += RT_THREADS) {
      const int j = i / RT_D, d = i % RT_D;
      const bool in = j < n && d < hd;
      const int64_t at = (int64_t)(c0 + j) * hd + d;
      sk[i] = in ? k_bh[at] : 0.f;
      sv[i] = in ? v_bh[at] : 0.f;
    }
  }
  for (int j = threadIdx.x; j < RT_CHUNK; j += RT_THREADS) {
    sbias[j] = j >= n ? -INFINITY : (mask_b && mask_b[c0 + j] ? neg2 : 0.f);
  }
}

// exp2(x - mx) for x <= mx, and 1 where both are -inf (partials that saw no
// key: their l and acc are 0)
__device__ __forceinline__ float weight_of(float x, float mx) {
  return x == mx ? 1.f : exp2f(x - mx);
}

// Merge `count` partials (m, l, acc) of one row that other blocks wrote
// (read through L2), in order, into m, l and acc: the largest m first, then
// each partial weighted by exp2(m_t - max). The partial of index t lies at
// base[t * tstride + f * fstride] for field f.
__device__ __forceinline__ void merge_partials(const float* base, int count, int tstride,
                                               int fstride, float& m, float& l,
                                               float (&acc)[RT_D]) {
  float mx = -INFINITY;
  for (int t = 0; t < count; ++t) mx = fmaxf(mx, __ldcg(base + t * tstride));
  float lt = 0.f, at[RT_D];
#pragma unroll
  for (int d = 0; d < RT_D; ++d) at[d] = 0.f;
  for (int t = 0; t < count; ++t) {
    const float* pt = base + t * tstride;
    const float c = weight_of(__ldcg(pt), mx);   // 0 for a split that saw no key
    lt = fmaf(__ldcg(pt + fstride), c, lt);
#pragma unroll
    for (int d = 0; d < RT_D; ++d) at[d] = fmaf(__ldcg(pt + (2 + d) * fstride), c, at[d]);
  }
  m = mx;
  l = lt;
#pragma unroll
  for (int d = 0; d < RT_D; ++d) acc[d] = at[d];
}

template <int R, int KS, int MINB>
__global__ void __launch_bounds__(RT_THREADS, MINB)
masked_mha_rows_kernel(const RowsArgs a) {
  constexpr int ROWS = 32 * R;                          // query rows a warp
  constexpr int STAGE = 2 * RT_CHUNK * RT_D;
  constexpr int MERGE = (RT_WARPS - 1) * ROWS * RT_F;   // splits 1.. of every row group
  constexpr int SMEM = STAGE > MERGE ? STAGE : MERGE;
  static_assert(RT_CHUNK % (RT_WARPS * KS) == 0 && KS % 4 == 0, "steps tile a split's keys");
  __shared__ __align__(16) float smem[SMEM];
  __shared__ __align__(16) float sbias[RT_CHUNK];
  __shared__ int s_flag;                       // a flag for the block
  float* sk = smem;
  float* sv = smem + RT_CHUNK * RT_D;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = warp % a.s_in;                  // key split inside the block
  const int g = warp / a.s_in;                  // row group
  const int groups = RT_WARPS / a.s_in;         // row groups a block
  const int tile = blockIdx.x, bh = blockIdx.y, z = blockIdx.z;
  const int row0 = (tile * groups + g) * ROWS + lane;   // row r is row0 + 32 r

  float qr[R][RT_D], acc[R][RT_D], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + 32 * r;
    const bool active = row < a.Lq;
    const float* q_row = a.q + ((int64_t)bh * a.Lq + (active ? row : 0)) * a.hd;
    if (a.vec) {
#pragma unroll
      for (int i = 0; i < RT_D / 4; ++i) {
        const float4 x = active ? reinterpret_cast<const float4*>(q_row)[i]
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        qr[r][4 * i] = x.x;
        qr[r][4 * i + 1] = x.y;
        qr[r][4 * i + 2] = x.z;
        qr[r][4 * i + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int d = 0; d < RT_D; ++d) qr[r][d] = active && d < a.hd ? q_row[d] : 0.f;
    }
#pragma unroll
    for (int d = 0; d < RT_D; ++d) acc[r][d] = 0.f;
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  // this block's keys, walked a chunk at a time; split s of the block takes
  // its own stretch of each chunk, a whole number of steps long
  const int per_block = (a.Lk + a.s_out - 1) / a.s_out;
  const int kb0 = min(a.Lk, z * per_block), kb1 = min(a.Lk, kb0 + per_block);
  const float* k_bh = a.k + (int64_t)bh * a.Lk * a.hd;
  const float* v_bh = a.v + (int64_t)bh * a.Lk * a.hd;
  const uint8_t* mask_b = a.mask ? a.mask + (int64_t)(bh / a.H) * a.Lk : nullptr;
  // whether the graph has a real key (then steps of masked keys alone are
  // skipped; a fully masked graph averages v over all of them)
  bool skip_masked = false;
  if (mask_b) {
    if (threadIdx.x == 0) s_flag = 0;
    __syncthreads();
    bool real = false;
    for (int j = threadIdx.x; j < a.Lk && !real; j += RT_THREADS) real = !mask_b[j];
    if (real) s_flag = 1;
    __syncthreads();
    skip_masked = s_flag;
  }
  for (int c0 = kb0; c0 < kb1; c0 += RT_CHUNK) {
    const int n = min(RT_CHUNK, kb1 - c0);
    __syncthreads();                            // the previous chunk is consumed
    stage_chunk(a.vec, a.hd, a.neg2, k_bh, v_bh, mask_b, c0, n, sk, sv, sbias);
    __syncthreads();
    const int per = ((n + a.s_in - 1) / a.s_in + KS - 1) / KS * KS;
    const int hi = min(n, (s + 1) * per);
    for (int j0 = s * per; j0 < hi; j0 += KS) softmax_step<R, KS>(sk, sv, sbias, j0, skip_masked, qr, acc, m, l, a.scale2);
  }

  // splits 1.. of each row group hand their rows to split 0 through shared
  // memory ([slot][field][row], a row a lane); split 0 merges in split order
  if (a.s_in > 1) {
    __syncthreads();
    if (s > 0) {
      float* slot = smem + ((s - 1) * groups + g) * ROWS * RT_F;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int at = 32 * r + lane;
        slot[at] = m[r];
        slot[ROWS + at] = l[r];
#pragma unroll
        for (int d = 0; d < RT_D; ++d) slot[(2 + d) * ROWS + at] = acc[r][d];
      }
    }
    __syncthreads();
    if (s == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // split 0's own partial first, then the slots in order
        const int at = 32 * r + lane;
        float mx = m[r];
        for (int t = 1; t < a.s_in; ++t) mx = fmaxf(mx, smem[((t - 1) * groups + g) * ROWS * RT_F + at]);
        const float c0 = weight_of(m[r], mx);
        float lt = l[r] * c0;
#pragma unroll
        for (int d = 0; d < RT_D; ++d) acc[r][d] *= c0;
        for (int t = 1; t < a.s_in; ++t) {
          const float* slot = smem + ((t - 1) * groups + g) * ROWS * RT_F;
          const float c = weight_of(slot[at], mx);
          lt = fmaf(slot[ROWS + at], c, lt);
#pragma unroll
          for (int d = 0; d < RT_D; ++d) acc[r][d] = fmaf(slot[(2 + d) * ROWS + at], c, acc[r][d]);
        }
        m[r] = mx;
        l[r] = lt;
      }
    }
  }

  if (a.s_out > 1) {
    // each block of the tile writes its partial; the last one merges
    const int rows_block = groups * ROWS;
    const int64_t tile_id = (int64_t)bh * a.tiles + tile;
    float* tile_base = a.partial + tile_id * a.s_out * RT_F * rows_block;
    if (s == 0) {
      float* mine = tile_base + (int64_t)z * RT_F * rows_block;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int at = g * ROWS + 32 * r + lane;
        mine[at] = m[r];
        mine[rows_block + at] = l[r];
#pragma unroll
        for (int d = 0; d < RT_D; ++d) mine[(2 + d) * rows_block + at] = acc[r][d];
      }
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) s_flag = atomicAdd(a.counters + tile_id, 1) == a.s_out - 1;
    __syncthreads();
    if (!s_flag) return;
    __threadfence();
    if (threadIdx.x == 0) a.counters[tile_id] = 0;      // ready for the next launch
    if (s == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        merge_partials(tile_base + g * ROWS + 32 * r + lane, a.s_out, RT_F * rows_block,
                             rows_block, m[r], l[r], acc[r]);
      }
    }
  }

  if (s != 0) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + 32 * r;
    if (row >= a.Lq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    float* out_row = a.out + ((int64_t)bh * a.Lq + row) * a.hd;
    if (a.vec) {
#pragma unroll
      for (int i = 0; i < RT_D / 4; ++i) {
        reinterpret_cast<float4*>(out_row)[i] =
            make_float4(acc[r][4 * i] * inv, acc[r][4 * i + 1] * inv, acc[r][4 * i + 2] * inv,
                        acc[r][4 * i + 3] * inv);
      }
    } else {
#pragma unroll
      for (int d = 0; d < RT_D; ++d) {
        if (d < a.hd) out_row[d] = acc[r][d] * inv;
      }
    }
  }
}

// The instances of masked_mha_rows_kernel<R, KS, MINB> that the launcher
// has: query rows a lane, keys a softmax step, blocks an SM that the
// registers must allow (__launch_bounds__). scripts/k4_times.py builds
// others (-D) to time them against this one.
#ifndef K4_ROWS_INSTANCES
#define K4_ROWS_INSTANCES(X) X(2, 8, 4)
#endif

// The arguments of masked_mha_rows_kernel, launched on (query tiles,
// graph-heads, s_out) blocks of RT_THREADS threads.
RowsArgs rows_args(const void* q, const void* k, const void* v, const void* mask, void* out,
                   void* partial, void* counters, int H, int Lq, int Lk, int hd, float scale,
                   int R, int s_in, int s_out) {
  RowsArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.mask = static_cast<const uint8_t*>(mask);
  a.out = static_cast<float*>(out);
  a.partial = static_cast<float*>(partial);
  a.counters = static_cast<int*>(counters);
  a.H = H;
  a.Lq = Lq;
  a.Lk = Lk;
  a.hd = hd;
  a.scale2 = (float)((double)scale * K4_LOG2E);
  a.neg2 = (float)((double)K4_NEG * K4_LOG2E);
  a.s_in = s_in;
  a.s_out = s_out;
  const int rows_block = 32 * R * (RT_WARPS / s_in);
  a.tiles = (Lq + rows_block - 1) / rows_block;
  const uintptr_t bits = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out;
  a.vec = hd == RT_D && (bits & 15) == 0;
  return a;
}

// ---- the wide kernel (hd 17..128) ----

constexpr int K4_DIMS = 16;          // head dims per lane
constexpr int K4_MAX_THREADS = 128;
constexpr int K4_STAGE = 2 * 129 * 32;  // floats of staged K and V (33 KB)

template <int G>
__global__ void __launch_bounds__(K4_MAX_THREADS)
masked_mha_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const uint8_t* __restrict__ mask,
                  float* __restrict__ out, int H, int Lq, int Lk, int hd, float scale,
                  int rows, int splits) {
  constexpr int HDP = K4_DIMS * G;             // head dims, padded
  constexpr int STRIDE = HDP + 1;              // staged row, against bank conflicts
  // keys per chunk: a multiple of 32, so of every split count
  constexpr int KC = K4_STAGE / (2 * STRIDE) / 32 * 32;
  static_assert(KC >= 32, "the stage holds at least 32 keys");
  __shared__ float stage[K4_STAGE];
  __shared__ uint8_t smask[KC];
  float* sk = stage;
  float* sv = stage + KC * STRIDE;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int g = threadIdx.x % G;
  const int s = (threadIdx.x / G) % splits;
  const int r = threadIdx.x / (G * splits);
  const int row = blockIdx.x * rows + r;
  const bool active = row < Lq;
  const int lane = threadIdx.x & 31;
  const unsigned group = ((1u << G) - 1u) << (lane & ~(G - 1));

  float qr[K4_DIMS], acc[K4_DIMS];
  const float* q_row = q + ((int64_t)bh * Lq + (active ? row : 0)) * hd;
#pragma unroll
  for (int i = 0; i < K4_DIMS; ++i) {
    const int d = g * K4_DIMS + i;
    qr[i] = active && d < hd ? q_row[d] : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const float* k_bh = k + (int64_t)bh * Lk * hd;
  const float* v_bh = v + (int64_t)bh * Lk * hd;
  const uint8_t* mask_b = mask ? mask + (int64_t)b * Lk : nullptr;

  for (int j0 = 0; j0 < Lk; j0 += KC) {
    const int n = min(KC, Lk - j0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < n * HDP; i += blockDim.x) {
      const int j = i / HDP;
      const int d = i - j * HDP;
      const int64_t at = (int64_t)(j0 + j) * hd + d;
      sk[j * STRIDE + d] = d < hd ? k_bh[at] : 0.f;
      sv[j * STRIDE + d] = d < hd ? v_bh[at] : 0.f;
    }
    for (int j = threadIdx.x; j < n; j += blockDim.x) smask[j] = mask_b ? mask_b[j0 + j] : 0;
    __syncthreads();
    if (!active) continue;
    // this group's keys: j0 + j with j = s mod splits (j0 is a multiple of splits)
    for (int j = s; j < n; j += splits) {
      const float* kr = sk + j * STRIDE + g * K4_DIMS;
      const float* vr = sv + j * STRIDE + g * K4_DIMS;
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < K4_DIMS; ++i) dot = fmaf(qr[i], kr[i], dot);
#pragma unroll
      for (int o = 1; o < G; o <<= 1) dot += __shfl_xor_sync(group, dot, o);
      const float sc = smask[j] ? K4_NEG : dot * scale;
      if (sc > m) {
        const float a = expf(m - sc);   // 0 at the first key (m = -inf)
        l = l * a + 1.f;
#pragma unroll
        for (int i = 0; i < K4_DIMS; ++i) acc[i] = acc[i] * a + vr[i];
        m = sc;
      } else {
        const float p = expf(sc - m);
        l += p;
#pragma unroll
        for (int i = 0; i < K4_DIMS; ++i) acc[i] += p * vr[i];
      }
    }
  }

  float* out_row = out + ((int64_t)bh * Lq + row) * hd;
  if (splits == 1) {
    if (active) {
      const float denom = fmaxf(l, 1e-30f);
#pragma unroll
      for (int i = 0; i < K4_DIMS; ++i) {
        const int d = g * K4_DIMS + i;
        if (d < hd) out_row[d] = acc[i] / denom;
      }
    }
    return;
  }
  // merge the splits of each row in split order, through the stage
  constexpr int SLOT = HDP + 2;                 // m, l, acc
  __syncthreads();
  float* mine = stage + (r * splits + s) * SLOT;
  if (g == 0) {
    mine[0] = m;
    mine[1] = l;
  }
#pragma unroll
  for (int i = 0; i < K4_DIMS; ++i) mine[2 + g * K4_DIMS + i] = acc[i];
  __syncthreads();
  if (!active || s != 0) return;
  const float* slots = stage + r * splits * SLOT;
  float mx = slots[0];
  for (int t = 1; t < splits; ++t) mx = fmaxf(mx, slots[t * SLOT]);
  float lt = 0.f, at[K4_DIMS];
#pragma unroll
  for (int i = 0; i < K4_DIMS; ++i) at[i] = 0.f;
  for (int t = 0; t < splits; ++t) {
    const float* st = slots + t * SLOT;
    const float a = expf(st[0] - mx);   // 0 for a split that saw no key
    lt += st[1] * a;
#pragma unroll
    for (int i = 0; i < K4_DIMS; ++i) at[i] += st[2 + g * K4_DIMS + i] * a;
  }
  const float denom = fmaxf(lt, 1e-30f);
#pragma unroll
  for (int i = 0; i < K4_DIMS; ++i) {
    const int d = g * K4_DIMS + i;
    if (d < hd) out_row[d] = at[i] / denom;
  }
}

}  // namespace

extern "C" {

// hd <= 16. q [BH, Lq, hd], k and v [BH, Lk, hd], out [BH, Lq, hd], all f32
// and contiguous; mask [BH / H, Lk] bool (1 = masked key) or null; Lk >= 1.
// (R, KS, MINB) one of K4_ROWS_INSTANCES; s_in in {1, 2, 4} key splits inside
// a block; s_out >= 1 blocks a query tile, and for s_out > 1 `partial` holds
// tiles x BH x s_out x 18 x (32 R 4 / s_in) floats and `counters` tiles x BH
// ints, all 0.
int k4_masked_mha_rows(const void* q, const void* k, const void* v, const void* mask,
                       void* out, void* partial, void* counters, int BH, int H, int Lq, int Lk,
                       int hd, float scale, int R, int KS, int MINB, int s_in, int s_out,
                       void* stream) {
  if (hd < 1 || hd > RT_D || Lk < 1 || (s_in != 1 && s_in != 2 && s_in != 4) || s_out < 1
      || (s_out > 1 && (!partial || !counters)))
    return (int)cudaErrorInvalidValue;
  const RowsArgs a = rows_args(q, k, v, mask, out, partial, counters, H, Lq, Lk, hd, scale, R,
                               s_in, s_out);
  const dim3 grid(a.tiles, BH, s_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K4_LAUNCH(R_, KS_, B_)                                                    \
  if (R == R_ && KS == KS_ && MINB == B_) {                                       \
    masked_mha_rows_kernel<R_, KS_, B_><<<grid, RT_THREADS, 0, st>>>(a);          \
    return (int)cudaGetLastError();                                               \
  }
  K4_ROWS_INSTANCES(K4_LAUNCH)
#undef K4_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Blocks of masked_mha_rows_kernel<R, KS, MINB> that fit on one SM of the
// current card (registers and shared memory), or -1 for an instance not built.
int k4_rows_blocks_per_sm(int R, int KS, int MINB) {
  int n = -1;
#define K4_OCCUPANCY(R_, KS_, B_)                                                 \
  if (R == R_ && KS == KS_ && MINB == B_)                                         \
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(                                \
        &n, masked_mha_rows_kernel<R_, KS_, B_>, RT_THREADS, 0);
  K4_ROWS_INSTANCES(K4_OCCUPANCY)
#undef K4_OCCUPANCY
  return n;
}

// hd 17..128: the same arrays, mask as above. hd <= 16 * G with G in {2, 4,
// 8}; rows * splits * G <= 128 threads a block; splits a power of two up to
// 32; Lk >= 1.
int k4_masked_mha_wide(const void* q, const void* k, const void* v, const void* mask, void* out,
                       int BH, int H, int Lq, int Lk, int hd, float scale, int G, int rows,
                       int splits, void* stream) {
  const dim3 grid((Lq + rows - 1) / rows, BH);
  const int threads = rows * splits * G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  float* of = static_cast<float*>(out);
  switch (G) {
    case 2: masked_mha_kernel<2><<<grid, threads, 0, st>>>(qf, kf, vf, mk, of, H, Lq, Lk, hd, scale, rows, splits); break;
    case 4: masked_mha_kernel<4><<<grid, threads, 0, st>>>(qf, kf, vf, mk, of, H, Lq, Lk, hd, scale, rows, splits); break;
    case 8: masked_mha_kernel<8><<<grid, threads, 0, st>>>(qf, kf, vf, mk, of, H, Lq, Lk, hd, scale, rows, splits); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
