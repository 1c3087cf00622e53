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
//     to the block, exists only for that tiling: this kernel walks exactly Lk
//     keys and needs none).
//     On this card the function is bound by f32 operations at the served
//     shapes (hd = 16: 4 operations per key and head dim against 8 bytes of k
//     and v that every query row of the block shares). Design, a simple first
//     version: one block per (graph x head, tile of `rows` query rows). G
//     neighbouring lanes own a query row, 16 head dims each, with the row's
//     q, running max, running sum and accumulator in registers; `splits`
//     such groups share a row and take every splits-th key, so that short
//     query tiles over long key ranges still fill the card. K, V and the mask
//     are staged through shared memory in chunks of KC keys that every group
//     of the block reads (broadcast reads; rows padded by one float against
//     bank conflicts). Per key the online softmax takes one accurate expf: a
//     new maximum rescales the sum and the accumulator, any other key adds
//     its weight. The groups of a row then merge in split order. Every sum
//     runs in a fixed order, so two runs give the same bits; the tiling is a
//     function of the shapes alone.
//
// Plain C interface, loaded with ctypes (caster_dta_torch/ops/cuda_attention.py).
// The entry point launches on the caller's stream and returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int K4_DIMS = 16;          // head dims per lane
constexpr int K4_MAX_THREADS = 128;
constexpr int K4_STAGE = 2 * 129 * 32;  // floats of staged K and V (33 KB)
constexpr float K4_NEG = -1e9f;

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
  const unsigned group = G == 1 ? 1u << lane : ((1u << G) - 1u) << (lane & ~(G - 1));

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

// q [BH, Lq, hd], k and v [BH, Lk, hd], out [BH, Lq, hd], all f32 and
// contiguous; mask [BH / H, Lk] bool (1 = masked key) or null. hd <= 16 * G
// with G in {1, 2, 4, 8}; rows * splits * G <= 128 threads a block; splits a
// power of two up to 32; Lk >= 1.
int k4_masked_mha(const void* q, const void* k, const void* v, const void* mask, void* out,
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
    case 1: masked_mha_kernel<1><<<grid, threads, 0, st>>>(qf, kf, vf, mk, of, H, Lq, Lk, hd, scale, rows, splits); break;
    case 2: masked_mha_kernel<2><<<grid, threads, 0, st>>>(qf, kf, vf, mk, of, H, Lq, Lk, hd, scale, rows, splits); break;
    case 4: masked_mha_kernel<4><<<grid, threads, 0, st>>>(qf, kf, vf, mk, of, H, Lq, Lk, hd, scale, rows, splits); break;
    case 8: masked_mha_kernel<8><<<grid, threads, 0, st>>>(qf, kf, vf, mk, of, H, Lq, Lk, hd, scale, rows, splits); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
