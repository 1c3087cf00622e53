// The fused GVP message MLP of GVPConv (K5, forward and backward) and the
// copy-cast of its node table (K6), for Hopper (sm_90a).
//
// K5 fwd  k5_message_fwd: for every edge r = (b, e) of a padded batch, the
//     n-layer gated GVP message MLP over cat((s_j, v_j), (es, ev), (s_i, v_i)).
//     Row e of both[b] is the source node's merged (s, v) row and row E + e
//     the destination's; vectors are interleaved (channel * 3 + xyz), as
//     merge_sv leaves them. Each layer computes
//         vh = Wh v;  vn = sqrt(max(|vh|^2, 1e-8));  spre = Ws [s, vn] + bs;
//         vraw = Wv vh;  z = Wsv act_v(spre) + bsv;
//         s' = act_s(spre);  v' = vraw * sigmoid(z),
//     and the last layer's activations are (none, none). Every product
//     rounds both operands to the compute dtype (f32 or bf16) and sums in
//     f32; biases and elementwise math stay f32; s' and v' are rounded to the
//     compute dtype between layers. Every edge is computed, padding included
//     (the aggregation that follows masks it). The output row is [s', v'] in
//     the dtype of `both`.
//     Replaces caster_dta_tpu/ops/pallas_gvp_message.py::_fwd_kernel.
// K5 bwd  k5_message_bwd: recomputes the forward of a tile of edges keeping
//     every layer's activations, then runs the layers backwards (the JAX
//     _layer_bwd, with its rounding points) and writes d(both) as one
//     [B, 2E, F] tensor (source rows, then destination rows), d(es) and d(ev)
//     in their inputs' dtypes, and each weight's gradient summed over all
//     edges in f32. Replaces ::_bwd_kernel.
// K6  k6_cast_copy: y = x, copied, cast between f32 and bf16 or not at all.
//     Replaces ::_cast_kernel (reached through layout_pin).
//
// What bounds them on the H100, and the design. At the served model's widths
// K5 fwd reads ~476 bytes and does ~5 kflop per edge, and K5 bwd moves ~840
// bytes and does ~10 kflop: both under the f32 ridge of 67e12 / 3.35e12 = 20
// flop per byte, so the least time is the bytes' time. The products are
// tiny (K <= 73, N <= 16), far below what wgmma takes, so this first version
// keeps them out of device memory instead: one block per tile of edges
// stages the packed weights (rounded to the compute dtype) and the tile's
// activations in shared memory as f32, column-major with an odd stride, so a
// warp reads 32 edges of one column without bank conflicts while the weight
// it multiplies is broadcast. Each stage of a layer is a flat loop of the
// block's threads over (edge, output) pairs, each summing its inputs in a
// fixed order; stages are separated by __syncthreads. What limits it is the
// shared-memory traffic of these scalar products (two reads per FMA), not
// device memory.
//
// The weight gradients need a sum over every edge. As in K1-K3 there are no
// atomics: a backward block takes BWD_TILES_PER_BLOCK consecutive tiles in
// order, sums each weight's terms over a tile's edges in edge order, adds the
// tile's sums to a per-block accumulator in shared memory, and writes it to
// row blockIdx.x of a [n_blocks, n_weights] f32 scratch. A second launch sums
// the rows in a fixed order. Two runs give the same bits.
//
// Plain C interface, loaded with ctypes (caster_dta_torch/ops/cuda_gvp_message.py).
// Every entry point launches on the caller's stream and returns
// cudaGetLastError() after its launches (or cudaErrorInvalidValue for
// arguments it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int FWD_TILE = 64;               // edges per forward block
constexpr int BWD_TILE = 32;               // edges per backward tile
constexpr int BWD_TILES_PER_BLOCK = 8;     // consecutive tiles per backward block
constexpr int MAX_SMEM = 232448;           // 227 KB, the most a block can have
constexpr int REDUCE_COLS = 32;            // weights per reduce block
constexpr int REDUCE_SEGS = 8;             // row segments per reduce block
constexpr int K6_THREADS = 256;
constexpr int K6_MAX_BLOCKS = 132 * 16;
constexpr float EPS = 1e-8f;

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_SIGMOID = 2 };

// ns, nv: node scalar and vector channels; se, ve: edge scalar and vector
// channels; dims: (h, so, vo) of each layer.
struct Shape {
  int n_layers, ns, nv, se, ve;
};

struct Layer {
  int si, vi, h, so, vo;
  int w_off;   // the layer's first entry in the packed weights
  int c_off;   // backward: the layer's first cached column
};

// A layer's packed weights, in the layout of the port's Dense weights
// ([out, in]): wh [h, vi], ws [so, si + h], bs [so], wv [vo, h],
// wsv [vo, so], bsv [vo].
__host__ __device__ inline int n_weights(const Layer& L) {
  return L.h * L.vi + L.so * (L.si + L.h) + L.so + L.vo * L.h + L.vo * L.so + L.vo;
}

// Columns the backward keeps per edge for a layer: its inputs s [si] and
// v [3vi], vh [3h], |vh|^2 [h], vn [h], spre [so], vraw [3vo], the gate [vo].
__host__ __device__ inline int cache_cols(const Layer& L) {
  return L.si + 3 * L.vi + 5 * L.h + L.so + 4 * L.vo;
}

__host__ __device__ inline Layer layer_at(const int* dims, const Shape& sh, int k) {
  Layer L;
  L.si = 2 * sh.ns + sh.se;
  L.vi = 2 * sh.nv + sh.ve;
  L.w_off = 0;
  L.c_off = 0;
  for (int j = 0;; ++j) {
    L.h = dims[3 * j];
    L.so = dims[3 * j + 1];
    L.vo = dims[3 * j + 2];
    if (j == k) return L;
    L.w_off += n_weights(L);
    L.c_off += cache_cols(L);
    L.si = L.so;
    L.vi = L.vo;
  }
}

// The widest of each buffer over the layers, in columns per edge.
struct Widths {
  int xs, xv, h, so, vo, d, cache, n_w;
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline Widths widths(const int* dims, const Shape& sh) {
  Widths w = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int k = 0; k < sh.n_layers; ++k) {
    const Layer L = layer_at(dims, sh, k);
    w.xs = imax(w.xs, imax(L.si, L.so));
    w.xv = imax(w.xv, imax(L.vi, L.vo));
    w.h = imax(w.h, L.h);
    w.so = imax(w.so, L.so);
    w.vo = imax(w.vo, L.vo);
    w.d = imax(w.d, imax(L.si + 3 * L.vi, L.so + 3 * L.vo));
    w.cache += cache_cols(L);
    w.n_w += n_weights(L);
  }
  return w;
}

__host__ __device__ inline int fwd_cols(const Widths& w) {
  return w.xs + 3 * w.xv + 4 * w.h + w.so + 4 * w.vo;
}

__host__ __device__ inline int bwd_cols(const Widths& w) {
  return w.cache + 2 * w.d + w.so + 4 * w.vo + 4 * w.h;
}

__host__ inline int64_t fwd_smem(const Widths& w) {
  return 4 * ((int64_t)w.n_w + (int64_t)(FWD_TILE + 1) * fwd_cols(w));
}

__host__ inline int64_t bwd_smem(const Widths& w) {
  return 4 * (2 * (int64_t)w.n_w + (int64_t)(BWD_TILE + 1) * bwd_cols(w));
}

template <bool BF>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float act(int a, float x) {
  return a == ACT_RELU ? fmaxf(x, 0.f) : a == ACT_SIGMOID ? sigmoid(x) : x;
}

// derivative at the pre-activation x; relu's is (x > 0), as in the JAX _dact
__device__ __forceinline__ float dact(int a, float x) {
  if (a == ACT_RELU) return x > 0.f ? 1.f : 0.f;
  if (a == ACT_SIGMOID) {
    const float s = sigmoid(x);
    return s * (1.f - s);
  }
  return 1.f;
}

__device__ __forceinline__ float load(const void* p, int64_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store(void* p, int64_t i, float x, int bf16) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  } else {
    static_cast<float*>(p)[i] = x;
  }
}

struct Inputs {
  const void* both;   // [B, 2E, ns + 3nv]
  const void* es;     // [B, E, se]
  const void* ev;     // [B, E, 3ve]
  int both_bf16, es_bf16, ev_bf16;
  int64_t R;          // B * E
  int E;
};

// Stage every layer's weights in shared memory, the matrices rounded to the
// compute dtype (each product rounds its operands), the biases not.
template <bool BF>
__device__ void stage_weights(const float* __restrict__ w, const int* dims, const Shape& sh,
                              float* W) {
  for (int k = 0; k < sh.n_layers; ++k) {
    const Layer L = layer_at(dims, sh, k);
    const int bs0 = L.h * L.vi + L.so * (L.si + L.h);
    const int bsv0 = bs0 + L.so + L.vo * L.h + L.vo * L.so;
    const int nk = bsv0 + L.vo;
    for (int i = threadIdx.x; i < nk; i += blockDim.x) {
      const bool bias = (i >= bs0 && i < bs0 + L.so) || i >= bsv0;
      const float x = w[L.w_off + i];
      W[L.w_off + i] = bias ? x : rnd<BF>(x);
    }
  }
}

// The first layer's inputs of the tile's edges r0 .. r0 + n - 1, rounded to
// the compute dtype: xs [si][S] = (s_j, es, s_i), xv [3vi][S] = (v_j, ev, v_i).
// Threads walk a row's columns, so neighbouring threads read neighbouring
// addresses; columns past n are zero.
template <bool BF, int T>
__device__ void assemble(const Inputs& in, const Shape& sh, int64_t r0, int n, float* xs,
                         float* xv) {
  constexpr int S = T + 1;
  const int fb = sh.ns + 3 * sh.nv;
  const int si = 2 * sh.ns + sh.se;
  const int v3 = 3 * sh.nv, e3 = 3 * sh.ve;
  const int vi3 = 2 * v3 + e3;
  const int64_t two_e = 2 * (int64_t)in.E;
  for (int p = threadIdx.x; p < T * si; p += blockDim.x) {
    const int e = p / si, k = p - e * si;
    float x = 0.f;
    if (e < n) {
      const int64_t r = r0 + e, b = r / in.E, j = r - b * in.E;
      if (k < sh.ns) {
        x = load(in.both, (b * two_e + j) * fb + k, in.both_bf16);
      } else if (k < sh.ns + sh.se) {
        x = load(in.es, r * sh.se + (k - sh.ns), in.es_bf16);
      } else {
        x = load(in.both, (b * two_e + in.E + j) * fb + (k - sh.ns - sh.se), in.both_bf16);
      }
    }
    xs[k * S + e] = rnd<BF>(x);
  }
  for (int p = threadIdx.x; p < T * vi3; p += blockDim.x) {
    const int e = p / vi3, k = p - e * vi3;
    float x = 0.f;
    if (e < n) {
      const int64_t r = r0 + e, b = r / in.E, j = r - b * in.E;
      if (k < v3) {
        x = load(in.both, (b * two_e + j) * fb + sh.ns + k, in.both_bf16);
      } else if (k < v3 + e3) {
        x = load(in.ev, r * e3 + (k - v3), in.ev_bf16);
      } else {
        x = load(in.both, (b * two_e + in.E + j) * fb + sh.ns + (k - v3 - e3), in.both_bf16);
      }
    }
    xv[k * S + e] = rnd<BF>(x);
  }
}

// One gated GVP layer on the tile (the JAX _layer_fwd). xs, xv hold the
// layer's rounded inputs; vh, q (may be null), vn, sp, vr, g receive its
// activations; xs_next, xv_next (null: skip) the rounded outputs. Buffers
// are [columns][S]; every thread of the block calls it.
template <bool BF, int T>
__device__ void layer_fwd(const float* W, const Layer& L, int act_s, int act_v, const float* xs,
                          const float* xv, float* vh, float* q, float* vn, float* sp, float* vr,
                          float* g, float* xs_next, float* xv_next) {
  constexpr int S = T + 1;
  const float* wh = W + L.w_off;
  const float* ws = wh + L.h * L.vi;
  const float* bs = ws + L.so * (L.si + L.h);
  const float* wv = bs + L.so;
  const float* wsv = wv + L.vo * L.h;
  const float* bsv = wsv + L.vo * L.so;
  const int tid = threadIdx.x, nt = blockDim.x;

  // vh[j, d] = sum_i v[i, d] wh[j, i]
  for (int p = tid; p < T * 3 * L.h; p += nt) {
    const int c = p / T, e = p - c * T;
    const int j = c / 3, d = c - 3 * j;
    const float* w = wh + j * L.vi;
    float acc = 0.f;
    for (int i = 0; i < L.vi; ++i) acc += xv[(3 * i + d) * S + e] * w[i];
    vh[c * S + e] = acc;
  }
  __syncthreads();
  // the clamped norm over xyz
  for (int p = tid; p < T * L.h; p += nt) {
    const int j = p / T, e = p - j * T;
    const float x = vh[(3 * j) * S + e], y = vh[(3 * j + 1) * S + e], z = vh[(3 * j + 2) * S + e];
    const float qq = x * x + y * y + z * z;
    if (q != nullptr) q[j * S + e] = qq;
    vn[j * S + e] = sqrtf(fmaxf(qq, EPS));
  }
  __syncthreads();
  // spre = ws [s, vn] + bs, and vraw[o, d] = sum_j vh[j, d] wv[o, j]
  const int n_sp = T * L.so;
  for (int p = tid; p < n_sp + T * 3 * L.vo; p += nt) {
    if (p < n_sp) {
      const int o = p / T, e = p - o * T;
      const float* w = ws + o * (L.si + L.h);
      float acc = 0.f;
      for (int k = 0; k < L.si; ++k) acc += xs[k * S + e] * w[k];
      for (int k = 0; k < L.h; ++k) acc += rnd<BF>(vn[k * S + e]) * w[L.si + k];
      sp[o * S + e] = acc + bs[o];
    } else {
      const int pp = p - n_sp;
      const int c = pp / T, e = pp - c * T;
      const int o = c / 3, d = c - 3 * o;
      const float* w = wv + o * L.h;
      float acc = 0.f;
      for (int j = 0; j < L.h; ++j) acc += rnd<BF>(vh[(3 * j + d) * S + e]) * w[j];
      vr[c * S + e] = acc;
    }
  }
  __syncthreads();
  // the gate reads the pre-activation scalars through the vector activation
  for (int p = tid; p < T * L.vo; p += nt) {
    const int o = p / T, e = p - o * T;
    const float* w = wsv + o * L.so;
    float acc = 0.f;
    for (int i = 0; i < L.so; ++i) acc += rnd<BF>(act(act_v, sp[i * S + e])) * w[i];
    g[o * S + e] = sigmoid(acc + bsv[o]);
  }
  __syncthreads();
  if (xs_next == nullptr) return;
  for (int p = tid; p < T * (L.so + 3 * L.vo); p += nt) {
    const int c = p / T, e = p - c * T;
    if (c < L.so) {
      xs_next[c * S + e] = rnd<BF>(act(act_s, sp[c * S + e]));
    } else {
      const int cv = c - L.so;
      xv_next[cv * S + e] = rnd<BF>(vr[cv * S + e] * g[(cv / 3) * S + e]);
    }
  }
  __syncthreads();
}

// The backward of one layer on the tile (the JAX _layer_bwd). da holds the
// cotangent of the layer's output (ds [so], dv [3vo]); db receives that of
// its input (ds [si], dv [3vi]). The weight gradients of the tile's first n
// edges are summed in edge order and added to acc.
template <bool BF, int T>
__device__ void layer_bwd(const float* W, float* acc, const Layer& L, int act_s, int act_v,
                          const float* xs, const float* xv, const float* vh, const float* q,
                          const float* vn, const float* sp, const float* vr, const float* g,
                          const float* da, float* db, float* dsp, float* dvr, float* dz,
                          float* dvh, float* dvn, int n) {
  constexpr int S = T + 1;
  const float* wh = W + L.w_off;
  const float* ws = wh + L.h * L.vi;
  const float* wv = ws + L.so * (L.si + L.h) + L.so;
  const float* wsv = wv + L.vo * L.h;
  float* gwh = acc + L.w_off;
  float* gws = gwh + L.h * L.vi;
  float* gbs = gws + L.so * (L.si + L.h);
  float* gwv = gbs + L.so;
  float* gwsv = gwv + L.vo * L.h;
  float* gbsv = gwsv + L.vo * L.so;
  const float* ds_out = da;
  const float* dv_out = da + L.so * S;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int sh_ = L.si + L.h;

  // the gate: dvraw = dv * g, dz = (dv . vraw) g (1 - g)
  for (int p = tid; p < T * L.vo; p += nt) {
    const int o = p / T, e = p - o * T;
    const float gg = g[o * S + e];
    float dg = 0.f;
    for (int d = 0; d < 3; ++d) {
      const int c = (3 * o + d) * S + e;
      dg += dv_out[c] * vr[c];
      dvr[c] = dv_out[c] * gg;
    }
    dz[o * S + e] = dg * gg * (1.f - gg);
  }
  __syncthreads();
  // dspre = ds act_s'(spre) + (Wsv^T dz) act_v'(spre); dvh = Wv^T dvraw;
  // the gradients of wsv, bsv and wv
  {
    const int n1 = T * L.so, n2 = n1 + T * 3 * L.h, n3 = n2 + L.vo * L.so, n4 = n3 + L.vo;
    const int n5 = n4 + L.vo * L.h;
    for (int p = tid; p < n5; p += nt) {
      if (p < n1) {
        const int i = p / T, e = p - i * T;
        float dgi = 0.f;
        for (int o = 0; o < L.vo; ++o) dgi += rnd<BF>(dz[o * S + e]) * wsv[o * L.so + i];
        const float x = sp[i * S + e];
        dsp[i * S + e] = ds_out[i * S + e] * dact(act_s, x) + dgi * dact(act_v, x);
      } else if (p < n2) {
        const int c = (p - n1) / T, e = (p - n1) - c * T;
        const int j = c / 3, d = c - 3 * j;
        float s = 0.f;
        for (int o = 0; o < L.vo; ++o) s += rnd<BF>(dvr[(3 * o + d) * S + e]) * wv[o * L.h + j];
        dvh[c * S + e] = s;
      } else if (p < n3) {
        const int idx = p - n2, o = idx / L.so, i = idx - o * L.so;
        float s = 0.f;
        for (int e = 0; e < n; ++e) {
          s += rnd<BF>(act(act_v, sp[i * S + e])) * rnd<BF>(dz[o * S + e]);
        }
        gwsv[idx] += s;
      } else if (p < n4) {
        const int o = p - n3;
        float s = 0.f;
        for (int e = 0; e < n; ++e) s += dz[o * S + e];
        gbsv[o] += s;
      } else {
        const int idx = p - n4, o = idx / L.h, j = idx - o * L.h;
        float s = 0.f;
        for (int e = 0; e < n; ++e) {
          for (int d = 0; d < 3; ++d) {
            s += rnd<BF>(vh[(3 * j + d) * S + e]) * rnd<BF>(dvr[(3 * o + d) * S + e]);
          }
        }
        gwv[idx] += s;
      }
    }
  }
  __syncthreads();
  // dsin = Ws^T dspre: ds into db, dvn; the gradients of ws and bs
  {
    const int n1 = T * sh_, n2 = n1 + L.so * sh_, n3 = n2 + L.so;
    for (int p = tid; p < n3; p += nt) {
      if (p < n1) {
        const int k = p / T, e = p - k * T;
        float s = 0.f;
        for (int o = 0; o < L.so; ++o) s += rnd<BF>(dsp[o * S + e]) * ws[o * sh_ + k];
        if (k < L.si) {
          db[k * S + e] = s;
        } else {
          dvn[(k - L.si) * S + e] = s;
        }
      } else if (p < n2) {
        const int idx = p - n1, o = idx / sh_, k = idx - o * sh_;
        const float* a = k < L.si ? xs + k * S : vn + (k - L.si) * S;
        float s = 0.f;
        for (int e = 0; e < n; ++e) s += rnd<BF>(a[e]) * rnd<BF>(dsp[o * S + e]);
        gws[idx] += s;
      } else {
        const int o = p - n2;
        float s = 0.f;
        for (int e = 0; e < n; ++e) s += dsp[o * S + e];
        gbs[o] += s;
      }
    }
  }
  __syncthreads();
  // the norm: dvh += vh dvn / vn where |vh|^2 > eps (0 inside the clamp)
  for (int p = tid; p < T * 3 * L.h; p += nt) {
    const int c = p / T, e = p - c * T;
    const int j = c / 3;
    const float coef = q[j * S + e] > EPS ? dvn[j * S + e] / vn[j * S + e] : 0.f;
    dvh[c * S + e] += vh[c * S + e] * coef;
  }
  __syncthreads();
  // dv = Wh^T dvh into db after ds; the gradient of wh
  {
    const int n1 = T * 3 * L.vi, n2 = n1 + L.h * L.vi;
    for (int p = tid; p < n2; p += nt) {
      if (p < n1) {
        const int c = p / T, e = p - c * T;
        const int i = c / 3, d = c - 3 * i;
        float s = 0.f;
        for (int j = 0; j < L.h; ++j) s += rnd<BF>(dvh[(3 * j + d) * S + e]) * wh[j * L.vi + i];
        db[(L.si + c) * S + e] = s;
      } else {
        const int idx = p - n1, j = idx / L.vi, i = idx - j * L.vi;
        float s = 0.f;
        for (int e = 0; e < n; ++e) {
          for (int d = 0; d < 3; ++d) {
            s += xv[(3 * i + d) * S + e] * rnd<BF>(dvh[(3 * j + d) * S + e]);
          }
        }
        gwh[idx] += s;
      }
    }
  }
  __syncthreads();
}

template <bool BF>
__global__ void __launch_bounds__(THREADS)
message_fwd_kernel(Inputs in, Shape sh, const int* __restrict__ dims, const float* __restrict__ w,
                   int act_s, int act_v, void* __restrict__ out, int out_bf16) {
  constexpr int T = FWD_TILE, S = T + 1;
  extern __shared__ float smem[];
  const Widths wd = widths(dims, sh);
  float* W = smem;
  float* xs = W + wd.n_w;
  float* xv = xs + wd.xs * S;
  float* vh = xv + 3 * wd.xv * S;
  float* vn = vh + 3 * wd.h * S;
  float* sp = vn + wd.h * S;
  float* vr = sp + wd.so * S;
  float* g = vr + 3 * wd.vo * S;

  stage_weights<BF>(w, dims, sh, W);
  const int64_t r0 = (int64_t)blockIdx.x * T;
  const int n = (int)(in.R - r0 < T ? in.R - r0 : T);
  assemble<BF, T>(in, sh, r0, n, xs, xv);
  __syncthreads();
  Layer L;
  for (int k = 0; k < sh.n_layers; ++k) {
    L = layer_at(dims, sh, k);
    const bool last = k == sh.n_layers - 1;
    layer_fwd<BF, T>(W, L, last ? ACT_NONE : act_s, last ? ACT_NONE : act_v, xs, xv, vh,
                     nullptr, vn, sp, vr, g, xs, xv);
  }
  const int fo = L.so + 3 * L.vo;
  for (int p = threadIdx.x; p < n * fo; p += blockDim.x) {
    const int e = p / fo, c = p - e * fo;
    const float x = c < L.so ? xs[c * S + e] : xv[(c - L.so) * S + e];
    store(out, (r0 + e) * fo + c, x, out_bf16);
  }
}

template <bool BF>
__global__ void __launch_bounds__(THREADS)
message_bwd_kernel(Inputs in, Shape sh, const int* __restrict__ dims, const float* __restrict__ w,
                   int act_s, int act_v, const void* __restrict__ dout, int dout_bf16,
                   void* __restrict__ dboth, void* __restrict__ des, void* __restrict__ dev,
                   float* __restrict__ partial) {
  constexpr int T = BWD_TILE, S = T + 1;
  extern __shared__ float smem[];
  const Widths wd = widths(dims, sh);
  float* W = smem;
  float* acc = W + wd.n_w;
  float* cache = acc + wd.n_w;
  float* da = cache + wd.cache * S;
  float* db = da + wd.d * S;
  float* dsp = db + wd.d * S;
  float* dvr = dsp + wd.so * S;
  float* dz = dvr + 3 * wd.vo * S;
  float* dvh = dz + wd.vo * S;
  float* dvn = dvh + 3 * wd.h * S;

  stage_weights<BF>(w, dims, sh, W);
  for (int i = threadIdx.x; i < wd.n_w; i += blockDim.x) acc[i] = 0.f;
  const Layer first = layer_at(dims, sh, 0);
  const Layer last = layer_at(dims, sh, sh.n_layers - 1);
  const int fo = last.so + 3 * last.vo;
  const int fb = sh.ns + 3 * sh.nv;
  const int64_t n_tiles = (in.R + T - 1) / T;
  const int64_t t0 = (int64_t)blockIdx.x * BWD_TILES_PER_BLOCK;
  const int64_t t1 = t0 + BWD_TILES_PER_BLOCK < n_tiles ? t0 + BWD_TILES_PER_BLOCK : n_tiles;
  for (int64_t t = t0; t < t1; ++t) {
    const int64_t r0 = t * T;
    const int n = (int)(in.R - r0 < T ? in.R - r0 : T);
    assemble<BF, T>(in, sh, r0, n, cache, cache + first.si * S);
    for (int p = threadIdx.x; p < T * fo; p += blockDim.x) {
      const int e = p / fo, c = p - e * fo;
      da[c * S + e] = e < n ? load(dout, (r0 + e) * fo + c, dout_bf16) : 0.f;
    }
    __syncthreads();
    // the forward again, keeping every layer's activations
    for (int k = 0; k < sh.n_layers; ++k) {
      const Layer L = layer_at(dims, sh, k);
      const bool is_last = k == sh.n_layers - 1;
      float* xs = cache + L.c_off * S;
      float* xv = xs + L.si * S;
      float* vh = xv + 3 * L.vi * S;
      float* q = vh + 3 * L.h * S;
      float* vn = q + L.h * S;
      float* sp = vn + L.h * S;
      float* vr = sp + L.so * S;
      float* g = vr + 3 * L.vo * S;
      float* xs_next = nullptr;
      float* xv_next = nullptr;
      if (!is_last) {
        const Layer N = layer_at(dims, sh, k + 1);
        xs_next = cache + N.c_off * S;
        xv_next = xs_next + N.si * S;
      }
      layer_fwd<BF, T>(W, L, is_last ? ACT_NONE : act_s, is_last ? ACT_NONE : act_v, xs, xv, vh,
                       q, vn, sp, vr, g, xs_next, xv_next);
    }
    for (int k = sh.n_layers - 1; k >= 0; --k) {
      const Layer L = layer_at(dims, sh, k);
      const bool is_last = k == sh.n_layers - 1;
      const float* xs = cache + L.c_off * S;
      const float* xv = xs + L.si * S;
      const float* vh = xv + 3 * L.vi * S;
      const float* q = vh + 3 * L.h * S;
      const float* vn = q + L.h * S;
      const float* sp = vn + L.h * S;
      const float* vr = sp + L.so * S;
      const float* g = vr + 3 * L.vo * S;
      layer_bwd<BF, T>(W, acc, L, is_last ? ACT_NONE : act_s, is_last ? ACT_NONE : act_v, xs, xv,
                       vh, q, vn, sp, vr, g, da, db, dsp, dvr, dz, dvh, dvn, n);
      float* tmp = da;
      da = db;
      db = tmp;
    }
    // da: ds [si] = (ds_j, des, ds_i), then dv [3vi] = (dv_j, dev, dv_i)
    const int ds_i = sh.ns + sh.se;
    const int dv0 = first.si, dev0 = dv0 + 3 * sh.nv, dv_i = dev0 + 3 * sh.ve;
    for (int p = threadIdx.x; p < n * 2 * fb; p += blockDim.x) {
      const int e = p / (2 * fb), c = p - e * 2 * fb;
      const int64_t r = r0 + e, b = r / in.E, j = r - b * in.E;
      const bool src = c < fb;
      const int k = src ? c : c - fb;
      const int col = k < sh.ns ? (src ? k : ds_i + k) : (src ? dv0 : dv_i) + (k - sh.ns);
      const int64_t row = b * 2 * (int64_t)in.E + (src ? j : in.E + j);
      store(dboth, row * fb + k, da[col * S + e], in.both_bf16);
    }
    for (int p = threadIdx.x; p < n * sh.se; p += blockDim.x) {
      const int e = p / sh.se, c = p - e * sh.se;
      store(des, (r0 + e) * sh.se + c, da[(sh.ns + c) * S + e], in.es_bf16);
    }
    for (int p = threadIdx.x; p < n * 3 * sh.ve; p += blockDim.x) {
      const int e = p / (3 * sh.ve), c = p - e * 3 * sh.ve;
      store(dev, (r0 + e) * 3 * sh.ve + c, da[(dev0 + c) * S + e], in.ev_bf16);
    }
    __syncthreads();   // the next tile rewrites the caches and da
  }
  for (int i = threadIdx.x; i < wd.n_w; i += blockDim.x) {
    partial[(int64_t)blockIdx.x * wd.n_w + i] = acc[i];
  }
}

// out[w] = sum over rows r of partial[r, w], rows in order: REDUCE_SEGS
// fixed segments of rows summed in order, then the segments in order.
__global__ void __launch_bounds__(REDUCE_COLS * REDUCE_SEGS)
reduce_rows_kernel(const float* __restrict__ partial, float* __restrict__ out, int n_rows,
                   int n_w) {
  __shared__ float seg_sum[REDUCE_SEGS][REDUCE_COLS];
  const int col = blockIdx.x * REDUCE_COLS + threadIdx.x;
  const int seg = threadIdx.y;
  const int r0 = (int)((int64_t)n_rows * seg / REDUCE_SEGS);
  const int r1 = (int)((int64_t)n_rows * (seg + 1) / REDUCE_SEGS);
  float s = 0.f;
  if (col < n_w) {
    for (int r = r0; r < r1; ++r) s += partial[(int64_t)r * n_w + col];
  }
  seg_sum[seg][threadIdx.x] = s;
  __syncthreads();
  if (seg == 0 && col < n_w) {
    float t = 0.f;
    for (int k = 0; k < REDUCE_SEGS; ++k) t += seg_sum[k][threadIdx.x];
    out[col] = t;
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename TO> __device__ __forceinline__ TO from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(K6_THREADS)
cast_copy_kernel(const TI* __restrict__ x, TO* __restrict__ y, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    y[i] = from_f32<TO>(to_f32(x[i]));
  }
}

// same dtype: a copy of 16-byte words
__global__ void __launch_bounds__(K6_THREADS)
copy16_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) y[i] = x[i];
}

unsigned k6_blocks(int64_t n) {
  int64_t blocks = (n + K6_THREADS - 1) / K6_THREADS;
  return (unsigned)(blocks > K6_MAX_BLOCKS ? K6_MAX_BLOCKS : blocks);
}

template <typename TI, typename TO>
void launch_cast(const void* x, void* y, int64_t n, cudaStream_t s) {
  cast_copy_kernel<TI, TO><<<k6_blocks(n), K6_THREADS, 0, s>>>(static_cast<const TI*>(x),
                                                               static_cast<TO*>(y), n);
}

bool valid(const int* dims, const Shape& sh) {
  if (sh.n_layers < 1 || sh.ns < 0 || sh.nv < 1 || sh.se < 0 || sh.ve < 1) return false;
  for (int k = 0; k < sh.n_layers; ++k) {
    if (dims[3 * k] < 1 || dims[3 * k + 1] < 0 || dims[3 * k + 2] < 1) return false;
  }
  return true;
}

template <bool BF>
int launch_fwd(const Inputs& in, const Shape& sh, const int* dims_dev, const Widths& wd,
               const float* w, int act_s, int act_v, void* out, int out_bf16, cudaStream_t s) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        message_fwd_kernel<BF>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const int64_t blocks = (in.R + FWD_TILE - 1) / FWD_TILE;
  message_fwd_kernel<BF><<<(unsigned)blocks, THREADS, (size_t)fwd_smem(wd), s>>>(
      in, sh, dims_dev, w, act_s, act_v, out, out_bf16);
  return (int)cudaGetLastError();
}

int64_t bwd_block_count(int64_t R) {
  const int64_t tiles = (R + BWD_TILE - 1) / BWD_TILE;
  return (tiles + BWD_TILES_PER_BLOCK - 1) / BWD_TILES_PER_BLOCK;
}

template <bool BF>
int launch_bwd(const Inputs& in, const Shape& sh, const int* dims_dev, const Widths& wd,
               const float* w, int act_s, int act_v, const void* dout, int dout_bf16,
               void* dboth, void* des, void* dev, float* partial, float* dw, cudaStream_t s) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        message_bwd_kernel<BF>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const int64_t blocks = bwd_block_count(in.R);
  message_bwd_kernel<BF><<<(unsigned)blocks, THREADS, (size_t)bwd_smem(wd), s>>>(
      in, sh, dims_dev, w, act_s, act_v, dout, dout_bf16, dboth, des, dev, partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 block(REDUCE_COLS, REDUCE_SEGS);
  reduce_rows_kernel<<<(unsigned)((wd.n_w + REDUCE_COLS - 1) / REDUCE_COLS), block, 0, s>>>(
      partial, dw, (int)blocks, wd.n_w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of shared memory a block of K5 fwd (backward == 0) or K5 bwd
// (backward != 0) needs for this shape; -1 for a shape it does not take.
// dims: (h, so, vo) of each of the n_layers layers, on the host.
long long k5_smem_bytes(const int* dims, int n_layers, int ns, int nv, int se, int ve,
                        int backward) {
  const Shape sh = {n_layers, ns, nv, se, ve};
  if (!valid(dims, sh)) return -1;
  const Widths wd = widths(dims, sh);
  return backward ? bwd_smem(wd) : fwd_smem(wd);
}

// Rows of K5 bwd's weight-gradient scratch for R = B * E edges.
long long k5_bwd_blocks(long long R) { return bwd_block_count(R); }

// both [B, 2E, ns + 3nv], es [B, E, se], ev [B, E, 3ve] (each f32, or bf16
// where its flag is set), w the packed f32 weights (n_w entries, layer by
// layer: wh, ws, bs, wv, wsv, bsv, each [out, in]), dims the layers' (h, so,
// vo) once on the device and once on the host; out [B, E, so + 3vo] in the
// dtype of both. act_s, act_v: 0 none, 1 relu, 2 sigmoid for every layer but
// the last. cdt_bf16: the compute dtype is bf16 (else f32). All contiguous.
int k5_message_fwd(const void* both, const void* es, const void* ev, const float* w,
                   const int* dims_dev, const int* dims_host, void* out, int B, int E, int ns,
                   int nv, int se, int ve, int n_layers, int n_w, int act_s, int act_v,
                   int both_bf16, int es_bf16, int ev_bf16, int cdt_bf16, void* stream) {
  const Shape sh = {n_layers, ns, nv, se, ve};
  if (!valid(dims_host, sh) || B < 1 || E < 1) return (int)cudaErrorInvalidValue;
  const Widths wd = widths(dims_host, sh);
  if (wd.n_w != n_w || fwd_smem(wd) > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const Inputs in = {both, es, ev, both_bf16, es_bf16, ev_bf16, (int64_t)B * E, E};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cdt_bf16 ? launch_fwd<true>(in, sh, dims_dev, wd, w, act_s, act_v, out, both_bf16, s)
                  : launch_fwd<false>(in, sh, dims_dev, wd, w, act_s, act_v, out, both_bf16, s);
}

// The inputs as for k5_message_fwd, plus dout [B, E, so + 3vo] (f32, or bf16
// with dout_bf16). Writes dboth [B, 2E, ns + 3nv], des [B, E, se] and dev
// [B, E, 3ve] in the dtypes of both, es and ev, and dw [n_w] f32, the weight
// gradients packed as w. partial: f32 scratch of k5_bwd_blocks(B * E) rows of
// n_w. Two launches: the tiles, then the sum of their rows.
int k5_message_bwd(const void* both, const void* es, const void* ev, const float* w,
                   const int* dims_dev, const int* dims_host, const void* dout, void* dboth,
                   void* des, void* dev, float* partial, float* dw, int B, int E, int ns, int nv,
                   int se, int ve, int n_layers, int n_w, int act_s, int act_v, int both_bf16,
                   int es_bf16, int ev_bf16, int dout_bf16, int cdt_bf16, void* stream) {
  const Shape sh = {n_layers, ns, nv, se, ve};
  if (!valid(dims_host, sh) || B < 1 || E < 1) return (int)cudaErrorInvalidValue;
  const Widths wd = widths(dims_host, sh);
  if (wd.n_w != n_w || bwd_smem(wd) > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const Inputs in = {both, es, ev, both_bf16, es_bf16, ev_bf16, (int64_t)B * E, E};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cdt_bf16
             ? launch_bwd<true>(in, sh, dims_dev, wd, w, act_s, act_v, dout, dout_bf16, dboth,
                                des, dev, partial, dw, s)
             : launch_bwd<false>(in, sh, dims_dev, wd, w, act_s, act_v, dout, dout_bf16, dboth,
                                 des, dev, partial, dw, s);
}

// y[i] = x[i] for n elements, x and y each f32 or bf16 (by their flags).
int k6_cast_copy(const void* x, void* y, long long n, int x_bf16, int y_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int64_t bytes = n * (x_bf16 ? 2 : 4);
  if (x_bf16 == y_bf16 && bytes % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(y) % 16 == 0) {
    copy16_kernel<<<k6_blocks(bytes / 16), K6_THREADS, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(y), bytes / 16);
  } else if (x_bf16 && y_bf16) {
    launch_cast<__nv_bfloat16, __nv_bfloat16>(x, y, n, s);
  } else if (x_bf16) {
    launch_cast<__nv_bfloat16, float>(x, y, n, s);
  } else if (y_bf16) {
    launch_cast<float, __nv_bfloat16>(x, y, n, s);
  } else {
    launch_cast<float, float>(x, y, n, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
