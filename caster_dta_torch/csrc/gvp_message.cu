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
// K5 bwd  k5_message_bwd: recomputes the forward of a tile of edges, then
//     runs the layers backwards (the JAX _layer_bwd, with its rounding points)
//     and writes d(both) as one [B, 2E, F] tensor (source rows, then
//     destination rows), d(es) and d(ev) in their inputs' dtypes, and each
//     weight's gradient summed over all edges in f32. Replaces ::_bwd_kernel.
// K6  k6_cast_copy: y = x, copied, cast between f32 and bf16 or not at all.
//     Replaces ::_cast_kernel (reached through layout_pin).
//
// What bounds them on the H100. At the served model's widths K5 fwd reads
// ~476 bytes and does ~5 kflop per edge, and K5 bwd moves ~840 bytes and does
// ~10 kflop: both under the ridge of the card (20 flop per byte in f32, 295
// in bf16), so the least time is the bytes' time. The products are tiny
// (K <= 73, N <= 16), far below the 64-row tiles of wgmma.
//
// K5 fwd at the widths of MmaNet instances (the served model's GVP convs, any
// depth): a warp owns a tile of edges from its input rows to its output
// rows, with no block barrier after the weights are staged. Its lanes copy
// the tile's rows of both, es and ev into the warp's staging in shared
// memory as f32, neighbouring lanes on neighbouring addresses, every load
// issued before any is waited on, and write the output rows from a staging
// the same way. Persistent blocks of 4 warps walk the tiles in a fixed
// order; each block stages its weights once.
//   bf16 compute dtype (message_fwd_mma_kernel): tiles of 16 edges, every
//   product an mma.sync on the fragments of K5 bwd's warp tiles (fwd_mma,
//   fwd_out below); ~96 registers, 5 blocks an SM.
//   f32 (message_fwd_f32_kernel; TF32 is off by contract, so no tensor-core
//   product): tiles of 32 edges, a lane's edge held in registers, every
//   weight read as a float4 broadcast from shared memory (transposed to
//   [in][out]) for 4 to 12 FFMAs. Each output is one FFMA chain in the
//   contract's order (inputs ascending, the scalars before the norms, the
//   bias last) with IEEE sqrt, exp and division: the bits of the block-tile
//   kernel. 168 registers, 3 blocks an SM; its FFMAs and their shared-memory
//   weight loads, not device memory, set its time (without its device loads
//   it takes ~80% of it at the Davis bucket).
//   Each has an instance with the served model's activations (relu, none)
//   and the dtypes of its call (bf16 step: both, es f32, ev bf16; serving:
//   f32) fixed at compile time, and one that reads them at run time.
//
// K5 fwd and bwd at widths without a warp-tile instance (message_fwd_kernel,
// message_bwd_kernel): one block per tile of edges stages the packed
// weights (rounded to the compute dtype) and the tile's activations in shared
// memory as f32, column-major with an odd stride, so a warp reads 32 edges of
// one column without bank conflicts while the weight it multiplies is
// broadcast. Each stage of a layer is a flat loop of the block's threads over
// (edge, output) pairs, each summing its inputs in a fixed order; stages are
// separated by __syncthreads. What limits it is the shared-memory traffic of
// these scalar products (two reads per FMA), not device memory.
//
// K5 bwd with the bf16 compute dtype (message_bwd_mma_kernel, for the widths
// of MmaNet instances): a warp owns a tile of 16 edges from its inputs to its
// gradients, with no block barrier between stages. Every product is an
// mma.sync.m16n8k16 with bf16 operands and f32 sums: exactly the rounded
// operands and f32 sums of the contract, so only the sum order changes.
// Edges are the rows (M); a vector quantity is three 16-row tiles, one per
// xyz. A product's f32 result feeds the next product's A operand by register
// moves (the C and A layouts share their 8x8 blocks); a weight gradient
// gW[o, k] = sum_e d[e, o] x[e, k] is a product whose K is the tile's edges,
// its operands transposed in registers by movmatrix. The block's warps share
// one copy of every weight, staged once as the B fragments of both its
// forward and its backward products. A warp keeps only each layer's inputs,
// in bf16 (every later use is a rounded product operand), and recomputes the
// layer's forward just before its backward. Weight gradients: each warp adds
// its tile's sums to its own f32 slab in shared memory, tile after tile; at
// the end the block adds its warps' slabs in warp order into its row of a
// [n_blocks, n_weights] scratch, and a second launch (reduce_rows_kernel)
// sums the rows in a fixed order. No atomics: two runs give the same bits.
// Persistent blocks (MMA_BLOCKS_PER_SM per SM) walk the tiles in a fixed
// order. What holds it back is scalar work around the mma's (address and
// fragment arithmetic, the elementwise math, which takes the fast exp,
// reciprocal and rsqrt intrinsics), at 8 warps an SM.
//
// K5 bwd with the f32 compute dtype (message_bwd_f32_kernel, for the widths of
// MmaNet instances up to BwdF32::MAX_LAYERS layers; the explainer's backward):
// FFMA, as the f32 forward (TF32 is off by contract). A warp owns a tile of 32
// edges, a lane's edge held in registers; blocks of 8 warps, one an SM, stage
// every layer's weights once (F32Layer, [in][out]) and walk the tiles in a
// fixed order. The warp stages its tile's input rows and dout rows with
// coalesced loads, runs the forward once to keep each later layer's inputs in
// the input rows, then runs the layers backwards, each forward recomputed from
// its inputs just before its backward (the first layer's inputs staged again,
// since the later layers' took their place). Every input
// cotangent (d both, d es, d ev and those between layers) is one FFMA chain
// in the order of the block-tile layer_bwd, its weights read as float4
// broadcasts along the rows the forward reads, with IEEE division: the
// block-tile kernel's bits. The weight gradients are sums over edges: each
// lane writes its edge's operands to the warp's operand rows in three groups,
// and the lanes split the gradient entries (a lane a column of ws, all its
// outputs; the narrow matrices' entries also split the edges, their sums
// added by an xor butterfly) and add the tile's sums to the warp's f32 slab in
// shared memory, tile after tile; then, as for the bf16 kernel, the block's
// row of the scratch and reduce_rows_kernel. No atomics: two runs give the
// same bits. What holds it back on the H100: the registers (255 a thread,
// with a small spill) and shared memory (~223 KB a block) allow 8 warps an
// SM, too few to hide the latency of its dependent FFMA chains and
// shared-memory loads; the weight-gradient passes, the second staging of the
// first layer's inputs and the ds_in chains cost about 16%, 13% and 8% of its
// time (scripts/k5_k6_times.py with each removed from a copy of the source).
//
// K6: a unit is 16 bytes of the wider dtype (4 f32 and their bf16, or 8
// bf16), so each warp's loads and stores are contiguous; a thread moves one
// unit a round on a grid of at most one wave, grid-stride. Pointers off
// 16-byte alignment take an element-wise loop.
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
constexpr int REDUCE_SEGS = 32;            // row segments per reduce block
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
        // one fused multiply-add, written out: which product a compiler
        // fuses must not decide the bits (the f32 warp tiles give these)
        dsp[i * S + e] = fmaf(ds_out[i * S + e], dact(act_s, x), dgi * dact(act_v, x));
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

// ---------------------------------------------------------------------------
// K5 bwd with the bf16 compute dtype: warp-owned tiles of 16 edges on mma.sync
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;            // warps per block
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MMA_BLOCKS_PER_SM = 2;    // resident blocks an SM holds (registers, shared memory)
constexpr int MMA_ROWS = 16;            // edges per warp tile: the mma's M

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---- warp primitives (PTX) ----

// two f32 rounded to bf16 (nearest even) in one word, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a b for a 16x16 bf16 A (row-major), a 16x8 bf16 B (column-major) and a
// 16x8 f32 D, the fragments as PTX's mma.m16n8k16 lays them out
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// the transpose of an 8x8 b16 matrix held one word a lane (lane 4r + c holds
// row r, columns 2c and 2c + 1), in the same layout
__device__ __forceinline__ uint32_t transpose8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ float shfl_xor(float x, int m) {
  return __shfl_xor_sync(0xffffffffu, x, m);
}

// the warp's lanes wait for each other; their shared-memory writes before it
// are seen by every lane after it
__device__ __forceinline__ void warp_sync() { __syncwarp(); }

// ---- end of warp primitives ----

// The warp-tile kernel's elementwise math: f32, through the card's fast
// exp, reciprocal and reciprocal square root (a few ulp each), which keeps
// the slow-path branches of IEEE division and square root out of its code.
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

__device__ __forceinline__ float act_fast(int a, float x) {
  return a == ACT_RELU ? fmaxf(x, 0.f) : a == ACT_SIGMOID ? sigmoid_fast(x) : x;
}

__device__ __forceinline__ float dact_fast(int a, float x) {
  if (a == ACT_RELU) return x > 0.f ? 1.f : 0.f;
  if (a == ACT_SIGMOID) {
    const float s = sigmoid_fast(x);
    return s * (1.f - s);
  }
  return 1.f;
}

// A 16-row f32 tile of N 8-column tiles in the mma's C layout: lane 4g + t
// holds, of column tile n, v[n] = {(g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1)}.
template <int N>
struct CTile {
  float v[N][4];
};

// A 16-row bf16 tile of K 16-column tiles in the mma's A layout: v[k] holds
// the 8x8 blocks (rows 0-7, columns 0-7), (8-15, 0-7), (0-7, 8-15) and
// (8-15, 8-15) of column tile k, one word each, in the layout of transpose8.
template <int K>
struct ATile {
  uint32_t v[K][4];
};

template <int N>
__device__ __forceinline__ void zero(CTile<N>& c) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) c.v[n][i] = 0.f;
  }
}

// The tile rounded to bf16 as the A operand of the next product: C and A
// share their 8x8 blocks, so this is a register move.
template <int N>
__device__ __forceinline__ ATile<cdiv(N, 2)> to_a(const CTile<N>& c) {
  ATile<cdiv(N, 2)> a;
#pragma unroll
  for (int k = 0; k < cdiv(N, 2); ++k) {
    a.v[k][0] = pack_bf16(c.v[2 * k][0], c.v[2 * k][1]);
    a.v[k][1] = pack_bf16(c.v[2 * k][2], c.v[2 * k][3]);
    if (2 * k + 1 < N) {
      a.v[k][2] = pack_bf16(c.v[2 * k + 1][0], c.v[2 * k + 1][1]);
      a.v[k][3] = pack_bf16(c.v[2 * k + 1][2], c.v[2 * k + 1][3]);
    } else {
      a.v[k][2] = 0u;
      a.v[k][3] = 0u;
    }
  }
  return a;
}

// Columns 16m .. 16m + 15 of c, rounded and transposed, as an A operand: its
// rows are those columns and its K is the tile's 16 edges.
template <int N>
__device__ __forceinline__ void trans_a(const CTile<N>& c, int m, uint32_t (&a)[4]) {
  a[0] = transpose8(pack_bf16(c.v[2 * m][0], c.v[2 * m][1]));
  a[2] = transpose8(pack_bf16(c.v[2 * m][2], c.v[2 * m][3]));
  if (2 * m + 1 < N) {
    a[1] = transpose8(pack_bf16(c.v[2 * m + 1][0], c.v[2 * m + 1][1]));
    a[3] = transpose8(pack_bf16(c.v[2 * m + 1][2], c.v[2 * m + 1][3]));
  } else {
    a[1] = 0u;
    a[3] = 0u;
  }
}

// Columns 8n .. 8n + 7 of a tile, rounded and transposed, as a B operand
// whose K is the tile's 16 edges.
template <int N>
__device__ __forceinline__ uint2 trans_b(const CTile<N>& c, int n) {
  return make_uint2(transpose8(pack_bf16(c.v[n][0], c.v[n][1])),
                    transpose8(pack_bf16(c.v[n][2], c.v[n][3])));
}

template <int K>
__device__ __forceinline__ uint2 trans_b(const ATile<K>& a, int n) {
  return make_uint2(transpose8(a.v[n / 2][2 * (n % 2)]), transpose8(a.v[n / 2][2 * (n % 2) + 1]));
}

// One gated GVP layer's widths, and what follows from them: K* counts the
// 16-column tiles of an A operand, N* the 8-column tiles of a C tile; the
// offsets of its B fragments (256 bytes each) in the staged weights, of its
// weight-gradient fragments (512 bytes each) in a warp's slab, and of its
// weights in the packed layout ([out, in]: wh, ws, bs, wv, wsv, bsv).
template <int SI_, int VI_, int H_, int SO_, int VO_>
struct MmaLayer {
  static constexpr int SI = SI_, VI = VI_, H = H_, SO = SO_, VO = VO_;
  static constexpr int KS = cdiv(SI, 16), KV = cdiv(VI, 16), KH = cdiv(H, 16);
  static constexpr int KSO = cdiv(SO, 16), KVO = cdiv(VO, 16);
  static constexpr int NSI = cdiv(SI, 8), NVI = cdiv(VI, 8), NH = cdiv(H, 8);
  static constexpr int NSO = cdiv(SO, 8), NVO = cdiv(VO, 8);
  // B operands: *_F of the forward products, *_B of the backward ones
  static constexpr int WH_F = 0;                    // vh = v wh^T      [vi, h]
  static constexpr int WS_FS = WH_F + KV * NH;      // spre = s ws^T     [si, so]
  static constexpr int WS_FV = WS_FS + KS * NSO;    //   + vn ws^T       [h, so]
  static constexpr int WV_F = WS_FV + KH * NSO;     // vraw = vh wv^T   [h, vo]
  static constexpr int WSV_F = WV_F + KH * NVO;     // z = gi wsv^T     [so, vo]
  static constexpr int WSV_B = WSV_F + KSO * NVO;   // dgi = dz wsv     [vo, so]
  static constexpr int WS_BS = WSV_B + KVO * NSO;   // ds = dspre ws    [so, si]
  static constexpr int WS_BV = WS_BS + KSO * NSI;   // dvn = dspre ws   [so, h]
  static constexpr int WV_B = WS_BV + KSO * NH;     // dvh = dvraw wv   [vo, h]
  static constexpr int WH_B = WV_B + KVO * NH;      // dv = dvh wh      [h, vi]
  static constexpr int NB = WH_B + KH * NVI;
  // weight gradients, rows x columns in 16 x 8 fragments
  static constexpr int G_WSV = 0;                         // wsv^T [so, vo]
  static constexpr int G_WS = G_WSV + KSO * NVO;          // ws    [so, si | h]
  static constexpr int G_WV = G_WS + KSO * (NSI + NH);    // wv^T  [h, vo]
  static constexpr int G_WH = G_WV + KH * NVO;            // wh    [h, vi]
  static constexpr int NG = G_WH + KH * NVI;
  static constexpr int BIAS = 8 * (NSO + NVO);            // bs, then bsv, padded
  static constexpr int CACHE = KS + 3 * KV;               // A tiles of the layer's inputs
  static constexpr int P_WH = 0, P_WS = H * VI, P_BS = P_WS + SO * (SI + H);
  static constexpr int P_WV = P_BS + SO, P_WSV = P_WV + VO * H, P_BSV = P_WSV + VO * SO;
  static constexpr int NW = P_BSV + VO;
};

// The message MLP of a GVPConv: node (NS, NV), edge (SE, VE); the first layer
// maps (2NS + SE, 2NV + VE) to (SO, VO) through H0 vector channels, every
// later one (SO, VO) to itself through H1.
template <int NS_, int NV_, int SE_, int VE_, int H0, int SO, int VO, int H1>
struct MmaNet {
  static constexpr int NS = NS_, NV = NV_, SE = SE_, VE = VE_;
  using L0 = MmaLayer<2 * NS_ + SE_, 2 * NV_ + VE_, H0, SO, VO>;
  using L1 = MmaLayer<SO, VO, H1, SO, VO>;
};

// the served model's GVP convs (runs/davis_seed9): node (16, 4), edge (32, 1)
using ServedNet = MmaNet<16, 4, 32, 1, 9, 16, 4, 4>;

// Byte offsets in a block's shared memory for n_layers layers: the staged B
// fragments and biases of every layer, then each warp's region: its layer
// inputs (A tiles, 16 bytes a lane each), its weight-gradient slab (f32
// fragments, 16 bytes a lane each) and its bias-gradient sums.
struct MmaSmem {
  int b1, bias0, bias1, warp0, cache1, slab, gbias, per_warp, total, slab_floats;
};

template <class Net>
__host__ __device__ inline MmaSmem mma_smem(int n_layers) {
  using L0 = typename Net::L0;
  using L1 = typename Net::L1;
  const int m = n_layers - 1;
  MmaSmem s;
  s.b1 = L0::NB * 256;
  s.bias0 = s.b1 + m * L1::NB * 256;
  s.bias1 = s.bias0 + 4 * L0::BIAS;
  s.warp0 = (s.bias1 + 4 * m * L1::BIAS + 15) / 16 * 16;
  s.cache1 = L0::CACHE * 512;
  s.slab = s.cache1 + m * L1::CACHE * 512;
  s.gbias = s.slab + (L0::NG + m * L1::NG) * 512;
  s.slab_floats = (L0::NG + m * L1::NG) * 128 + L0::BIAS + m * L1::BIAS;
  s.per_warp = (s.slab + 4 * s.slab_floats + 15) / 16 * 16;
  s.total = s.warp0 + MMA_WARPS * s.per_warp;
  return s;
}

// Stage one B operand, B[k][n] = w[k sk + n sn] for k < K, n < N (else 0),
// rounded to bf16, as fragments (k tile, n tile) of 32 lanes x 2 words.
__device__ void stage_b(const float* __restrict__ w, int K, int N, int sk, int sn, uint2* dst) {
  const int kts = cdiv(K, 16), nts = cdiv(N, 8);
  for (int p = threadIdx.x; p < kts * nts * 32; p += blockDim.x) {
    const int lane = p & 31, f = p >> 5, kt = f / nts, nt = f - kt * nts;
    const int n = 8 * nt + (lane >> 2), k0 = 16 * kt + 2 * (lane & 3);
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + (i & 1) + 8 * (i >> 1);
      x[i] = k < K && n < N ? w[k * sk + n * sn] : 0.f;
    }
    dst[p] = make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
  }
}

// Stage a layer's B operands (BWD: those of its backward products too; the
// forward's are the first L::WSV_B fragments) and its biases (f32, padded
// with zeros).
template <class L, bool BWD = true>
__device__ void stage_layer(const float* __restrict__ w, uint2* B, float* bias) {
  constexpr int SH = L::SI + L::H;
  stage_b(w + L::P_WH, L::VI, L::H, 1, L::VI, B + 32 * L::WH_F);
  stage_b(w + L::P_WS, L::SI, L::SO, 1, SH, B + 32 * L::WS_FS);
  stage_b(w + L::P_WS + L::SI, L::H, L::SO, 1, SH, B + 32 * L::WS_FV);
  stage_b(w + L::P_WV, L::H, L::VO, 1, L::H, B + 32 * L::WV_F);
  stage_b(w + L::P_WSV, L::SO, L::VO, 1, L::SO, B + 32 * L::WSV_F);
  if constexpr (BWD) {
    stage_b(w + L::P_WSV, L::VO, L::SO, L::SO, 1, B + 32 * L::WSV_B);
    stage_b(w + L::P_WS, L::SO, L::SI, SH, 1, B + 32 * L::WS_BS);
    stage_b(w + L::P_WS + L::SI, L::SO, L::H, SH, 1, B + 32 * L::WS_BV);
    stage_b(w + L::P_WV, L::VO, L::H, L::H, 1, B + 32 * L::WV_B);
    stage_b(w + L::P_WH, L::H, L::VI, L::VI, 1, B + 32 * L::WH_B);
  }
  for (int i = threadIdx.x; i < L::BIAS; i += blockDim.x) {
    const int o = i - 8 * L::NSO;
    bias[i] = o < 0 ? (i < L::SO ? w[L::P_BS + i] : 0.f) : (o < L::VO ? w[L::P_BSV + o] : 0.f);
  }
}

// A layer's forward activations on a tile, as its backward needs them.
template <class L>
struct Fwd {
  CTile<L::NH> vh[3], q, vn;
  CTile<L::NSO> spre;
  CTile<L::NVO> vraw[3], g;
};

// One gated GVP layer on the warp's tile (the JAX _layer_fwd): xs, xv are the
// layer's rounded inputs; B, bias its staged weights.
template <class L>
__device__ __forceinline__ void fwd_mma(const uint2* __restrict__ B, const float* __restrict__ bias,
                                        int act_v, const ATile<L::KS>& xs,
                                        const ATile<L::KV> (&xv)[3], Fwd<L>& f, int lane) {
  const int c0 = 2 * (lane & 3);
  // vh = wh v, each of xyz
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    zero(f.vh[d]);
#pragma unroll
    for (int n = 0; n < L::NH; ++n) {
#pragma unroll
      for (int k = 0; k < L::KV; ++k) {
        mma_bf16(f.vh[d].v[n], xv[d].v[k], B[(L::WH_F + k * L::NH + n) * 32 + lane]);
      }
    }
  }
  // the clamped norm over xyz
#pragma unroll
  for (int n = 0; n < L::NH; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = f.vh[0].v[n][i], y = f.vh[1].v[n][i], z = f.vh[2].v[n][i];
      f.q.v[n][i] = x * x + y * y + z * z;
      const float qq = fmaxf(f.q.v[n][i], EPS);
      f.vn.v[n][i] = qq * rsqrtf(qq);
    }
  }
  // spre = ws [s, vn] + bs
  const ATile<L::KH> vna = to_a(f.vn);
#pragma unroll
  for (int n = 0; n < L::NSO; ++n) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < L::KS; ++k) {
      mma_bf16(acc, xs.v[k], B[(L::WS_FS + k * L::NSO + n) * 32 + lane]);
    }
#pragma unroll
    for (int k = 0; k < L::KH; ++k) {
      mma_bf16(acc, vna.v[k], B[(L::WS_FV + k * L::NSO + n) * 32 + lane]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) f.spre.v[n][i] = acc[i] + bias[8 * n + c0 + (i & 1)];
  }
  // vraw = wv vh
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const ATile<L::KH> a = to_a(f.vh[d]);
    zero(f.vraw[d]);
#pragma unroll
    for (int n = 0; n < L::NVO; ++n) {
#pragma unroll
      for (int k = 0; k < L::KH; ++k) {
        mma_bf16(f.vraw[d].v[n], a.v[k], B[(L::WV_F + k * L::NVO + n) * 32 + lane]);
      }
    }
  }
  // the gate reads the pre-activation scalars through the vector activation
  CTile<L::NSO> gi;
#pragma unroll
  for (int n = 0; n < L::NSO; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) gi.v[n][i] = act_fast(act_v, f.spre.v[n][i]);
  }
  const ATile<L::KSO> ga = to_a(gi);
#pragma unroll
  for (int n = 0; n < L::NVO; ++n) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < L::KSO; ++k) {
      mma_bf16(acc, ga.v[k], B[(L::WSV_F + k * L::NVO + n) * 32 + lane]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f.g.v[n][i] = sigmoid_fast(acc[i] + bias[8 * L::NSO + 8 * n + c0 + (i & 1)]);
    }
  }
}

// The layer's outputs, rounded: the next layer's inputs.
template <class L>
__device__ __forceinline__ void fwd_out(const Fwd<L>& f, int act_s, ATile<L::KSO>& xs,
                                        ATile<L::KVO> (&xv)[3]) {
  CTile<L::NSO> s;
#pragma unroll
  for (int n = 0; n < L::NSO; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s.v[n][i] = act_fast(act_s, f.spre.v[n][i]);
  }
  xs = to_a(s);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    CTile<L::NVO> v;
#pragma unroll
    for (int n = 0; n < L::NVO; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) v.v[n][i] = f.vraw[d].v[n][i] * f.g.v[n][i];
    }
    xv[d] = to_a(v);
  }
}

// out[8n + c] += the sum of column c of tile n over the 16 rows, in a fixed
// order; lanes 0-3 write.
template <int N>
__device__ __forceinline__ void add_colsum(const CTile<N>& c, float* out, int lane) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float s0 = c.v[n][0] + c.v[n][2], s1 = c.v[n][1] + c.v[n][3];
#pragma unroll
    for (int m = 4; m < 32; m *= 2) {
      s0 += shfl_xor(s0, m);
      s1 += shfl_xor(s1, m);
    }
    if (lane < 4) {
      out[8 * n + 2 * lane] += s0;
      out[8 * n + 2 * lane + 1] += s1;
    }
  }
}

__device__ __forceinline__ void slab_add(float4* slab, int f, int lane, const float (&c)[4]) {
  float4& s = slab[f * 32 + lane];
  s.x += c[0];
  s.y += c[1];
  s.z += c[2];
  s.w += c[3];
}

// The backward of one layer on the warp's tile (the JAX _layer_bwd). ds, dv
// are the cotangents of its outputs; the cotangents of its inputs go to
// sink_s(n, c) (scalar column tile n) and sink_v(d, n, c) (vector tile n of
// xyz d); its weight gradients are added to the warp's slab, its bias
// gradients to gbias.
template <class L, class SinkS, class SinkV>
__device__ __forceinline__ void bwd_mma(const uint2* __restrict__ B, int act_s, int act_v,
                                        const ATile<L::KS>& xs, const ATile<L::KV> (&xv)[3],
                                        const Fwd<L>& f, const CTile<L::NSO>& ds,
                                        const CTile<L::NVO> (&dv)[3], float4* slab, float* gbias,
                                        int lane, SinkS sink_s, SinkV sink_v) {
  uint32_t a[4];
  // the gate: dvraw = dv g, dz = (dv . vraw) g (1 - g)
  CTile<L::NVO> dvraw[3], dz;
#pragma unroll
  for (int n = 0; n < L::NVO; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float gg = f.g.v[n][i];
      const float dg = dv[0].v[n][i] * f.vraw[0].v[n][i] + dv[1].v[n][i] * f.vraw[1].v[n][i] +
                       dv[2].v[n][i] * f.vraw[2].v[n][i];
#pragma unroll
      for (int d = 0; d < 3; ++d) dvraw[d].v[n][i] = dv[d].v[n][i] * gg;
      dz.v[n][i] = dg * gg * (1.f - gg);
    }
  }
  add_colsum(dz, gbias + 8 * L::NSO, lane);
  // the gradient of wsv: [i, o] = sum_e act_v(spre)[e, i] dz[e, o]
  CTile<L::NSO> gi;
#pragma unroll
  for (int n = 0; n < L::NSO; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) gi.v[n][i] = act_fast(act_v, f.spre.v[n][i]);
  }
#pragma unroll
  for (int m = 0; m < L::KSO; ++m) {
    trans_a(gi, m, a);
#pragma unroll
    for (int n = 0; n < L::NVO; ++n) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(acc, a, trans_b(dz, n));
      slab_add(slab, L::G_WSV + m * L::NVO + n, lane, acc);
    }
  }
  // dspre = ds act_s'(spre) + (dz wsv) act_v'(spre)
  const ATile<L::KVO> dza = to_a(dz);
  CTile<L::NSO> dspre;
#pragma unroll
  for (int n = 0; n < L::NSO; ++n) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < L::KVO; ++k) {
      mma_bf16(acc, dza.v[k], B[(L::WSV_B + k * L::NSO + n) * 32 + lane]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = f.spre.v[n][i];
      dspre.v[n][i] = ds.v[n][i] * dact_fast(act_s, x) + acc[i] * dact_fast(act_v, x);
    }
  }
  add_colsum(dspre, gbias, lane);
  // the gradient of ws: [o, k] = sum_e dspre[e, o] [s, vn][e, k]
#pragma unroll
  for (int m = 0; m < L::KSO; ++m) {
    trans_a(dspre, m, a);
#pragma unroll
    for (int n = 0; n < L::NSI; ++n) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(acc, a, trans_b(xs, n));
      slab_add(slab, L::G_WS + m * (L::NSI + L::NH) + n, lane, acc);
    }
#pragma unroll
    for (int n = 0; n < L::NH; ++n) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(acc, a, trans_b(f.vn, n));
      slab_add(slab, L::G_WS + m * (L::NSI + L::NH) + L::NSI + n, lane, acc);
    }
  }
  // [ds, dvn] = dspre ws: ds to the sink
  const ATile<L::KSO> dpa = to_a(dspre);
#pragma unroll
  for (int n = 0; n < L::NSI; ++n) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < L::KSO; ++k) {
      mma_bf16(acc, dpa.v[k], B[(L::WS_BS + k * L::NSI + n) * 32 + lane]);
    }
    sink_s(n, acc);
  }
  CTile<L::NH> dvn;
  zero(dvn);
#pragma unroll
  for (int n = 0; n < L::NH; ++n) {
#pragma unroll
    for (int k = 0; k < L::KSO; ++k) {
      mma_bf16(dvn.v[n], dpa.v[k], B[(L::WS_BV + k * L::NH + n) * 32 + lane]);
    }
  }
  // dvh = dvraw wv
  CTile<L::NH> dvh[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const ATile<L::KVO> x = to_a(dvraw[d]);
    zero(dvh[d]);
#pragma unroll
    for (int n = 0; n < L::NH; ++n) {
#pragma unroll
      for (int k = 0; k < L::KVO; ++k) {
        mma_bf16(dvh[d].v[n], x.v[k], B[(L::WV_B + k * L::NH + n) * 32 + lane]);
      }
    }
  }
  // the gradient of wv: [j, o] = sum_{e, xyz} vh[e, j] dvraw[e, o]
#pragma unroll
  for (int m = 0; m < L::KH; ++m) {
#pragma unroll
    for (int n = 0; n < L::NVO; ++n) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        trans_a(f.vh[d], m, a);
        mma_bf16(acc, a, trans_b(dvraw[d], n));
      }
      slab_add(slab, L::G_WV + m * L::NVO + n, lane, acc);
    }
  }
  // the norm: dvh += vh dvn / vn where |vh|^2 > eps (0 inside the clamp)
#pragma unroll
  for (int n = 0; n < L::NH; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float coef = f.q.v[n][i] > EPS ? __fdividef(dvn.v[n][i], f.vn.v[n][i]) : 0.f;
#pragma unroll
      for (int d = 0; d < 3; ++d) dvh[d].v[n][i] += f.vh[d].v[n][i] * coef;
    }
  }
  // dv = dvh wh to the sink
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const ATile<L::KH> x = to_a(dvh[d]);
#pragma unroll
    for (int n = 0; n < L::NVI; ++n) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < L::KH; ++k) {
        mma_bf16(acc, x.v[k], B[(L::WH_B + k * L::NVI + n) * 32 + lane]);
      }
      sink_v(d, n, acc);
    }
  }
  // the gradient of wh: [j, i] = sum_{e, xyz} dvh[e, j] v[e, i]
#pragma unroll
  for (int m = 0; m < L::KH; ++m) {
#pragma unroll
    for (int n = 0; n < L::NVI; ++n) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        trans_a(dvh[d], m, a);
        mma_bf16(acc, a, trans_b(xv[d], n));
      }
      slab_add(slab, L::G_WH + m * L::NVI + n, lane, acc);
    }
  }
}

template <class L>
__device__ __forceinline__ void cache_store(uint4* cache, int lane, const ATile<L::KS>& xs,
                                            const ATile<L::KV> (&xv)[3]) {
#pragma unroll
  for (int k = 0; k < L::KS; ++k) {
    cache[k * 32 + lane] = make_uint4(xs.v[k][0], xs.v[k][1], xs.v[k][2], xs.v[k][3]);
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
#pragma unroll
    for (int k = 0; k < L::KV; ++k) {
      cache[(L::KS + d * L::KV + k) * 32 + lane] =
          make_uint4(xv[d].v[k][0], xv[d].v[k][1], xv[d].v[k][2], xv[d].v[k][3]);
    }
  }
}

template <class L>
__device__ __forceinline__ void cache_load(const uint4* cache, int lane, ATile<L::KS>& xs,
                                           ATile<L::KV> (&xv)[3]) {
#pragma unroll
  for (int k = 0; k < L::KS; ++k) {
    const uint4 u = cache[k * 32 + lane];
    xs.v[k][0] = u.x;
    xs.v[k][1] = u.y;
    xs.v[k][2] = u.z;
    xs.v[k][3] = u.w;
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
#pragma unroll
    for (int k = 0; k < L::KV; ++k) {
      const uint4 u = cache[(L::KS + d * L::KV + k) * 32 + lane];
      xv[d].v[k][0] = u.x;
      xv[d].v[k][1] = u.y;
      xv[d].v[k][2] = u.z;
      xv[d].v[k][3] = u.w;
    }
  }
}

// The packed index of a layer's weight-gradient entry: row r, column c of
// slab fragment f (or of the bias sums when f < 0, at column c); -1 for
// padding.
template <class L>
__device__ __forceinline__ int grad_index(int f, int r, int c) {
  if (f < 0) {
    const int o = c - 8 * L::NSO;
    if (o < 0) return c < L::SO ? L::P_BS + c : -1;
    return o < L::VO ? L::P_BSV + o : -1;
  }
  if (f < L::G_WS) {
    const int i = 16 * (f / L::NVO) + r, o = 8 * (f % L::NVO) + c;
    return i < L::SO && o < L::VO ? L::P_WSV + o * L::SO + i : -1;
  }
  if (f < L::G_WV) {
    const int ff = f - L::G_WS, n = ff % (L::NSI + L::NH), o = 16 * (ff / (L::NSI + L::NH)) + r;
    if (o >= L::SO) return -1;
    if (n < L::NSI) {
      const int k = 8 * n + c;
      return k < L::SI ? L::P_WS + o * (L::SI + L::H) + k : -1;
    }
    const int k = 8 * (n - L::NSI) + c;
    return k < L::H ? L::P_WS + o * (L::SI + L::H) + L::SI + k : -1;
  }
  if (f < L::G_WH) {
    const int ff = f - L::G_WV, j = 16 * (ff / L::NVO) + r, o = 8 * (ff % L::NVO) + c;
    return j < L::H && o < L::VO ? L::P_WV + o * L::H + j : -1;
  }
  const int ff = f - L::G_WH, j = 16 * (ff / L::NVI) + r, i = 8 * (ff % L::NVI) + c;
  return j < L::H && i < L::VI ? L::P_WH + j * L::VI + i : -1;
}

// The dtypes of K5 bwd's tensors as bits: both, es, ev, dout (bf16 where
// set). The bf16 training step's: both and es f32, ev bf16, dout f32.
constexpr int DT_STEP = 1 << 2;

// ACT_S, ACT_V and DT fix the activations and dtypes at compile time where
// they are >= 0 (the instance for the served model's bf16 step drops the
// runtime branches of every load, store and activation); -1 takes them from
// the arguments.
template <class Net, int ACT_S, int ACT_V, int DT>
__global__ void __launch_bounds__(MMA_THREADS, MMA_BLOCKS_PER_SM)
message_bwd_mma_kernel(Inputs in, int n_layers, const float* __restrict__ w, int act_s, int act_v,
                       const void* __restrict__ dout, int dout_bf16, void* __restrict__ dboth,
                       void* __restrict__ des, void* __restrict__ dev,
                       float* __restrict__ partial, int n_w) {
  if constexpr (ACT_S >= 0) act_s = ACT_S;
  if constexpr (ACT_V >= 0) act_v = ACT_V;
  if constexpr (DT >= 0) {
    in.both_bf16 = DT & 1;
    in.es_bf16 = (DT >> 1) & 1;
    in.ev_bf16 = (DT >> 2) & 1;
    dout_bf16 = (DT >> 3) & 1;
  }
  using L0 = typename Net::L0;
  using L1 = typename Net::L1;
  constexpr int NS = Net::NS, NV = Net::NV, SE = Net::SE, VE = Net::VE;
  constexpr int FB = NS + 3 * NV, SO = L0::SO, VO = L0::VO, FO = SO + 3 * VO;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  const MmaSmem s = mma_smem<Net>(n_layers);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c0 = 2 * (lane & 3);

  uint2* const B0 = reinterpret_cast<uint2*>(smem_bytes);
  float* const bias0 = reinterpret_cast<float*>(smem_bytes + s.bias0);
  // layer k >= 1's staged weights and biases
  auto b_of = [&](int k) {
    return reinterpret_cast<uint2*>(smem_bytes + s.b1) + (k - 1) * L1::NB * 32;
  };
  auto bias_of = [&](int k) {
    return reinterpret_cast<float*>(smem_bytes + s.bias1) + (k - 1) * L1::BIAS;
  };
  stage_layer<L0>(w, B0, bias0);
  for (int k = 1; k < n_layers; ++k) {
    stage_layer<L1>(w + L0::NW + (k - 1) * L1::NW, b_of(k), bias_of(k));
  }
  for (int i = threadIdx.x; i < MMA_WARPS * s.per_warp / 16; i += blockDim.x) {
    reinterpret_cast<uint4*>(smem_bytes + s.warp0)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  unsigned char* const mine = smem_bytes + s.warp0 + warp * s.per_warp;
  uint4* const cache0 = reinterpret_cast<uint4*>(mine);
  auto cache_of = [&](int k) {
    return reinterpret_cast<uint4*>(mine + s.cache1) + (k - 1) * L1::CACHE * 32;
  };
  float4* const slab0 = reinterpret_cast<float4*>(mine + s.slab);
  auto slab_of = [&](int k) { return slab0 + (L0::NG + (k - 1) * L1::NG) * 32; };
  float* const gbias0 = reinterpret_cast<float*>(mine + s.gbias);
  auto gbias_of = [&](int k) { return gbias0 + L0::BIAS + (k - 1) * L1::BIAS; };

  const int64_t n_tiles = (in.R + MMA_ROWS - 1) / MMA_ROWS;
  const int64_t stride = (int64_t)gridDim.x * MMA_WARPS;
  for (int64_t tile = (int64_t)blockIdx.x * MMA_WARPS + warp; tile < n_tiles; tile += stride) {
    // the lane's two edges, rows g and g + 8 of the tile. Every load below
    // is unconditional (its address picked by selects), so a lane issues
    // them all before it waits: an edge past R reads edge R - 1, a column
    // past the widths the last column, and the value is zeroed after.
    int64_t r[2], src[2], dst[2];
    bool ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t re = tile * MMA_ROWS + g + 8 * h;
      ok[h] = re < in.R;
      r[h] = ok[h] ? re : in.R - 1;
      const int64_t b = r[h] / in.E, j = r[h] - b * in.E;
      src[h] = b * 2 * (int64_t)in.E + j;
      dst[h] = src[h] + in.E;
    }
    // the first layer's inputs, rounded: s = (s_j, es, s_i), v = (v_j, ev, v_i)
    auto s_in = [&](int h, int k) -> float {
      const int kk = k < L0::SI ? k : L0::SI - 1;
      const bool j = kk < NS, e = !j && kk < NS + SE;
      const float x = load(e ? in.es : in.both,
                           j ? src[h] * FB + kk
                             : e ? r[h] * SE + (kk - NS) : dst[h] * FB + (kk - NS - SE),
                           e ? in.es_bf16 : in.both_bf16);
      return ok[h] && k < L0::SI ? x : 0.f;
    };
    auto v_in = [&](int h, int i, int d) -> float {
      const int ii = i < L0::VI ? i : L0::VI - 1;
      const bool j = ii < NV, e = !j && ii < NV + VE;
      const float x = load(e ? in.ev : in.both,
                           j ? src[h] * FB + NS + 3 * ii + d
                             : e ? r[h] * 3 * VE + 3 * (ii - NV) + d
                                 : dst[h] * FB + NS + 3 * (ii - NV - VE) + d,
                           e ? in.ev_bf16 : in.both_bf16);
      return ok[h] && i < L0::VI ? x : 0.f;
    };
    {
      ATile<L0::KS> xs;
      ATile<L0::KV> xv[3];
#pragma unroll
      for (int k = 0; k < L0::KS; ++k) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int col = 16 * k + c0 + 8 * (q >> 1), h = q & 1;
          xs.v[k][q] = pack_bf16(s_in(h, col), s_in(h, col + 1));
        }
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) {
#pragma unroll
        for (int k = 0; k < L0::KV; ++k) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int col = 16 * k + c0 + 8 * (q >> 1), h = q & 1;
            xv[d].v[k][q] = pack_bf16(v_in(h, col, d), v_in(h, col + 1, d));
          }
        }
      }
      cache_store<L0>(cache0, lane, xs, xv);
      // the forward, keeping every later layer's inputs
      if (n_layers > 1) {
        ATile<L1::KS> ys;
        ATile<L1::KV> yv[3];
        {
          Fwd<L0> f;
          fwd_mma<L0>(B0, bias0, act_v, xs, xv, f, lane);
          fwd_out<L0>(f, act_s, ys, yv);
        }
        cache_store<L1>(cache_of(1), lane, ys, yv);
        for (int k = 1; k < n_layers - 1; ++k) {
          Fwd<L1> f;
          fwd_mma<L1>(b_of(k), bias_of(k), act_v, ys, yv, f, lane);
          fwd_out<L1>(f, act_s, ys, yv);
          cache_store<L1>(cache_of(k + 1), lane, ys, yv);
        }
      }
    }
    // the cotangent of the last layer's output: ds [so], dv [3vo]
    CTile<L0::NSO> ds;
    CTile<L0::NVO> dv[3];
#pragma unroll
    for (int n = 0; n < L0::NSO; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = 8 * n + c0 + (i & 1), h = i >> 1;
        const float x = load(dout, r[h] * FO + (col < SO ? col : SO - 1), dout_bf16);
        ds.v[n][i] = ok[h] && col < SO ? x : 0.f;
      }
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
#pragma unroll
      for (int n = 0; n < L0::NVO; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = 8 * n + c0 + (i & 1), h = i >> 1;
          const float x = load(dout, r[h] * FO + SO + 3 * (col < VO ? col : VO - 1) + d, dout_bf16);
          dv[d].v[n][i] = ok[h] && col < VO ? x : 0.f;
        }
      }
    }
    // the later layers backwards, each forward recomputed from its inputs
    for (int k = n_layers - 1; k >= 1; --k) {
      const bool last = k == n_layers - 1;
      const int as = last ? ACT_NONE : act_s, av = last ? ACT_NONE : act_v;
      ATile<L1::KS> ys;
      ATile<L1::KV> yv[3];
      cache_load<L1>(cache_of(k), lane, ys, yv);
      Fwd<L1> f;
      fwd_mma<L1>(b_of(k), bias_of(k), av, ys, yv, f, lane);
      CTile<L1::NSI> ds_in;
      CTile<L1::NVI> dv_in[3];
      bwd_mma<L1>(
          b_of(k), as, av, ys, yv, f, ds, dv, slab_of(k), gbias_of(k), lane,
          [&](int n, const float (&c)[4]) {
#pragma unroll
            for (int i = 0; i < 4; ++i) ds_in.v[n][i] = c[i];
          },
          [&](int d, int n, const float (&c)[4]) {
#pragma unroll
            for (int i = 0; i < 4; ++i) dv_in[d].v[n][i] = c[i];
          });
      ds = ds_in;
#pragma unroll
      for (int d = 0; d < 3; ++d) dv[d] = dv_in[d];
    }
    // the first layer, its input cotangents stored: d(both) source rows,
    // d(es), d(both) destination rows; the same for the vectors and d(ev)
    {
      const bool last = n_layers == 1;
      const int as = last ? ACT_NONE : act_s, av = last ? ACT_NONE : act_v;
      ATile<L0::KS> xs;
      ATile<L0::KV> xv[3];
      cache_load<L0>(cache0, lane, xs, xv);
      Fwd<L0> f;
      fwd_mma<L0>(B0, bias0, av, xs, xv, f, lane);
      bwd_mma<L0>(
          B0, as, av, xs, xv, f, ds, dv, slab0, gbias0, lane,
          [&](int n, const float (&c)[4]) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int col = 8 * n + c0 + (i & 1), h = i >> 1;
              if (!ok[h] || col >= L0::SI) continue;
              if (col < NS) {
                store(dboth, src[h] * FB + col, c[i], in.both_bf16);
              } else if (col < NS + SE) {
                store(des, r[h] * SE + (col - NS), c[i], in.es_bf16);
              } else {
                store(dboth, dst[h] * FB + (col - NS - SE), c[i], in.both_bf16);
              }
            }
          },
          [&](int d, int n, const float (&c)[4]) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int col = 8 * n + c0 + (i & 1), h = i >> 1;
              if (!ok[h] || col >= L0::VI) continue;
              if (col < NV) {
                store(dboth, src[h] * FB + NS + 3 * col + d, c[i], in.both_bf16);
              } else if (col < NV + VE) {
                store(dev, r[h] * 3 * VE + 3 * (col - NV) + d, c[i], in.ev_bf16);
              } else {
                store(dboth, dst[h] * FB + NS + 3 * (col - NV - VE) + d, c[i], in.both_bf16);
              }
            }
          });
    }
  }
  __syncthreads();
  // the block's row of weight gradients: the warps' slabs added in warp order
  const int frag_floats = (L0::NG + (n_layers - 1) * L1::NG) * 128;
  for (int p = threadIdx.x; p < s.slab_floats; p += blockDim.x) {
    float sum = 0.f;
    for (int v = 0; v < MMA_WARPS; ++v) {
      sum += reinterpret_cast<const float*>(smem_bytes + s.warp0 + v * s.per_warp + s.slab)[p];
    }
    int idx;
    if (p < frag_floats) {
      const int f = p >> 7, ln = (p >> 2) & 31, q = p & 3;
      const int rr = (ln >> 2) + 8 * (q >> 1), cc = 2 * (ln & 3) + (q & 1);
      if (f < L0::NG) {
        idx = grad_index<L0>(f, rr, cc);
      } else {
        const int k = 1 + (f - L0::NG) / L1::NG;
        idx = grad_index<L1>((f - L0::NG) % L1::NG, rr, cc);
        if (idx >= 0) idx += L0::NW + (k - 1) * L1::NW;
      }
    } else {
      const int q = p - frag_floats;
      if (q < L0::BIAS) {
        idx = grad_index<L0>(-1, 0, q);
      } else {
        const int k = 1 + (q - L0::BIAS) / L1::BIAS;
        idx = grad_index<L1>(-1, 0, (q - L0::BIAS) % L1::BIAS);
        if (idx >= 0) idx += L0::NW + (k - 1) * L1::NW;
      }
    }
    if (idx >= 0) partial[(int64_t)blockIdx.x * n_w + idx] = sum;
  }
}

// ---------------------------------------------------------------------------
// K5 fwd at the widths of MmaNet instances: warp-owned edge tiles
// ---------------------------------------------------------------------------

constexpr int FWD_WARPS = 4;               // warps per block of either warp-tile forward
constexpr int FWD_THREADS = 32 * FWD_WARPS;
// resident blocks an SM holds: the mma kernel's ~96 registers allow 5, the
// f32 kernel's 168 (a lane's edge and its layer's outputs) and ~58 KB of
// shared memory 3; fewer was slower on the card for either
constexpr int FWD_MMA_BLOCKS_PER_SM = 5;
constexpr int FWD_F32_BLOCKS_PER_SM = 3;
constexpr int F32_ROWS = 32;               // edges per warp tile of the f32 kernel: one a lane

// f32 serving's dtypes of K5 fwd's inputs as bits: both | es << 1 | ev << 2,
// bf16 where set (DT_STEP's first three bits are the bf16 step's).
constexpr int DT_F32 = 0;

// Whether a warp-tile forward runs its served instance: the served model's
// activations (relu, none) with the dtypes of its bf16 training step or of
// f32 serving, fixed at compile time.
__host__ __device__ inline bool fwd_served_instance(int cdt_bf16, int act_s, int act_v, int dt) {
  return act_s == ACT_RELU && act_v == ACT_NONE && dt == (cdt_bf16 ? DT_STEP : DT_F32);
}

// Row strides (floats) of a warp's staged input rows of width w. The f32
// kernel's lane reads its own row as float4s: an odd count of them puts 8
// lanes' reads in distinct banks. The mma kernel's lanes read column pairs
// of rows g and g + 8: a stride of 8 more than a multiple of 16 does.
__host__ __device__ constexpr int lane_stride(int w) { return (cdiv(w, 4) | 1) * 4; }
__host__ __device__ constexpr int pair_stride(int w) { return cdiv(w - 8, 16) * 16 + 8; }

// The f32 kernel's staged weights of a layer, each matrix transposed
// ([in][out], out padded with zeros to a multiple of 4) so that one float4
// gives the weights of 4 outputs for one input: wh^T [vi][h], ws^T
// [si + h][so], bs [so], wv^T [h][vo], wsv^T [so][vo], bsv [vo].
template <class L>
struct F32Layer {
  static constexpr int HP = cdiv(L::H, 4) * 4, SOP = cdiv(L::SO, 4) * 4, VOP = cdiv(L::VO, 4) * 4;
  static constexpr int WH = 0, WS = WH + L::VI * HP, BS = WS + (L::SI + L::H) * SOP;
  static constexpr int WV = BS + SOP, WSV = WV + L::H * VOP, BSV = WSV + L::SO * VOP;
  static constexpr int N = BSV + VOP;
};

// Byte offsets in a block's shared memory of a warp-tile forward for
// n_layers layers: the staged weights of layer 0 and then of each later
// layer (mma: the B fragments of the forward products, then the biases;
// f32: F32Layer, biases included), then each warp's staging of its tile's
// input rows (both's source rows, es, both's destination rows, ev), which
// also stages the tile's output rows.
struct FwdSmem {
  int b1, bias0, bias1, warp0, per_warp, total;
};

template <class Net>
__host__ __device__ inline FwdSmem fwd_warp_smem(int n_layers, bool mma) {
  using L0 = typename Net::L0;
  using L1 = typename Net::L1;
  constexpr int FB = Net::NS + 3 * Net::NV, SE = Net::SE, EV = 3 * Net::VE;
  const int m = n_layers - 1;
  FwdSmem s;
  if (mma) {
    s.b1 = L0::WSV_B * 256;
    s.bias0 = s.b1 + m * L1::WSV_B * 256;
    s.bias1 = s.bias0 + 4 * L0::BIAS;
    s.warp0 = (s.bias1 + 4 * m * L1::BIAS + 15) / 16 * 16;
    s.per_warp = (4 * MMA_ROWS * (2 * pair_stride(FB) + pair_stride(SE) + EV) + 15) / 16 * 16;
  } else {
    s.b1 = 4 * F32Layer<L0>::N;
    s.bias0 = s.bias1 = 0;
    s.warp0 = s.b1 + 4 * m * F32Layer<L1>::N;
    s.per_warp = 4 * F32_ROWS * (2 * lane_stride(FB) + lane_stride(SE) + lane_stride(EV));
  }
  s.total = s.warp0 + FWD_WARPS * s.per_warp;
  return s;
}

// A warp's tile of edges: its first edge r0 split into (b0, j0) once; edge e
// of the tile is (b0, j0 + e) until that passes E.
struct TileEdges {
  int64_t r0, b0;
  int j0, E, n;   // n: the tile's edges (none past R)
  __device__ __forceinline__ TileEdges(int64_t r, int64_t R, int e, int rows) : r0(r), E(e) {
    b0 = r < ((int64_t)1 << 32) ? (int64_t)((uint32_t)r / (uint32_t)e) : r / e;
    j0 = (int)(r - b0 * e);
    n = (int)(R - r < rows ? R - r : rows);
  }
  // the row of both ([B, 2E, F]) that holds edge e's source node; its
  // destination's is E rows on
  __device__ __forceinline__ int64_t src(int e) const {
    int j = j0 + e;
    int64_t b = b0;
    if (j >= E) {
      const int q = j / E;
      b += q;
      j -= q * E;
    }
    return b * 2 * (int64_t)E + j;
  }
  // whether the tile lies in one graph, so its source rows are one run of
  // both's rows, and its destination rows another
  __device__ __forceinline__ bool one_graph() const { return j0 + n <= E; }
};

// A warp's tile of T rows row(0) .. row(n - 1) of a [*, W] tensor (f32, or
// bf16 where set) as f32: element p = lane + 32 k of the tile in x[k], 0 past
// its n W elements. The lanes read neighbouring elements, and every load is
// issued before any is waited on. run: the rows are first, first + 1, ...
template <int W, int T>
struct Rows {
  static constexpr int K = cdiv(T * W, 32);
  float x[K];

  template <class Row>
  __device__ __forceinline__ void fetch(const void* base, int bf16, bool run, int64_t first,
                                        Row row, int n, int lane) {
    if (run) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int p = lane + 32 * k;
        x[k] = p < n * W ? load(base, first * W + p, bf16) : 0.f;
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int p = lane + 32 * k, e = p / W;
        x[k] = p < n * W ? load(base, row(e) * W + (p - e * W), bf16) : 0.f;
      }
    }
  }

  // into dst [T][S]
  template <int S>
  __device__ __forceinline__ void put(float* dst, int lane) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int p = lane + 32 * k, e = p / W;
      if (p < T * W) dst[e * S + (p - e * W)] = x[k];
    }
  }
};

// Stage the warp's tile of T edges in st as f32: both's source rows [T][SB],
// es [T][SS], both's destination rows [T][SB], ev [T][SV]; rows past the
// tile's edges hold zeros.
template <class Net, int T, int SB, int SS, int SV>
__device__ __forceinline__ void stage_tile(const Inputs& in, const TileEdges& t, float* st,
                                           int lane) {
  constexpr int FB = Net::NS + 3 * Net::NV;
  const bool run = t.one_graph();
  const int64_t src0 = t.src(0), E = in.E;
  Rows<FB, T> src, dst;
  Rows<Net::SE, T> es;
  Rows<3 * Net::VE, T> ev;
  const auto none = [](int) { return (int64_t)0; };
  src.fetch(in.both, in.both_bf16, run, src0, [&](int e) { return t.src(e); }, t.n, lane);
  es.fetch(in.es, in.es_bf16, true, t.r0, none, t.n, lane);
  dst.fetch(in.both, in.both_bf16, run, src0 + E, [&](int e) { return t.src(e) + E; }, t.n, lane);
  ev.fetch(in.ev, in.ev_bf16, true, t.r0, none, t.n, lane);
  warp_sync();   // every lane is done with the staging's last contents
  src.template put<SB>(st, lane);
  es.template put<SS>(st + T * SB, lane);
  dst.template put<SB>(st + T * (SB + SS), lane);
  ev.template put<SV>(st + T * (2 * SB + SS), lane);
  warp_sync();
}

// The warp writes its tile's n output rows, staged in st as f32 [n][FO], to
// out (f32, or bf16 where set) from row r0, the lanes on neighbouring
// elements.
template <int T, int FO>
__device__ __forceinline__ void write_tile(const float* st, void* out, int bf16, int64_t r0, int n,
                                           int lane) {
#pragma unroll
  for (int k = 0; k < cdiv(T * FO, 32); ++k) {
    const int p = lane + 32 * k;
    if (p < n * FO) store(out, r0 * FO + p, st[p], bf16);
  }
}

// ---- K5 fwd with the f32 compute dtype: a lane per edge, FFMA ----

// dst[k * NP + n] = w[k * sk + n * sn] for k < K, n < N, and 0 for N <= n < NP
__device__ void stage_t(const float* __restrict__ w, int K, int N, int NP, int sk, int sn,
                        float* dst) {
  for (int p = threadIdx.x; p < K * NP; p += blockDim.x) {
    const int k = p / NP, n = p - k * NP;
    dst[p] = n < N ? w[k * sk + n * sn] : 0.f;
  }
}

template <class L>
__device__ void stage_layer_f32(const float* __restrict__ w, float* W) {
  using F = F32Layer<L>;
  constexpr int SH = L::SI + L::H;
  stage_t(w + L::P_WH, L::VI, L::H, F::HP, 1, L::VI, W + F::WH);
  stage_t(w + L::P_WS, SH, L::SO, F::SOP, 1, SH, W + F::WS);
  stage_t(w + L::P_BS, 1, L::SO, F::SOP, 0, 1, W + F::BS);
  stage_t(w + L::P_WV, L::H, L::VO, F::VOP, 1, L::H, W + F::WV);
  stage_t(w + L::P_WSV, L::SO, L::VO, F::VOP, 1, L::SO, W + F::WSV);
  stage_t(w + L::P_BSV, 1, L::VO, F::VOP, 0, 1, W + F::BSV);
}

// N floats of a staged row (16-byte aligned) into x
template <int N>
__device__ __forceinline__ void read_row(const float* p, float (&x)[N]) {
#pragma unroll
  for (int u = 0; u < N / 4; ++u) {
    const float4 f = reinterpret_cast<const float4*>(p)[u];
    x[4 * u] = f.x;
    x[4 * u + 1] = f.y;
    x[4 * u + 2] = f.z;
    x[4 * u + 3] = f.w;
  }
#pragma unroll
  for (int i = N / 4 * 4; i < N; ++i) x[i] = p[i];
}

// acc[4q + c] += x w[c] for the outputs 4q + c < N of the float4 w
template <int N>
__device__ __forceinline__ void mac4(float (&acc)[N], int q, float x, const float4& w) {
  const float wc[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (4 * q + c < N) acc[4 * q + c] += x * wc[c];
  }
}

// A layer's forward activations on a lane's edge, as its backward needs them.
template <class L>
struct FwdF32 {
  float vh[3][L::H], q[L::H], vn[L::H], sp[L::SO], vr[3][L::VO], g[L::VO];
};

// One gated GVP layer on a lane's edge (the JAX _layer_fwd in f32): s4(k4)
// gives its scalar inputs s[4 k4 .. 4 k4 + 3] (read where the products need
// them), v ([xyz][channel]) its vector inputs, W its staged weights
// (F32Layer). Each output is one multiply-add chain over its inputs in
// ascending order, the scalars before the norms, its bias added last, with
// IEEE sqrt, exp and division: the arithmetic of the block-tile kernel, whose
// bits it gives.
template <class L, class S4>
__device__ __forceinline__ void layer_f32_keep(const float* __restrict__ W, int act_v, S4 s4,
                                               const float (&v)[3][L::VI], FwdF32<L>& f) {
  static_assert(L::SI % 4 == 0, "the scalar inputs come 4 at a time");
  using F = F32Layer<L>;
  const float4* w4 = reinterpret_cast<const float4*>(W);
  // vh = wh v, each of xyz
#pragma unroll
  for (int d = 0; d < 3; ++d) {
#pragma unroll
    for (int j = 0; j < L::H; ++j) f.vh[d][j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < L::VI; ++i) {
#pragma unroll
    for (int q = 0; q < F::HP / 4; ++q) {
      const float4 w = w4[(F::WH + i * F::HP) / 4 + q];
#pragma unroll
      for (int d = 0; d < 3; ++d) mac4(f.vh[d], q, v[d][i], w);
    }
  }
  // the clamped norm over xyz; vraw = wv vh
#pragma unroll
  for (int j = 0; j < L::H; ++j) {
    const float x = f.vh[0][j], y = f.vh[1][j], z = f.vh[2][j];
    const float qq = x * x + y * y + z * z;
    f.q[j] = qq;
    f.vn[j] = sqrtf(fmaxf(qq, EPS));
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
#pragma unroll
    for (int o = 0; o < L::VO; ++o) f.vr[d][o] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < L::H; ++j) {
#pragma unroll
    for (int q = 0; q < F::VOP / 4; ++q) {
      const float4 w = w4[(F::WV + j * F::VOP) / 4 + q];
#pragma unroll
      for (int d = 0; d < 3; ++d) mac4(f.vr[d], q, f.vh[d][j], w);
    }
  }
  // spre = ws [s, vn] + bs
#pragma unroll
  for (int o = 0; o < L::SO; ++o) f.sp[o] = 0.f;
#pragma unroll
  for (int k4 = 0; k4 < L::SI / 4; ++k4) {
    const float4 x4 = s4(k4);
    const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int q = 0; q < F::SOP / 4; ++q) {
        mac4(f.sp, q, x[c], w4[(F::WS + (4 * k4 + c) * F::SOP) / 4 + q]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < L::H; ++k) {
#pragma unroll
    for (int q = 0; q < F::SOP / 4; ++q) {
      mac4(f.sp, q, f.vn[k], w4[(F::WS + (L::SI + k) * F::SOP) / 4 + q]);
    }
  }
#pragma unroll
  for (int o = 0; o < L::SO; ++o) f.sp[o] = f.sp[o] + W[F::BS + o];
  // the gate reads the pre-activation scalars through the vector activation
  float z[L::VO];
#pragma unroll
  for (int o = 0; o < L::VO; ++o) z[o] = 0.f;
#pragma unroll
  for (int i = 0; i < L::SO; ++i) {
    const float gi = act(act_v, f.sp[i]);
#pragma unroll
    for (int q = 0; q < F::VOP / 4; ++q) mac4(z, q, gi, w4[(F::WSV + i * F::VOP) / 4 + q]);
  }
#pragma unroll
  for (int o = 0; o < L::VO; ++o) f.g[o] = sigmoid(z[o] + W[F::BSV + o]);
}

// The layer's outputs s' = act_s(spre), v' = vraw * gate.
template <class L>
__device__ __forceinline__ void layer_f32_out(const FwdF32<L>& f, int act_s, float (&s_out)[L::SO],
                                              float (&v_out)[3][L::VO]) {
#pragma unroll
  for (int o = 0; o < L::VO; ++o) {
#pragma unroll
    for (int d = 0; d < 3; ++d) v_out[d][o] = f.vr[d][o] * f.g[o];
  }
#pragma unroll
  for (int o = 0; o < L::SO; ++o) s_out[o] = act(act_s, f.sp[o]);
}

template <class L, class S4>
__device__ __forceinline__ void layer_f32_s4(const float* __restrict__ W, int act_s, int act_v,
                                             S4 s4, const float (&v)[3][L::VI],
                                             float (&s_out)[L::SO], float (&v_out)[3][L::VO]) {
  FwdF32<L> f;
  layer_f32_keep<L>(W, act_v, s4, v, f);
  layer_f32_out<L>(f, act_s, s_out, v_out);
}

template <class L>
__device__ __forceinline__ void layer_f32(const float* __restrict__ W, int act_s, int act_v,
                                          const float (&s)[L::SI], const float (&v)[3][L::VI],
                                          float (&s_out)[L::SO], float (&v_out)[3][L::VO]) {
  layer_f32_s4<L>(
      W, act_s, act_v,
      [&](int k4) { return make_float4(s[4 * k4], s[4 * k4 + 1], s[4 * k4 + 2], s[4 * k4 + 3]); },
      v, s_out, v_out);
}

// ACT_S, ACT_V and DT (both | es << 1 | ev << 2, bf16 where set) fix the
// activations and dtypes at compile time where they are >= 0; -1 takes them
// from the arguments. out [R, FO] in both's dtype.
template <class Net, int ACT_S, int ACT_V, int DT>
__global__ void __launch_bounds__(FWD_THREADS, FWD_F32_BLOCKS_PER_SM)
message_fwd_f32_kernel(Inputs in, int n_layers, const float* __restrict__ w, int act_s, int act_v,
                       void* __restrict__ out) {
  if constexpr (ACT_S >= 0) act_s = ACT_S;
  if constexpr (ACT_V >= 0) act_v = ACT_V;
  if constexpr (DT >= 0) {
    in.both_bf16 = DT & 1;
    in.es_bf16 = (DT >> 1) & 1;
    in.ev_bf16 = (DT >> 2) & 1;
  }
  using L0 = typename Net::L0;
  using L1 = typename Net::L1;
  constexpr int NS = Net::NS, NV = Net::NV, SE = Net::SE, VE = Net::VE;
  constexpr int FB = NS + 3 * NV, SO = L0::SO, VO = L0::VO, FO = SO + 3 * VO, T = F32_ROWS;
  constexpr int SB = lane_stride(FB), SS = lane_stride(SE), SV = lane_stride(3 * VE);
  static_assert(FO % 4 == 0 && FO <= 2 * SB + SS + SV, "output rows are staged as float4s");
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  const FwdSmem s = fwd_warp_smem<Net>(n_layers, false);
  float* const W0 = reinterpret_cast<float*>(smem_bytes);
  auto w_of = [&](int k) {
    return reinterpret_cast<float*>(smem_bytes + s.b1) + (k - 1) * F32Layer<L1>::N;
  };
  stage_layer_f32<L0>(w, W0);
  for (int k = 1; k < n_layers; ++k) stage_layer_f32<L1>(w + L0::NW + (k - 1) * L1::NW, w_of(k));
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* const st = reinterpret_cast<float*>(smem_bytes + s.warp0 + warp * s.per_warp);
  const int64_t n_tiles = (in.R + T - 1) / T;
  const int64_t stride = (int64_t)gridDim.x * FWD_WARPS;
  for (int64_t tile = (int64_t)blockIdx.x * FWD_WARPS + warp; tile < n_tiles; tile += stride) {
    const TileEdges t(tile * T, in.R, in.E, T);
    stage_tile<Net, T, SB, SS, SV>(in, t, st, lane);
    // the lane's edge, row `lane` of the tile: s = (s_j, es, s_i), v = (v_j, ev, v_i)
    float rj[FB], re[SE], ri[FB], rv[3 * VE];
    read_row(st + lane * SB, rj);
    read_row(st + T * SB + lane * SS, re);
    read_row(st + T * (SB + SS) + lane * SB, ri);
    read_row(st + T * (2 * SB + SS) + lane * SV, rv);
    float xs[L0::SI], xv[3][L0::VI];
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      xs[c] = rj[c];
      xs[NS + SE + c] = ri[c];
    }
#pragma unroll
    for (int c = 0; c < SE; ++c) xs[NS + c] = re[c];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        xv[d][i] = rj[NS + 3 * i + d];
        xv[d][NV + VE + i] = ri[NS + 3 * i + d];
      }
#pragma unroll
      for (int i = 0; i < VE; ++i) xv[d][NV + i] = rv[3 * i + d];
    }
    float ys[SO], yv[3][VO];
    {
      const bool last = n_layers == 1;
      layer_f32<L0>(W0, last ? ACT_NONE : act_s, last ? ACT_NONE : act_v, xs, xv, ys, yv);
    }
    for (int k = 1; k < n_layers; ++k) {
      const bool last = k == n_layers - 1;
      float zs[SO], zv[3][VO];
      layer_f32<L1>(w_of(k), last ? ACT_NONE : act_s, last ? ACT_NONE : act_v, ys, yv, zs, zv);
#pragma unroll
      for (int o = 0; o < SO; ++o) ys[o] = zs[o];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
#pragma unroll
        for (int o = 0; o < VO; ++o) yv[d][o] = zv[d][o];
      }
    }
    // the lane's output row [s', v'] into the staging, then the tile's rows out
    float o[FO];
#pragma unroll
    for (int c = 0; c < SO; ++c) o[c] = ys[c];
#pragma unroll
    for (int i = 0; i < VO; ++i) {
#pragma unroll
      for (int d = 0; d < 3; ++d) o[SO + 3 * i + d] = yv[d][i];
    }
    warp_sync();   // every lane has read its inputs
#pragma unroll
    for (int u = 0; u < FO / 4; ++u) {
      reinterpret_cast<float4*>(st + lane * FO)[u] =
          make_float4(o[4 * u], o[4 * u + 1], o[4 * u + 2], o[4 * u + 3]);
    }
    warp_sync();
    write_tile<T, FO>(st, out, in.both_bf16, t.r0, t.n, lane);
  }
}

// ---- K5 bwd with the f32 compute dtype: a lane per edge, FFMA ----

constexpr int BWD_F32_WARPS = 8;   // most warps a block; one block an SM
constexpr int BWD_F32_THREADS = 32 * BWD_F32_WARPS;

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// y[0..N) to p[i..i + N) (f32, or bf16 where set): float4 stores where f32
// and 16-byte aligned, else one element at a time
template <int N>
__device__ __forceinline__ void store_n(void* p, int64_t i, const float (&y)[N], int bf16) {
  if (!bf16 && N % 4 == 0 && reinterpret_cast<uintptr_t>(static_cast<float*>(p) + i) % 16 == 0) {
#pragma unroll
    for (int u = 0; u < N / 4; ++u) {
      reinterpret_cast<float4*>(static_cast<float*>(p) + i)[u] =
          make_float4(y[4 * u], y[4 * u + 1], y[4 * u + 2], y[4 * u + 3]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < N; ++c) store(p, i + c, y[c], bf16);
  }
}

// A layer's weight-gradient operands in an operand row, three groups one
// after the other: first dspre [SO], act_v(spre) [SO], dz [VO, padded to 4],
// vn [H] and a constant 1 (the bias column); then vraw's cotangent [3VO] and
// vh [3H]; then dvh [3H], each (channel, xyz) interleaved.
template <class L>
struct BwdOps {
  static constexpr int DSP = 0, GI = L::SO, DZ = 2 * L::SO, VN = DZ + cdiv(L::VO, 4) * 4;
  static constexpr int ONE = VN + L::H, A = ONE + 1;
  static constexpr int DVR = 0, VH = cdiv(3 * L::VO, 4) * 4, B = VH + 3 * L::H, C = 3 * L::H;
  static constexpr int W = cmax(A, cmax(B, C));
};

// The f32 backward's rows: a warp's tile has an input row per edge in its
// shared memory, [both's source row | es | both's destination row | ev] at
// row stride SX (later the inputs of layers 1, 2, ... at FO floats each),
// and an operand row per edge at row stride BO: first the edge's dout, then
// each layer's weight-gradient operands, a group at a time (OB_* below).
template <class Net>
struct BwdF32 {
  using L0 = typename Net::L0;
  using L1 = typename Net::L1;
  static constexpr int NS = Net::NS, NV = Net::NV, SE = Net::SE, VE = Net::VE;
  static constexpr int FB = NS + 3 * NV, EV = 3 * VE, FO = L0::SO + 3 * L0::VO;
  static constexpr int O_ES = FB, O_DST = FB + SE, O_EV = 2 * FB + SE;
  static constexpr int SX = lane_stride(O_EV + EV);
  static constexpr int MAX_LAYERS = 1 + SX / FO;
  static constexpr int BO = lane_stride(cmax(FO, cmax(BwdOps<L0>::W, BwdOps<L1>::W)));
  static_assert(FB % 4 == 0 && SE % 4 == 0 && L0::SI % 4 == 0 && L1::SI % 4 == 0,
                "the input rows' parts and the chunks of ds_in are read and written as float4s");
};

// Byte offsets in a block's shared memory of the f32 backward for n_layers
// layers: the staged weights (F32Layer, as the f32 forward's), then `warps`
// warps' regions of `per_warp` bytes: input rows, operand rows, and the
// warp's weight-gradient slab (n_w floats in the packed layout). `warps` is
// the most of BWD_F32_WARPS that the block's shared memory holds (0: the
// shape is not taken).
struct BwdF32Smem {
  int b1, warp0, per_warp, warps, total;
};

template <class Net>
__host__ __device__ inline BwdF32Smem bwd_f32_smem(int n_layers) {
  using Z = BwdF32<Net>;
  using L0 = typename Net::L0;
  using L1 = typename Net::L1;
  BwdF32Smem s;
  s.b1 = 4 * F32Layer<L0>::N;
  s.warp0 = s.b1 + 4 * (n_layers - 1) * F32Layer<L1>::N;
  s.per_warp = 4 * (32 * (Z::SX + Z::BO) + cdiv(L0::NW + (n_layers - 1) * L1::NW, 4) * 4);
  s.warps = n_layers > Z::MAX_LAYERS ? 0 : (MAX_SMEM - s.warp0) / s.per_warp;
  if (s.warps > BWD_F32_WARPS) s.warps = BWD_F32_WARPS;
  s.total = s.warp0 + s.warps * s.per_warp;
  return s;
}

// Whether the f32 backward runs its served instance: (relu, none) with every
// tensor f32 (dt: both | es << 1 | ev << 2 | dout << 3, bf16 where set).
__host__ __device__ inline bool bwd_f32_served_instance(int act_s, int act_v, int dt) {
  return act_s == ACT_RELU && act_v == ACT_NONE && dt == 0;
}

// The chain acc = sum over k < N, ascending, of x[k] row[k], for the first N
// floats of a 16-byte-aligned staged row (one float4 broadcast per 4 terms).
template <int N>
__device__ __forceinline__ float dot_row(const float* __restrict__ row, const float (&x)[N]) {
  float acc = 0.f;
#pragma unroll
  for (int u = 0; u < cdiv(N, 4); ++u) {
    const float4 w = reinterpret_cast<const float4*>(row)[u];
    const float wc[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (4 * u + c < N) acc += x[4 * u + c] * wc[c];
    }
  }
  return acc;
}

// The same for each of xyz: acc[d] = sum over k < N of x[d][k] row[k].
template <int N>
__device__ __forceinline__ void dot_row3(const float* __restrict__ row, const float (&x)[3][N],
                                         float (&acc)[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) acc[d] = 0.f;
#pragma unroll
  for (int u = 0; u < cdiv(N, 4); ++u) {
    const float4 w = reinterpret_cast<const float4*>(row)[u];
    const float wc[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        if (4 * u + c < N) acc[d] += x[d][4 * u + c] * wc[c];
      }
    }
  }
}

// N floats into a 16-byte-aligned row, as float4s (N a multiple of 4)
template <int N>
__device__ __forceinline__ void write_row(float* p, const float (&x)[N]) {
  static_assert(N % 4 == 0, "whole float4s");
#pragma unroll
  for (int u = 0; u < N / 4; ++u) {
    reinterpret_cast<float4*>(p)[u] =
        make_float4(x[4 * u], x[4 * u + 1], x[4 * u + 2], x[4 * u + 3]);
  }
}

__host__ __device__ constexpr int pow2_at_least(int x) {
  return x <= 1 ? 1 : 2 * pow2_at_least((x + 1) / 2);
}

// A weight-gradient pass over the tile's n edges: the warp's lanes are NB
// blocks of gradient entries times S = 32 / NB groups of edges (lane = b +
// NB g); group g takes the edges g, g + S, ... and step(e) adds edge e's
// products to the lane's sums acc, and the groups' sums are then added by an
// xor butterfly (a fixed order: every lane of a block gets the same bits).
template <int NB, int N, class Step>
__device__ __forceinline__ void edge_pass(float (&acc)[N], int lane, int n, Step step) {
  constexpr int S = 32 / NB;
  static_assert(NB * S == 32, "NB is a power of 2");
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
#pragma unroll 2
  for (int e = lane / NB; e < n; e += S) step(e);
#pragma unroll
  for (int m = NB; m < 32; m *= 2) {
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] += shfl_xor(acc[i], m);
  }
}

// The backward of one layer on a lane's edge (the JAX _layer_bwd in f32),
// after its forward f was recomputed. ds, dv: the cotangents of its outputs.
// Each input cotangent is one multiply-add chain in the order of the
// block-tile layer_bwd, so it has that kernel's bits: ds_in goes to
// sink_s(k0, 4 values) for k0 = 0, 4, ... < SI, dv_in to dv_in. The weight
// gradients of the tile's n edges are added to the warp's slab (the layer's
// packed layout): each lane writes its edge's operands to its row of `ob`,
// then the lanes split the gradient entries and the edges (edge_pass). Edge
// e's inputs are in rows + e * sx: s at in_s(k), v at in_v(i) + xyz.
template <class L, int BO, class InS, class InV, class SinkS>
__device__ __forceinline__ void layer_bwd_f32(const float* __restrict__ W, int act_s, int act_v,
                                              const FwdF32<L>& f, const float (&ds)[L::SO],
                                              const float (&dv)[3][L::VO], const float* rows,
                                              int sx, InS in_s, InV in_v, float* ob, float* slab,
                                              int lane, int n, SinkS sink_s,
                                              float (&dv_in)[3][L::VI]) {
  using F = F32Layer<L>;
  using Op = BwdOps<L>;
  constexpr int SI = L::SI, VI = L::VI, H = L::H, SO = L::SO, VO = L::VO, SH = SI + H;
  static_assert(SO % 4 == 0, "dspre is read as float4s");
  float* const mine = ob + lane * BO;
  // the gate: dvraw = dv g, dz = (dv . vraw) g (1 - g)
  float dvr[3][VO], dz[VO];
#pragma unroll
  for (int o = 0; o < VO; ++o) {
    const float gg = f.g[o];
    float dg = 0.f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      dg += dv[d][o] * f.vr[d][o];
      dvr[d][o] = dv[d][o] * gg;
    }
    dz[o] = dg * gg * (1.f - gg);
  }
  // dspre = ds act_s'(spre) + (Wsv^T dz) act_v'(spre)
  float dsp[SO];
#pragma unroll
  for (int i = 0; i < SO; ++i) {
    const float dgi = dot_row<VO>(W + F::WSV + i * F::VOP, dz);
    const float x = f.sp[i];
    dsp[i] = fmaf(ds[i], dact(act_s, x), dgi * dact(act_v, x));   // as layer_bwd writes it
  }
  // operands 1: the gradients of ws (the inputs and vn against dspre) and
  // bs (the constant column), of wsv (act_v(spre) against dz) and bsv
  {
    float row[cdiv(Op::A, 4) * 4];
#pragma unroll
    for (int o = 0; o < SO; ++o) {
      row[Op::DSP + o] = dsp[o];
      row[Op::GI + o] = act(act_v, f.sp[o]);
    }
#pragma unroll
    for (int o = 0; o < Op::VN - Op::DZ; ++o) row[Op::DZ + o] = o < VO ? dz[o] : 0.f;
#pragma unroll
    for (int j = 0; j < H; ++j) row[Op::VN + j] = f.vn[j];
#pragma unroll
    for (int c = Op::ONE; c < cdiv(Op::A, 4) * 4; ++c) row[c] = 1.f;
    write_row(mine, row);
  }
  warp_sync();
  {
    // columns [inputs s, vn, 1] of ws and bs against dspre: 32 columns a
    // pass, a lane each, then the last ones a lane each in NB-lane blocks
    constexpr int K = SH + 1, FULL = K / 32, REST = K - 32 * FULL;
    auto col = [&](int k, int e) {
      return k < SI ? rows[e * sx + in_s(k)]
                    : ob[e * BO + (k < SH ? Op::VN + k - SI : Op::ONE)];
    };
    auto add = [&](int k, const float (&acc)[SO]) {
#pragma unroll
      for (int o = 0; o < SO; ++o) slab[k < SH ? L::P_WS + o * SH + k : L::P_BS + o] += acc[o];
    };
    if constexpr (FULL > 0) {
      float acc[FULL * SO];
      edge_pass<32>(acc, lane, n, [&](int e) {
        float y[SO];
        read_row(ob + e * BO + Op::DSP, y);
#pragma unroll
        for (int m = 0; m < FULL; ++m) {
          const float x = col(lane + 32 * m, e);
#pragma unroll
          for (int o = 0; o < SO; ++o) acc[m * SO + o] += x * y[o];
        }
      });
#pragma unroll
      for (int m = 0; m < FULL; ++m) {
        float a[SO];
#pragma unroll
        for (int o = 0; o < SO; ++o) a[o] = acc[m * SO + o];
        add(lane + 32 * m, a);
      }
    }
    if constexpr (REST > 0) {
      constexpr int NB = pow2_at_least(REST);
      const int c = lane % NB, k = 32 * FULL + (c < REST ? c : REST - 1);
      float acc[SO];
      edge_pass<NB>(acc, lane, n, [&](int e) {
        float y[SO];
        read_row(ob + e * BO + Op::DSP, y);
        const float x = col(k, e);
#pragma unroll
        for (int o = 0; o < SO; ++o) acc[o] += x * y[o];
      });
      if (lane < REST) add(k, acc);
    }
  }
  {
    // columns [act_v(spre), 1] of wsv and bsv against dz, a lane each
    constexpr int K = SO + 1, NB = pow2_at_least(K);
    static_assert(NB == 32, "one pass of a lane a column");
    const int i = lane < SO ? lane : SO;
    float acc[VO];
    edge_pass<NB>(acc, lane, n, [&](int e) {
      float y[cdiv(VO, 4) * 4];
      read_row(ob + e * BO + Op::DZ, y);
      const float x = ob[e * BO + (i < SO ? Op::GI + i : Op::ONE)];
#pragma unroll
      for (int o = 0; o < VO; ++o) acc[o] += x * y[o];
    });
    if (lane <= SO) {
#pragma unroll
      for (int o = 0; o < VO; ++o) slab[i < SO ? L::P_WSV + o * SO + i : L::P_BSV + o] += acc[o];
    }
  }
  warp_sync();
  // operands 2: the gradient of wv (vh against dvraw)
  {
    float row[cdiv(Op::B, 4) * 4];
#pragma unroll
    for (int c = 0; c < cdiv(Op::B, 4) * 4; ++c) row[c] = 0.f;
#pragma unroll
    for (int o = 0; o < VO; ++o) {
#pragma unroll
      for (int d = 0; d < 3; ++d) row[Op::DVR + 3 * o + d] = dvr[d][o];
    }
#pragma unroll
    for (int j = 0; j < H; ++j) {
#pragma unroll
      for (int d = 0; d < 3; ++d) row[Op::VH + 3 * j + d] = f.vh[d][j];
    }
    write_row(mine, row);
  }
  warp_sync();
  {
    // rows j of wv^T, a lane each, against dvraw
    constexpr int NB = pow2_at_least(H);
    const int c = lane % NB, j = c < H ? c : H - 1;
    float acc[VO];
    edge_pass<NB>(acc, lane, n, [&](int e) {
      const float* r = ob + e * BO;
      float y[cdiv(3 * VO, 4) * 4];
      read_row(r + Op::DVR, y);
      const float x[3] = {r[Op::VH + 3 * j], r[Op::VH + 3 * j + 1], r[Op::VH + 3 * j + 2]};
#pragma unroll
      for (int o = 0; o < VO; ++o) {
#pragma unroll
        for (int d = 0; d < 3; ++d) acc[o] += x[d] * y[3 * o + d];
      }
    });
    if (lane < H) {
#pragma unroll
      for (int o = 0; o < VO; ++o) slab[L::P_WV + o * H + j] += acc[o];
    }
  }
  warp_sync();
  // dvh = Wv^T dvraw; dsin = Ws^T dspre: ds_in to the sink, 4 at a time,
  // then dvn
  float dvh[3][H];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    float y[3];
    dot_row3<VO>(W + F::WV + j * F::VOP, dvr, y);
#pragma unroll
    for (int d = 0; d < 3; ++d) dvh[d][j] = y[d];
  }
#pragma unroll
  for (int k0 = 0; k0 < SI; k0 += 4) {
    float y[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) y[c] = dot_row<SO>(W + F::WS + (k0 + c) * F::SOP, dsp);
    sink_s(k0, y);
  }
  float dvn[H];
#pragma unroll
  for (int j = 0; j < H; ++j) dvn[j] = dot_row<SO>(W + F::WS + (SI + j) * F::SOP, dsp);
  // the norm: dvh += vh dvn / vn where |vh|^2 > eps (0 inside the clamp)
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float coef = f.q[j] > EPS ? dvn[j] / f.vn[j] : 0.f;
#pragma unroll
    for (int d = 0; d < 3; ++d) dvh[d][j] += f.vh[d][j] * coef;
  }
  // operands 3: the gradient of wh (the input vectors against dvh)
  {
    float row[cdiv(Op::C, 4) * 4];
#pragma unroll
    for (int c = Op::C; c < cdiv(Op::C, 4) * 4; ++c) row[c] = 0.f;
#pragma unroll
    for (int j = 0; j < H; ++j) {
#pragma unroll
      for (int d = 0; d < 3; ++d) row[3 * j + d] = dvh[d][j];
    }
    write_row(mine, row);
  }
  warp_sync();
  {
    // columns i of wh, a lane each, against dvh
    constexpr int NB = pow2_at_least(VI);
    const int c = lane % NB, i = c < VI ? c : VI - 1;
    const int vi = in_v(i);
    float acc[H];
    edge_pass<NB>(acc, lane, n, [&](int e) {
      float y[cdiv(3 * H, 4) * 4];
      read_row(ob + e * BO, y);
      const float* r = rows + e * sx + vi;
      const float x[3] = {r[0], r[1], r[2]};
#pragma unroll
      for (int j = 0; j < H; ++j) {
#pragma unroll
        for (int d = 0; d < 3; ++d) acc[j] += x[d] * y[3 * j + d];
      }
    });
    if (lane < VI) {
#pragma unroll
      for (int j = 0; j < H; ++j) slab[L::P_WH + j * VI + i] += acc[j];
    }
  }
  warp_sync();
  // dv_in = Wh^T dvh
#pragma unroll
  for (int i = 0; i < VI; ++i) {
    float y[3];
    dot_row3<H>(W + F::WH + i * F::HP, dvh, y);
#pragma unroll
    for (int d = 0; d < 3; ++d) dv_in[d][i] = y[d];
  }
}

// Stage the warp's tile in its input rows [T][SX] (both's source row, es,
// both's destination row, ev; rows past the tile's edges hold zeros) and,
// where dout is given, its dout rows in its operand rows [T][BO].
template <class Net, int T>
__device__ __forceinline__ void stage_bwd_rows(const Inputs& in, const TileEdges& t, float* rows,
                                               const void* dout, int dout_bf16, float* ob,
                                               int lane) {
  using Z = BwdF32<Net>;
  const bool run = t.one_graph();
  const int64_t src0 = t.src(0), E = in.E;
  Rows<Z::FB, T> src, dst;
  Rows<Z::SE, T> es;
  Rows<Z::EV, T> ev;
  Rows<Z::FO, T> d;
  const auto none = [](int) { return (int64_t)0; };
  src.fetch(in.both, in.both_bf16, run, src0, [&](int e) { return t.src(e); }, t.n, lane);
  es.fetch(in.es, in.es_bf16, true, t.r0, none, t.n, lane);
  dst.fetch(in.both, in.both_bf16, run, src0 + E, [&](int e) { return t.src(e) + E; }, t.n, lane);
  ev.fetch(in.ev, in.ev_bf16, true, t.r0, none, t.n, lane);
  if (dout != nullptr) d.fetch(dout, dout_bf16, true, t.r0, none, t.n, lane);
  warp_sync();   // every lane is done with the rows' last contents
  src.template put<Z::SX>(rows, lane);
  es.template put<Z::SX>(rows + Z::O_ES, lane);
  dst.template put<Z::SX>(rows + Z::O_DST, lane);
  ev.template put<Z::SX>(rows + Z::O_EV, lane);
  if (dout != nullptr) d.template put<Z::BO>(ob, lane);
  warp_sync();
}

// The first layer's vector inputs of the lane's edge from its input row,
// v = (v_j, ev, v_i); edge_s4(row) gives its scalar inputs s = (s_j, es, s_i)
// 4 at a time.
template <class Net>
__device__ __forceinline__ void read_edge_v(const float* row, float (&xv)[3][Net::L0::VI]) {
  using Z = BwdF32<Net>;
  constexpr int NS = Net::NS, NV = Net::NV, VE = Net::VE;
  float rj[3 * NV], ri[3 * NV], rv[cdiv(Z::EV, 4) * 4];
  read_row(row + NS, rj);
  read_row(row + Z::O_DST + NS, ri);
  read_row(row + Z::O_EV, rv);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      xv[d][i] = rj[3 * i + d];
      xv[d][NV + VE + i] = ri[3 * i + d];
    }
#pragma unroll
    for (int i = 0; i < VE; ++i) xv[d][NV + i] = rv[3 * i + d];
  }
}

// where the first layer's scalar input s[k] is in an input row
template <class Net>
__host__ __device__ constexpr int edge_s_at(int k) {
  using Z = BwdF32<Net>;
  constexpr int NS = Net::NS, SE = Net::SE;
  return k < NS ? k : k < NS + SE ? Z::O_ES + k - NS : Z::O_DST + k - NS - SE;
}

template <class Net>
__device__ __forceinline__ auto edge_s4(const float* row) {
  return [row](int k4) { return reinterpret_cast<const float4*>(row + edge_s_at<Net>(4 * k4))[0]; };
}

// A later layer's inputs (s [SO], v [3][VO]) to and from its place in the
// lane's input row: s, then v (channel, xyz) interleaved.
template <class L>
__device__ __forceinline__ void put_layer_in(float* p, const float (&s)[L::SO],
                                             const float (&v)[3][L::VO]) {
  float x[L::SO + 3 * L::VO];
#pragma unroll
  for (int c = 0; c < L::SO; ++c) x[c] = s[c];
#pragma unroll
  for (int o = 0; o < L::VO; ++o) {
#pragma unroll
    for (int d = 0; d < 3; ++d) x[L::SO + 3 * o + d] = v[d][o];
  }
  write_row(p, x);
}

// a later layer's scalar inputs, 4 at a time, from its place p in a row
__device__ __forceinline__ auto layer_s4(const float* p) {
  return [p](int k4) { return reinterpret_cast<const float4*>(p)[k4]; };
}

template <class L>
__device__ __forceinline__ void get_layer_in(const float* p, float (&s)[L::SO],
                                             float (&v)[3][L::VO]) {
  float x[L::SO + 3 * L::VO];
  read_row(p, x);
#pragma unroll
  for (int c = 0; c < L::SO; ++c) s[c] = x[c];
#pragma unroll
  for (int o = 0; o < L::VO; ++o) {
#pragma unroll
    for (int d = 0; d < 3; ++d) v[d][o] = x[L::SO + 3 * o + d];
  }
}

// ACT_S, ACT_V and DT (both | es << 1 | ev << 2 | dout << 3, bf16 where set)
// fix the activations and dtypes at compile time where they are >= 0; -1
// takes them from the arguments. The tiles' outputs as message_bwd_mma_kernel's.
template <class Net, int ACT_S, int ACT_V, int DT>
__global__ void __launch_bounds__(BWD_F32_THREADS, 1)
message_bwd_f32_kernel(Inputs in, int n_layers, const float* __restrict__ w, int act_s, int act_v,
                       const void* __restrict__ dout, int dout_bf16, void* __restrict__ dboth,
                       void* __restrict__ des, void* __restrict__ dev,
                       float* __restrict__ partial, int n_w) {
  if constexpr (ACT_S >= 0) act_s = ACT_S;
  if constexpr (ACT_V >= 0) act_v = ACT_V;
  if constexpr (DT >= 0) {
    in.both_bf16 = DT & 1;
    in.es_bf16 = (DT >> 1) & 1;
    in.ev_bf16 = (DT >> 2) & 1;
    dout_bf16 = (DT >> 3) & 1;
  }
  using L0 = typename Net::L0;
  using L1 = typename Net::L1;
  using Z = BwdF32<Net>;
  constexpr int NS = Net::NS, NV = Net::NV, SE = Net::SE, VE = Net::VE;
  constexpr int FB = Z::FB, SO = L0::SO, VO = L0::VO, FO = Z::FO, T = F32_ROWS;
  constexpr int SX = Z::SX, BO = Z::BO;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  const BwdF32Smem s = bwd_f32_smem<Net>(n_layers);
  float* const W0 = reinterpret_cast<float*>(smem_bytes);
  auto w_of = [&](int k) {
    return reinterpret_cast<float*>(smem_bytes + s.b1) + (k - 1) * F32Layer<L1>::N;
  };
  stage_layer_f32<L0>(w, W0);
  for (int k = 1; k < n_layers; ++k) stage_layer_f32<L1>(w + L0::NW + (k - 1) * L1::NW, w_of(k));
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < warps * s.per_warp / 4; i += blockDim.x) {
    reinterpret_cast<float*>(smem_bytes + s.warp0)[i] = 0.f;
  }
  __syncthreads();

  float* const rows = reinterpret_cast<float*>(smem_bytes + s.warp0 + warp * s.per_warp);
  float* const ob = rows + T * SX;
  float* const slab0 = ob + T * BO;
  auto slab_of = [&](int k) { return slab0 + L0::NW + (k - 1) * L1::NW; };
  float* const mine = rows + lane * SX;
  // where a later layer k's inputs sit in an input row
  auto in_at = [&](int k) { return (k - 1) * FO; };
  const int64_t n_tiles = (in.R + T - 1) / T;
  const int64_t stride = (int64_t)gridDim.x * warps;
  for (int64_t tile = (int64_t)blockIdx.x * warps + warp; tile < n_tiles; tile += stride) {
    const TileEdges t(tile * T, in.R, in.E, T);
    stage_bwd_rows<Net, T>(in, t, rows, dout, dout_bf16, ob, lane);
    // the forward, keeping every later layer's inputs in the input rows (a
    // lane's row is its own until the next warp_sync: they take the place of
    // its edge's inputs)
    if (n_layers > 1) {
      float ys[SO], yv[3][VO];
      {
        float xv[3][L0::VI];
        read_edge_v<Net>(mine, xv);
        layer_f32_s4<L0>(W0, act_s, act_v, edge_s4<Net>(mine), xv, ys, yv);
      }
      put_layer_in<L1>(mine + in_at(1), ys, yv);
      for (int k = 1; k < n_layers - 1; ++k) {
        float zs[SO], zv[3][VO];
        layer_f32_s4<L1>(w_of(k), act_s, act_v, layer_s4(mine + in_at(k)), yv, zs, zv);
        put_layer_in<L1>(mine + in_at(k + 1), zs, zv);
#pragma unroll
        for (int d = 0; d < 3; ++d) {
#pragma unroll
          for (int o = 0; o < VO; ++o) yv[d][o] = zv[d][o];
        }
      }
    }
    // the cotangent of the last layer's output (ds [so], dv [3vo]) is in the
    // lane's operand row until the layers backwards need it
    float ds[SO], dv[3][VO];
    // the later layers backwards, each forward recomputed from its inputs
    for (int k = n_layers - 1; k >= 1; --k) {
      const bool last = k == n_layers - 1;
      const int as = last ? ACT_NONE : act_s, av = last ? ACT_NONE : act_v;
      FwdF32<L1> f;
      {
        float ys[SO], yv[3][VO];
        get_layer_in<L1>(mine + in_at(k), ys, yv);
        layer_f32_keep<L1>(w_of(k), av, layer_s4(mine + in_at(k)), yv, f);
      }
      if (last) get_layer_in<L0>(ob + lane * BO, ds, dv);
      float ds_in[SO], dv_in[3][VO];
      layer_bwd_f32<L1, BO>(
          w_of(k), as, av, f, ds, dv, rows, SX, [&](int c) { return in_at(k) + c; },
          [&](int i) { return in_at(k) + SO + 3 * i; }, ob, slab_of(k), lane, t.n,
          [&](int k0, const float (&y)[4]) {
#pragma unroll
            for (int c = 0; c < 4; ++c) ds_in[k0 + c] = y[c];
          },
          dv_in);
#pragma unroll
      for (int o = 0; o < SO; ++o) ds[o] = ds_in[o];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
#pragma unroll
        for (int o = 0; o < VO; ++o) dv[d][o] = dv_in[d][o];
      }
    }
    // the first layer: its inputs staged again (the later layers' took
    // their place) while ds, dv wait in the lane's operand row; its input
    // cotangents stored: d(both) source rows, d(es), d(both) destination
    // rows; the same for the vectors and d(ev)
    if (n_layers > 1) {
      put_layer_in<L0>(ob + lane * BO, ds, dv);
      stage_bwd_rows<Net, T>(in, t, rows, nullptr, 0, nullptr, lane);
    }
    {
      const bool last = n_layers == 1;
      const int as = last ? ACT_NONE : act_s, av = last ? ACT_NONE : act_v;
      FwdF32<L0> f;
      {
        float xv[3][L0::VI];
        read_edge_v<Net>(mine, xv);
        layer_f32_keep<L0>(W0, av, edge_s4<Net>(mine), xv, f);
      }
      get_layer_in<L0>(ob + lane * BO, ds, dv);
      const bool ok = lane < t.n;
      const int64_t r = t.r0 + lane, src = t.src(lane), dst = src + in.E;
      float dv_in[3][L0::VI];
      layer_bwd_f32<L0, BO>(
          W0, as, av, f, ds, dv, rows, SX,
          [](int k) { return edge_s_at<Net>(k); },
          [](int i) {
            return i < NV ? NS + 3 * i : i < NV + VE ? Z::O_EV + 3 * (i - NV)
                                                     : Z::O_DST + NS + 3 * (i - NV - VE);
          },
          ob, slab0, lane, t.n,
          [&](int k0, const float (&y)[4]) {
            if (!ok) return;
            if (k0 < NS) {
              store_n(dboth, src * FB + k0, y, in.both_bf16);
            } else if (k0 < NS + SE) {
              store_n(des, r * SE + (k0 - NS), y, in.es_bf16);
            } else {
              store_n(dboth, dst * FB + (k0 - NS - SE), y, in.both_bf16);
            }
          },
          dv_in);
      if (ok) {
        float vj[3 * NV], vi[3 * NV];
#pragma unroll
        for (int i = 0; i < NV; ++i) {
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            vj[3 * i + d] = dv_in[d][i];
            vi[3 * i + d] = dv_in[d][NV + VE + i];
          }
        }
        store_n(dboth, src * FB + NS, vj, in.both_bf16);
        store_n(dboth, dst * FB + NS, vi, in.both_bf16);
#pragma unroll
        for (int i = 0; i < VE; ++i) {
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            store(dev, r * 3 * VE + 3 * i + d, dv_in[d][NV + i], in.ev_bf16);
          }
        }
      }
    }
  }
  __syncthreads();
  // the block's row of weight gradients: the warps' slabs added in warp order
  for (int p = threadIdx.x; p < n_w; p += blockDim.x) {
    float sum = 0.f;
    for (int v = 0; v < warps; ++v) {
      const float* slab = reinterpret_cast<const float*>(smem_bytes + s.warp0 + v * s.per_warp);
      sum += slab[T * (SX + BO) + p];
    }
    partial[(int64_t)blockIdx.x * n_w + p] = sum;
  }
}

// ---- K5 fwd with the bf16 compute dtype: 16-edge tiles on mma.sync ----

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// As message_fwd_f32_kernel, on the layer forward of K5 bwd's warp tiles
// (fwd_mma, fwd_out): s' and v' are rounded to bf16 after every layer, the
// last included, and only then stored in out's dtype.
template <class Net, int ACT_S, int ACT_V, int DT>
__global__ void __launch_bounds__(FWD_THREADS, FWD_MMA_BLOCKS_PER_SM)
message_fwd_mma_kernel(Inputs in, int n_layers, const float* __restrict__ w, int act_s, int act_v,
                       void* __restrict__ out) {
  if constexpr (ACT_S >= 0) act_s = ACT_S;
  if constexpr (ACT_V >= 0) act_v = ACT_V;
  if constexpr (DT >= 0) {
    in.both_bf16 = DT & 1;
    in.es_bf16 = (DT >> 1) & 1;
    in.ev_bf16 = (DT >> 2) & 1;
  }
  using L0 = typename Net::L0;
  using L1 = typename Net::L1;
  constexpr int NS = Net::NS, NV = Net::NV, SE = Net::SE, VE = Net::VE;
  constexpr int FB = NS + 3 * NV, SO = L0::SO, VO = L0::VO, FO = SO + 3 * VO, T = MMA_ROWS;
  constexpr int SB = pair_stride(FB), SS = pair_stride(SE), SV = 3 * VE;
  static_assert(NS % 8 == 0 && SE % 8 == 0, "each 8 columns of s come from one input");
  static_assert(FO <= 2 * SB + SS + SV, "the output rows fit the staging");
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  const FwdSmem s = fwd_warp_smem<Net>(n_layers, true);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c0 = 2 * (lane & 3);

  uint2* const B0 = reinterpret_cast<uint2*>(smem_bytes);
  float* const bias0 = reinterpret_cast<float*>(smem_bytes + s.bias0);
  auto b_of = [&](int k) {
    return reinterpret_cast<uint2*>(smem_bytes + s.b1) + (k - 1) * L1::WSV_B * 32;
  };
  auto bias_of = [&](int k) {
    return reinterpret_cast<float*>(smem_bytes + s.bias1) + (k - 1) * L1::BIAS;
  };
  stage_layer<L0, false>(w, B0, bias0);
  for (int k = 1; k < n_layers; ++k) {
    stage_layer<L1, false>(w + L0::NW + (k - 1) * L1::NW, b_of(k), bias_of(k));
  }
  __syncthreads();

  float* const st = reinterpret_cast<float*>(smem_bytes + s.warp0 + warp * s.per_warp);
  const float* const sj = st;
  const float* const se = st + T * SB;
  const float* const si = se + T * SS;
  const float* const sv = si + T * SB;
  const int64_t n_tiles = (in.R + T - 1) / T;
  const int64_t stride = (int64_t)gridDim.x * FWD_WARPS;
  for (int64_t tile = (int64_t)blockIdx.x * FWD_WARPS + warp; tile < n_tiles; tile += stride) {
    const TileEdges t(tile * T, in.R, in.E, T);
    stage_tile<Net, T, SB, SS, SV>(in, t, st, lane);
    // the first layer's inputs as A tiles, rounded: s = (s_j, es, s_i),
    // v = (v_j, ev, v_i); a column group of 8 comes from one of them
    ATile<L0::KS> xs;
    ATile<L0::KV> xv[3];
#pragma unroll
    for (int k = 0; k < L0::KS; ++k) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = g + 8 * (q & 1), cb = 16 * k + 8 * (q >> 1);
        if (cb >= L0::SI) {
          xs.v[k][q] = 0u;
          continue;
        }
        const float* p = cb < NS        ? sj + row * SB + cb
                         : cb < NS + SE ? se + row * SS + (cb - NS)
                                        : si + row * SB + (cb - NS - SE);
        const float2 f = *reinterpret_cast<const float2*>(p + c0);
        xs.v[k][q] = pack_bf16(f.x, f.y);
      }
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
#pragma unroll
      for (int k = 0; k < L0::KV; ++k) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = g + 8 * (q & 1);
          float x[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ch = 16 * k + c0 + 8 * (q >> 1) + h, c = ch < L0::VI ? ch : L0::VI - 1;
            const float* p = c < NV        ? sj + row * SB + NS + 3 * c + d
                             : c < NV + VE ? sv + row * SV + 3 * (c - NV) + d
                                           : si + row * SB + NS + 3 * (c - NV - VE) + d;
            x[h] = ch < L0::VI ? *p : 0.f;
          }
          xv[d].v[k][q] = pack_bf16(x[0], x[1]);
        }
      }
    }
    // the layers; each one's outputs rounded are the next one's inputs
    ATile<L1::KS> ys;
    ATile<L1::KV> yv[3];
    {
      const bool last = n_layers == 1;
      Fwd<L0> f;
      fwd_mma<L0>(B0, bias0, last ? ACT_NONE : act_v, xs, xv, f, lane);
      fwd_out<L0>(f, last ? ACT_NONE : act_s, ys, yv);
    }
    for (int k = 1; k < n_layers; ++k) {
      const bool last = k == n_layers - 1;
      Fwd<L1> f;
      fwd_mma<L1>(b_of(k), bias_of(k), last ? ACT_NONE : act_v, ys, yv, f, lane);
      fwd_out<L1>(f, last ? ACT_NONE : act_s, ys, yv);
    }
    // the output rows [s', v'] into the staging as f32 [T][FO], then out
    warp_sync();   // every lane has read its inputs
#pragma unroll
    for (int k = 0; k < L1::KS; ++k) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = g + 8 * (q & 1), col = 16 * k + c0 + 8 * (q >> 1);
        if (col < SO) st[row * FO + col] = bf16_lo(ys.v[k][q]);
        if (col + 1 < SO) st[row * FO + col + 1] = bf16_hi(ys.v[k][q]);
      }
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
#pragma unroll
      for (int k = 0; k < L1::KV; ++k) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = g + 8 * (q & 1), ch = 16 * k + c0 + 8 * (q >> 1);
          if (ch < VO) st[row * FO + SO + 3 * ch + d] = bf16_lo(yv[d].v[k][q]);
          if (ch + 1 < VO) st[row * FO + SO + 3 * (ch + 1) + d] = bf16_hi(yv[d].v[k][q]);
        }
      }
    }
    warp_sync();
    write_tile<T, FO>(st, out, in.both_bf16, t.r0, t.n, lane);
  }
}

// ---------------------------------------------------------------------------
// K6: copy-cast
// ---------------------------------------------------------------------------

constexpr int K6_THREADS = 256;
constexpr int K6_BLOCKS_PER_SM = 2048 / K6_THREADS;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename TO> __device__ __forceinline__ TO from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One unit of a vectorised copy-cast: 16 bytes of the wider dtype and the
// same elements of the other, so a warp's loads and stores are each
// contiguous. The same dtype copies a word; f32 -> bf16 rounds 4 elements
// to nearest even, bf16 -> f32 widens 4 exactly.
template <typename TI, typename TO>
struct K6Unit;

template <typename T>
struct K6Unit<T, T> {
  using In = uint4;
  using Out = uint4;
  static constexpr int ELEMS = 16 / (int)sizeof(T);
  static __device__ __forceinline__ uint4 convert(const uint4& x) { return x; }
};

template <>
struct K6Unit<float, __nv_bfloat16> {
  using In = uint4;
  using Out = uint2;
  static constexpr int ELEMS = 4;
  static __device__ __forceinline__ uint2 convert(const uint4& x) {
    return make_uint2(pack_bf16(__uint_as_float(x.x), __uint_as_float(x.y)),
                      pack_bf16(__uint_as_float(x.z), __uint_as_float(x.w)));
  }
};

template <>
struct K6Unit<__nv_bfloat16, float> {
  using In = uint2;
  using Out = uint4;
  static constexpr int ELEMS = 4;
  static __device__ __forceinline__ uint4 convert(const uint2& x) {
    return make_uint4(x.x << 16, x.x & 0xffff0000u, x.y << 16, x.y & 0xffff0000u);
  }
};

// y = x for `units` units (K6Unit) of 16-byte-aligned x and y, one a thread
// a round, grid-stride; then the n - units * ELEMS elements past them, one a
// thread of block 0.
template <typename TI, typename TO>
__global__ void __launch_bounds__(K6_THREADS)
cast_vec_kernel(const TI* __restrict__ x, TO* __restrict__ y, int64_t units, int64_t n) {
  using U = K6Unit<TI, TO>;
  const typename U::In* xu = reinterpret_cast<const typename U::In*>(x);
  typename U::Out* yu = reinterpret_cast<typename U::Out*>(y);
  const int64_t stride = (int64_t)gridDim.x * K6_THREADS;
  for (int64_t u = (int64_t)blockIdx.x * K6_THREADS + threadIdx.x; u < units; u += stride) {
    yu[u] = U::convert(__ldg(xu + u));
  }
  const int64_t tail = units * U::ELEMS + threadIdx.x;
  if (blockIdx.x == 0 && tail < n) y[tail] = from_f32<TO>(to_f32(x[tail]));
}

// pointers off 16-byte alignment: one element a thread, grid-stride
template <typename TI, typename TO>
__global__ void __launch_bounds__(K6_THREADS)
cast_copy_kernel(const TI* __restrict__ x, TO* __restrict__ y, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    y[i] = from_f32<TO>(to_f32(x[i]));
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      sms = 132;
    }
  }
  return sms;
}

// The grid stays within one wave of the card (K6_BLOCKS_PER_SM blocks of
// K6_THREADS a SM); a larger tensor is walked grid-stride.
template <typename TI, typename TO>
void launch_cast(const void* x, void* y, int64_t n, cudaStream_t s) {
  const TI* xt = static_cast<const TI*>(x);
  TO* yt = static_cast<TO*>(y);
  const int64_t wave = (int64_t)sm_count() * K6_BLOCKS_PER_SM;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0) {
    const int64_t blocks = (n + K6_THREADS - 1) / K6_THREADS;
    cast_copy_kernel<TI, TO><<<(unsigned)(blocks < wave ? blocks : wave), K6_THREADS, 0, s>>>(
        xt, yt, n);
    return;
  }
  const int64_t units = n / K6Unit<TI, TO>::ELEMS;
  int64_t blocks = (units + K6_THREADS - 1) / K6_THREADS;
  blocks = blocks < 1 ? 1 : blocks > wave ? wave : blocks;
  cast_vec_kernel<TI, TO><<<(unsigned)blocks, K6_THREADS, 0, s>>>(xt, yt, units, n);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

bool valid(const int* dims, const Shape& sh) {
  if (sh.n_layers < 1 || sh.ns < 0 || sh.nv < 1 || sh.se < 0 || sh.ve < 1) return false;
  for (int k = 0; k < sh.n_layers; ++k) {
    if (dims[3 * k] < 1 || dims[3 * k + 1] < 0 || dims[3 * k + 2] < 1) return false;
  }
  return true;
}

// Whether the widths are those of the MmaNet instance Net.
template <class Net>
bool is_net(const int* dims, const Shape& sh) {
  using L0 = typename Net::L0;
  using L1 = typename Net::L1;
  if (sh.ns != Net::NS || sh.nv != Net::NV || sh.se != Net::SE || sh.ve != Net::VE) return false;
  if (dims[0] != L0::H || dims[1] != L0::SO || dims[2] != L0::VO) return false;
  for (int k = 1; k < sh.n_layers; ++k) {
    if (dims[3 * k] != L1::H || dims[3 * k + 1] != L1::SO || dims[3 * k + 2] != L1::VO) {
      return false;
    }
  }
  return true;
}

// K5 bwd's kernel at these widths and compute dtype: at the widths of an
// MmaNet instance BWD_MMA (bf16) or BWD_F32 (f32, at the depths whose later
// layers' inputs fit an input row), else BWD_BLOCK, the block-tile kernel.
enum { BWD_BLOCK = 0, BWD_MMA = 1, BWD_F32 = 2 };

int bwd_kind(const int* dims, const Shape& sh, int cdt_bf16) {
  if (!is_net<ServedNet>(dims, sh)) return BWD_BLOCK;
  if (cdt_bf16) return BWD_MMA;
  return bwd_f32_smem<ServedNet>(sh.n_layers).warps > 0 ? BWD_F32 : BWD_BLOCK;
}

// The warp-tile instance for these activations and dtypes (DT_STEP's bits):
// the served model's bf16 step, (relu, none), has one of its own.
bool bwd_step_instance(int act_s, int act_v, int dt) {
  return act_s == ACT_RELU && act_v == ACT_NONE && dt == DT_STEP;
}

// K5 bwd's kernel and instance: 0 the block-tile kernel, 1 the mma.sync
// kernel's run-time instance, 2 its instance for the bf16 step
// (bwd_step_instance), 3 the f32 kernel's run-time instance, 4 its served
// instance (bwd_f32_served_instance); dt: both | es << 1 | ev << 2 | dout << 3,
// bf16 where set.
int bwd_route(const int* dims, const Shape& sh, int cdt_bf16, int act_s, int act_v, int dt) {
  switch (bwd_kind(dims, sh, cdt_bf16)) {
    case BWD_MMA: return bwd_step_instance(act_s, act_v, dt) ? 2 : 1;
    case BWD_F32: return bwd_f32_served_instance(act_s, act_v, dt) ? 4 : 3;
    default: return 0;
  }
}

// K5 fwd's kernel: 0 the block-tile kernel, 1 a warp-tile kernel (mma.sync
// for the bf16 compute dtype, FFMA for f32) at the widths of an MmaNet
// instance, 2 its served instance (fwd_served_instance); dt: both | es << 1 |
// ev << 2, bf16 where set.
int fwd_route(const int* dims, const Shape& sh, int cdt_bf16, int act_s, int act_v, int dt) {
  if (!is_net<ServedNet>(dims, sh)) return 0;
  return fwd_served_instance(cdt_bf16, act_s, act_v, dt) ? 2 : 1;
}

int64_t fwd_smem_bytes(const int* dims, const Shape& sh, int cdt_bf16) {
  if (is_net<ServedNet>(dims, sh)) return fwd_warp_smem<ServedNet>(sh.n_layers, cdt_bf16).total;
  return fwd_smem(widths(dims, sh));
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

// A warp-tile forward (MMA: on mma.sync, else the f32 kernel) at the served
// widths: persistent blocks, at most the card's resident ones.
template <bool MMA, int ACT_S, int ACT_V, int DT>
int launch_fwd_warp(const Inputs& in, int n_layers, const float* w, int act_s, int act_v,
                    void* out, cudaStream_t s) {
  const auto kernel = [] {   // only the instance that runs is compiled
    if constexpr (MMA) {
      return message_fwd_mma_kernel<ServedNet, ACT_S, ACT_V, DT>;
    } else {
      return message_fwd_f32_kernel<ServedNet, ACT_S, ACT_V, DT>;
    }
  }();
  static bool attr = false;
  if (!attr) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const int64_t rows = MMA ? MMA_ROWS : F32_ROWS;
  const int64_t blocks = ((in.R + rows - 1) / rows + FWD_WARPS - 1) / FWD_WARPS;
  const int64_t resident =
      (int64_t)sm_count() * (MMA ? FWD_MMA_BLOCKS_PER_SM : FWD_F32_BLOCKS_PER_SM);
  kernel<<<(unsigned)(blocks < resident ? blocks : resident), FWD_THREADS,
           (size_t)fwd_warp_smem<ServedNet>(n_layers, MMA).total, s>>>(in, n_layers, w, act_s,
                                                                        act_v, out);
  return (int)cudaGetLastError();
}

// Blocks of K5 bwd's first launch (rows of its weight-gradient scratch):
// the warp-tile kernels run persistent blocks, at most the card's resident
// ones (the f32 kernel one an SM).
int64_t bwd_block_count(int64_t R, int kind, int n_layers) {
  if (kind == BWD_MMA || kind == BWD_F32) {
    const bool mma = kind == BWD_MMA;
    const int64_t rows = mma ? MMA_ROWS : F32_ROWS;
    const int64_t warps = mma ? MMA_WARPS : bwd_f32_smem<ServedNet>(n_layers).warps;
    const int64_t blocks = ((R + rows - 1) / rows + warps - 1) / warps;
    const int64_t resident = (int64_t)sm_count() * (mma ? MMA_BLOCKS_PER_SM : 1);
    return blocks < resident ? blocks : resident;
  }
  const int64_t tiles = (R + BWD_TILE - 1) / BWD_TILE;
  return (tiles + BWD_TILES_PER_BLOCK - 1) / BWD_TILES_PER_BLOCK;
}

int64_t bwd_smem_bytes(const int* dims, const Shape& sh, int cdt_bf16) {
  switch (bwd_kind(dims, sh, cdt_bf16)) {
    case BWD_MMA: return mma_smem<ServedNet>(sh.n_layers).total;
    case BWD_F32: return bwd_f32_smem<ServedNet>(sh.n_layers).total;
    default: return bwd_smem(widths(dims, sh));
  }
}

int reduce_rows(const float* partial, float* dw, int64_t blocks, int n_w, cudaStream_t s) {
  const dim3 block(REDUCE_COLS, REDUCE_SEGS);
  reduce_rows_kernel<<<(unsigned)((n_w + REDUCE_COLS - 1) / REDUCE_COLS), block, 0, s>>>(
      partial, dw, (int)blocks, n_w);
  return (int)cudaGetLastError();
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
  const int64_t blocks = bwd_block_count(in.R, BWD_BLOCK, sh.n_layers);
  message_bwd_kernel<BF><<<(unsigned)blocks, THREADS, (size_t)bwd_smem(wd), s>>>(
      in, sh, dims_dev, w, act_s, act_v, dout, dout_bf16, dboth, des, dev, partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return reduce_rows(partial, dw, blocks, wd.n_w, s);
}

template <class Net, int ACT_S, int ACT_V, int DT>
int launch_bwd_mma(const Inputs& in, const Shape& sh, int n_w, const float* w, int act_s,
                   int act_v, const void* dout, int dout_bf16, void* dboth, void* des, void* dev,
                   float* partial, float* dw, cudaStream_t s) {
  const auto kernel = message_bwd_mma_kernel<Net, ACT_S, ACT_V, DT>;
  static bool attr = false;
  if (!attr) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const int64_t blocks = bwd_block_count(in.R, BWD_MMA, sh.n_layers);
  const MmaSmem sm = mma_smem<Net>(sh.n_layers);
  kernel<<<(unsigned)blocks, MMA_THREADS, (size_t)sm.total, s>>>(
      in, sh.n_layers, w, act_s, act_v, dout, dout_bf16, dboth, des, dev, partial, n_w);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return reduce_rows(partial, dw, blocks, n_w, s);
}

template <int ACT_S, int ACT_V, int DT>
int launch_bwd_f32(const Inputs& in, const Shape& sh, int n_w, const float* w, int act_s,
                   int act_v, const void* dout, int dout_bf16, void* dboth, void* des, void* dev,
                   float* partial, float* dw, cudaStream_t s) {
  const auto kernel = message_bwd_f32_kernel<ServedNet, ACT_S, ACT_V, DT>;
  static bool attr = false;
  if (!attr) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const int64_t blocks = bwd_block_count(in.R, BWD_F32, sh.n_layers);
  const BwdF32Smem sm = bwd_f32_smem<ServedNet>(sh.n_layers);
  kernel<<<(unsigned)blocks, 32 * sm.warps, (size_t)sm.total, s>>>(
      in, sh.n_layers, w, act_s, act_v, dout, dout_bf16, dboth, des, dev, partial, n_w);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return reduce_rows(partial, dw, blocks, n_w, s);
}

}  // namespace

extern "C" {

// Bytes of shared memory a block of K5 fwd (backward == 0) or K5 bwd
// (backward != 0) needs for this shape; the kernel that runs depends on the
// compute dtype (cdt_bf16). -1 for a shape it does not take. dims: (h, so,
// vo) of each of the n_layers layers, on the host.
long long k5_smem_bytes(const int* dims, int n_layers, int ns, int nv, int se, int ve,
                        int backward, int cdt_bf16) {
  const Shape sh = {n_layers, ns, nv, se, ve};
  if (!valid(dims, sh)) return -1;
  return backward ? bwd_smem_bytes(dims, sh, cdt_bf16) : fwd_smem_bytes(dims, sh, cdt_bf16);
}

// The kernel K5 fwd runs for this shape, compute dtype, activations and
// dtypes (both_bf16 | es_bf16 << 1 | ev_bf16 << 2): 0 the block-tile kernel,
// 1 a warp-tile kernel (mma.sync for bf16, FFMA for f32), 2 its served
// instance (the served model's activations with the dtypes of its bf16 step
// or of f32 serving).
int k5_fwd_kernel(const int* dims, int n_layers, int ns, int nv, int se, int ve, int cdt_bf16,
                  int act_s, int act_v, int dtypes) {
  const Shape sh = {n_layers, ns, nv, se, ve};
  if (!valid(dims, sh)) return 0;
  return fwd_route(dims, sh, cdt_bf16, act_s, act_v, dtypes);
}

// The kernel K5 bwd runs for this shape, compute dtype, activations and
// dtypes (both_bf16 | es_bf16 << 1 | ev_bf16 << 2 | dout_bf16 << 3): 0 the
// block-tile kernel, 1 the warp-tile (mma.sync) kernel, 2 its instance for
// the served model's bf16 step, 3 the f32 warp-tile kernel, 4 its served
// instance (the served model's activations, every tensor f32).
int k5_bwd_kernel(const int* dims, int n_layers, int ns, int nv, int se, int ve, int cdt_bf16,
                  int act_s, int act_v, int dtypes) {
  const Shape sh = {n_layers, ns, nv, se, ve};
  if (!valid(dims, sh)) return 0;
  return bwd_route(dims, sh, cdt_bf16, act_s, act_v, dtypes);
}

// Rows of K5 bwd's weight-gradient scratch for R = B * E edges (on the
// current device, for the warp-tile kernels); block_tiles != 0: for the
// block-tile kernel whatever the shape (k5_message_bwd_block).
long long k5_bwd_blocks(const int* dims, int n_layers, int ns, int nv, int se, int ve,
                        int cdt_bf16, long long R, int block_tiles) {
  const Shape sh = {n_layers, ns, nv, se, ve};
  if (!valid(dims, sh)) return -1;
  return bwd_block_count(R, block_tiles ? BWD_BLOCK : bwd_kind(dims, sh, cdt_bf16), n_layers);
}

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
  if (wd.n_w != n_w || fwd_smem_bytes(dims_host, sh, cdt_bf16) > MAX_SMEM) {
    return (int)cudaErrorInvalidValue;
  }
  const Inputs in = {both, es, ev, both_bf16, es_bf16, ev_bf16, (int64_t)B * E, E};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dt = both_bf16 | es_bf16 << 1 | ev_bf16 << 2;
  switch (fwd_route(dims_host, sh, cdt_bf16, act_s, act_v, dt)) {
    case 2:
      return cdt_bf16
                 ? launch_fwd_warp<true, ACT_RELU, ACT_NONE, DT_STEP>(in, n_layers, w, act_s,
                                                                      act_v, out, s)
                 : launch_fwd_warp<false, ACT_RELU, ACT_NONE, DT_F32>(in, n_layers, w, act_s,
                                                                      act_v, out, s);
    case 1:
      return cdt_bf16 ? launch_fwd_warp<true, -1, -1, -1>(in, n_layers, w, act_s, act_v, out, s)
                      : launch_fwd_warp<false, -1, -1, -1>(in, n_layers, w, act_s, act_v, out, s);
    default:
      return cdt_bf16 ? launch_fwd<true>(in, sh, dims_dev, wd, w, act_s, act_v, out, both_bf16, s)
                      : launch_fwd<false>(in, sh, dims_dev, wd, w, act_s, act_v, out, both_bf16, s);
  }
}

// k5_message_bwd on the block-tile kernel whatever the shape (the kernel of
// widths without a warp-tile instance; the reference the warp-tile kernels'
// input gradients are held to bit for bit in f32). partial: f32 scratch of
// k5_bwd_blocks(..., block_tiles = 1) rows of n_w.
int k5_message_bwd_block(const void* both, const void* es, const void* ev, const float* w,
                         const int* dims_dev, const int* dims_host, const void* dout, void* dboth,
                         void* des, void* dev, float* partial, float* dw, int B, int E, int ns,
                         int nv, int se, int ve, int n_layers, int n_w, int act_s, int act_v,
                         int both_bf16, int es_bf16, int ev_bf16, int dout_bf16, int cdt_bf16,
                         void* stream) {
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

// The inputs as for k5_message_fwd, plus dout [B, E, so + 3vo] (f32, or bf16
// with dout_bf16). Writes dboth [B, 2E, ns + 3nv], des [B, E, se] and dev
// [B, E, 3ve] in the dtypes of both, es and ev, and dw [n_w] f32, the weight
// gradients packed as w. partial: f32 scratch of k5_bwd_blocks(...) rows of
// n_w. Two launches: the tiles, then the sum of their rows.
int k5_message_bwd(const void* both, const void* es, const void* ev, const float* w,
                   const int* dims_dev, const int* dims_host, const void* dout, void* dboth,
                   void* des, void* dev, float* partial, float* dw, int B, int E, int ns, int nv,
                   int se, int ve, int n_layers, int n_w, int act_s, int act_v, int both_bf16,
                   int es_bf16, int ev_bf16, int dout_bf16, int cdt_bf16, void* stream) {
  const Shape sh = {n_layers, ns, nv, se, ve};
  if (!valid(dims_host, sh) || B < 1 || E < 1) return (int)cudaErrorInvalidValue;
  const Widths wd = widths(dims_host, sh);
  if (wd.n_w != n_w || bwd_smem_bytes(dims_host, sh, cdt_bf16) > MAX_SMEM) {
    return (int)cudaErrorInvalidValue;
  }
  const Inputs in = {both, es, ev, both_bf16, es_bf16, ev_bf16, (int64_t)B * E, E};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dt = both_bf16 | es_bf16 << 1 | ev_bf16 << 2 | dout_bf16 << 3;
  switch (bwd_route(dims_host, sh, cdt_bf16, act_s, act_v, dt)) {
    case 4:
      return launch_bwd_f32<ACT_RELU, ACT_NONE, 0>(in, sh, n_w, w, act_s, act_v, dout, dout_bf16,
                                                   dboth, des, dev, partial, dw, s);
    case 3:
      return launch_bwd_f32<-1, -1, -1>(in, sh, n_w, w, act_s, act_v, dout, dout_bf16, dboth,
                                        des, dev, partial, dw, s);
    case 2:
      return launch_bwd_mma<ServedNet, ACT_RELU, ACT_NONE, DT_STEP>(
          in, sh, n_w, w, act_s, act_v, dout, dout_bf16, dboth, des, dev, partial, dw, s);
    case 1:
      return launch_bwd_mma<ServedNet, -1, -1, -1>(in, sh, n_w, w, act_s, act_v, dout, dout_bf16,
                                                   dboth, des, dev, partial, dw, s);
    default:
      return k5_message_bwd_block(both, es, ev, w, dims_dev, dims_host, dout, dboth, des, dev,
                                  partial, dw, B, E, ns, nv, se, ve, n_layers, n_w, act_s, act_v,
                                  both_bf16, es_bf16, ev_bf16, dout_bf16, cdt_bf16, stream);
  }
}

// y[i] = x[i] for n elements, x and y each f32 or bf16 (by their flags).
int k6_cast_copy(const void* x, void* y, long long n, int x_bf16, int y_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return (int)cudaErrorInvalidValue;
  if (x_bf16 && y_bf16) {
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
