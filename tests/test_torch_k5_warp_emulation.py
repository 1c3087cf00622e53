"""K5's warp-tile kernels in caster_dta_torch/csrc/gvp_message.cu
(``message_bwd_mma_kernel``, ``message_fwd_mma_kernel`` and
``message_fwd_f32_kernel``) run on the CPU, warp by warp, against the plain
versions of K5 bwd and K5 fwd; and the f32 forward against the block-tile
``message_fwd_kernel``, bit for bit.

The card's compiler is not here, so the kernel's source is compiled with the
host's C++ compiler against a small emulation of what it uses of CUDA: each
thread of a block is a host thread, ``__syncthreads`` a barrier, and the warp
primitives (``mma.sync`` m16n8k16 bf16, ``movmatrix`` transposes, xor
shuffles) exchange their lanes' fragments through memory and compute them as
PTX lays them out, with exact sums; ``__syncwarp`` is a barrier of the
warp's lanes. So the test holds the kernels' fragment layouts, tiling,
staging, shared-memory layout and weight-gradient slabs to the function they
must compute; the card tests (tests/test_torch_kernels.py) hold the compiled
kernels. The code between the ``warp primitives (PTX)`` markers of the
source is replaced by the emulation, and the source up to its K6 section is
compiled. Skips where no ``g++`` with C++20 is found.
"""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from caster_dta_torch.nn import gvp
from caster_dta_torch.ops import build
from caster_dta_torch.ops import cuda_gvp_message as cgm

F32, BF16 = torch.float32, torch.bfloat16

CUDA_RUNTIME_H = r"""
#pragma once
#include <cstdint>
#include <cstring>
#include <cmath>
#define __host__
#define __device__
#define __global__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
struct dim3 { unsigned x = 1, y = 1, z = 1; };
struct uint2 { uint32_t x, y; };
struct alignas(16) uint4 { uint32_t x, y, z, w; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
inline float fmaxf(float a, float b) { return std::fmax(a, b); }
inline float __expf(float x) { return std::exp(x); }
inline float __fdividef(float a, float b) { return a / b; }
inline float rsqrtf(float x) { return 1.f / std::sqrt(x); }
template <class T> inline T __ldg(const T* p) { return *p; }
extern thread_local dim3 threadIdx, blockIdx;
extern dim3 blockDim, gridDim;
void __syncthreads();
typedef int cudaStream_t;
"""

CUDA_BF16_H = r"""
#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { uint16_t x; };
inline uint16_t emu_bf16_bits(float f) {  // round to nearest even
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (uint16_t)((u >> 16) | 0x40);
  u += 0x7fffu + ((u >> 16) & 1u);
  return (uint16_t)(u >> 16);
}
inline float emu_bf16_float(uint16_t b) {
  const uint32_t u = (uint32_t)b << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) { return {emu_bf16_bits(f)}; }
inline float __bfloat162float(__nv_bfloat16 b) { return emu_bf16_float(b.x); }
"""

# the warp primitives: each lane writes its fragment, a barrier, each lane
# reads what PTX's layout gives it, a barrier
WARP_PRIMITIVES = r"""
inline uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)emu_bf16_bits(lo) | ((uint32_t)emu_bf16_bits(hi) << 16);
}
inline float emu_half(uint32_t w, int hi) {
  return emu_bf16_float(hi ? (uint16_t)(w >> 16) : (uint16_t)(w & 0xffff));
}
inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  WarpX& w = emu_warp();
  const int l = emu_lane();
  for (int i = 0; i < 4; ++i) w.a[l][i] = a[i];
  w.b[l][0] = b.x;
  w.b[l][1] = b.y;
  w.bar->arrive_and_wait();
  float A[16][16], B[16][8];
  for (int L = 0; L < 32; ++L) {
    const int g = L >> 2, t = L & 3;
    for (int h = 0; h < 2; ++h) {
      A[g][2 * t + h] = emu_half(w.a[L][0], h);
      A[g + 8][2 * t + h] = emu_half(w.a[L][1], h);
      A[g][2 * t + 8 + h] = emu_half(w.a[L][2], h);
      A[g + 8][2 * t + 8 + h] = emu_half(w.a[L][3], h);
      B[2 * t + h][g] = emu_half(w.b[L][0], h);
      B[2 * t + 8 + h][g] = emu_half(w.b[L][1], h);
    }
  }
  w.bar->arrive_and_wait();
  const int g = l >> 2, t = l & 3;
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i >> 1), col = 2 * t + (i & 1);
    double s = d[i];
    for (int k = 0; k < 16; ++k) s += (double)A[row][k] * (double)B[k][col];
    d[i] = (float)s;
  }
}
inline uint32_t transpose8(uint32_t x) {
  WarpX& w = emu_warp();
  const int l = emu_lane();
  w.u[l] = x;
  w.bar->arrive_and_wait();
  const int r = l >> 2, c = l & 3;
  const uint32_t lo = w.u[4 * (2 * c) + r / 2], hi = w.u[4 * (2 * c + 1) + r / 2];
  w.bar->arrive_and_wait();
  return ((r & 1) ? lo >> 16 : lo & 0xffff) | (((r & 1) ? hi >> 16 : hi & 0xffff) << 16);
}
inline float shfl_xor(float x, int m) {
  WarpX& w = emu_warp();
  const int l = emu_lane();
  w.f[l] = x;
  w.bar->arrive_and_wait();
  const float y = w.f[l ^ m];
  w.bar->arrive_and_wait();
  return y;
}
inline void warp_sync() { emu_warp().bar->arrive_and_wait(); }
"""

HARNESS = r"""
#include <barrier>
#include <cmath>
#include <memory>
#include <thread>
#include <vector>
#include "cuda_runtime.h"
#include "cuda_bf16.h"
thread_local dim3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
struct WarpX {
  uint32_t a[32][4], b[32][2], u[32];
  float f[32];
  std::barrier<>* bar;
};
static WarpX g_warps[32];
static std::barrier<>* g_block;
static std::vector<unsigned char> g_smem;
void __syncthreads() { g_block->arrive_and_wait(); }
namespace {
inline WarpX& emu_warp() { return g_warps[threadIdx.x >> 5]; }
inline int emu_lane() { return threadIdx.x & 31; }
inline unsigned char* emu_smem() { return g_smem.data(); }
}  // namespace
#include "kernel.inc"
bool bwd_step_instance(int act_s, int act_v, int dt) {  // as in the launch section
  return act_s == ACT_RELU && act_v == ACT_NONE && dt == DT_STEP;
}

// `grid` blocks of `threads` threads, one block after the other, each
// thread running fn() with its threadIdx and blockIdx, in `smem` bytes of
// shared memory filled with 0xA5.
template <class Fn>
void run_grid(int grid, int threads, size_t smem, Fn fn) {
  blockDim.x = threads;
  gridDim.x = grid;
  for (int blk = 0; blk < grid; ++blk) {
    g_smem.assign(smem, 0xA5);
    std::barrier<> block(threads);
    g_block = &block;
    std::vector<std::unique_ptr<std::barrier<>>> warps;
    for (int v = 0; v < (threads + 31) / 32; ++v) {
      warps.emplace_back(new std::barrier<>(32));
      g_warps[v].bar = warps.back().get();
    }
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t) {
      pool.emplace_back([&, t, blk] {
        threadIdx.x = t;
        blockIdx.x = blk;
        fn();
      });
    }
    for (auto& t : pool) t.join();
  }
}

// K5 bwd of the served widths on `grid` emulated blocks; dw gets the rows of
// the blocks summed in order. Returns the block's shared-memory bytes, or -1
// when a weight's gradient was never written.
extern "C" int emu_k5_bwd(const void* both, const void* es, const void* ev, const float* w,
                          const void* dout, void* dboth, void* des, void* dev, float* dw, int B,
                          int E, int n_layers, int n_w, int act_s, int act_v, int both_bf16,
                          int es_bf16, int ev_bf16, int dout_bf16, int grid) {
  const MmaSmem s = mma_smem<ServedNet>(n_layers);
  std::vector<float> partial((size_t)grid * n_w, NAN);
  const Inputs in = {both, es, ev, both_bf16, es_bf16, ev_bf16, (int64_t)B * E, E};
  // the instance the launcher picks (bwd_step_instance)
  const int dt = both_bf16 | es_bf16 << 1 | ev_bf16 << 2 | dout_bf16 << 3;
  const auto kernel = bwd_step_instance(act_s, act_v, dt)
                          ? message_bwd_mma_kernel<ServedNet, ACT_RELU, ACT_NONE, DT_STEP>
                          : message_bwd_mma_kernel<ServedNet, -1, -1, -1>;
  run_grid(grid, MMA_THREADS, s.total, [&] {
    kernel(in, n_layers, w, act_s, act_v, dout, dout_bf16, dboth, des, dev, partial.data(), n_w);
  });
  for (int i = 0; i < n_w; ++i) {
    float sum = 0.f;
    for (int r = 0; r < grid; ++r) {
      if (std::isnan(partial[(size_t)r * n_w + i])) return -1;
      sum += partial[(size_t)r * n_w + i];
    }
    dw[i] = sum;
  }
  return s.total;
}

// Whether K5 fwd runs the served instance of its warp-tile kernel for these
// (the launcher's fwd_route at the served widths).
extern "C" int emu_fwd_served(int cdt_bf16, int act_s, int act_v, int dt) {
  return fwd_served_instance(cdt_bf16, act_s, act_v, dt);
}

// K5 fwd of the served widths on a warp-tile kernel (mma.sync for the bf16
// compute dtype, else the f32 kernel) in the instance the launcher picks, on
// `grid` emulated blocks. Returns the block's shared-memory bytes.
extern "C" int emu_k5_fwd(const void* both, const void* es, const void* ev, const float* w,
                          void* out, int B, int E, int n_layers, int act_s, int act_v,
                          int both_bf16, int es_bf16, int ev_bf16, int cdt_bf16, int grid) {
  const FwdSmem s = fwd_warp_smem<ServedNet>(n_layers, cdt_bf16 != 0);
  const Inputs in = {both, es, ev, both_bf16, es_bf16, ev_bf16, (int64_t)B * E, E};
  const bool served = fwd_served_instance(cdt_bf16, act_s, act_v,
                                          both_bf16 | es_bf16 << 1 | ev_bf16 << 2);
  using Kernel = void (*)(Inputs, int, const float*, int, int, void*);
  const Kernel kernel =
      cdt_bf16 ? (served ? message_fwd_mma_kernel<ServedNet, ACT_RELU, ACT_NONE, DT_STEP>
                         : message_fwd_mma_kernel<ServedNet, -1, -1, -1>)
               : (served ? message_fwd_f32_kernel<ServedNet, ACT_RELU, ACT_NONE, DT_F32>
                         : message_fwd_f32_kernel<ServedNet, -1, -1, -1>);
  run_grid(grid, FWD_THREADS, s.total, [&] { kernel(in, n_layers, w, act_s, act_v, out); });
  return s.total;
}

// K5 fwd of the served widths on the block-tile kernel, as its launcher
// runs it (dims: the layers' (h, so, vo)).
extern "C" void emu_k5_fwd_block(const void* both, const void* es, const void* ev,
                                 const float* w, void* out, int B, int E, const int* dims,
                                 int n_layers, int act_s, int act_v, int both_bf16, int es_bf16,
                                 int ev_bf16, int cdt_bf16) {
  const Shape sh = {n_layers, 16, 4, 32, 1};
  const Inputs in = {both, es, ev, both_bf16, es_bf16, ev_bf16, (int64_t)B * E, E};
  const int blocks = (int)((in.R + FWD_TILE - 1) / FWD_TILE);
  run_grid(blocks, THREADS, (size_t)fwd_smem(widths(dims, sh)), [&] {
    if (cdt_bf16) {
      message_fwd_kernel<true>(in, sh, dims, w, act_s, act_v, out, both_bf16);
    } else {
      message_fwd_kernel<false>(in, sh, dims, w, act_s, act_v, out, both_bf16);
    }
  });
}
"""


def _kernel_source() -> str:
    """gvp_message.cu up to its K6 section, the PTX warp primitives replaced
    by the emulation."""
    with open(os.path.join(build.CSRC_DIR, "gvp_message.cu")) as f:
        src = f.read()
    src = src[:src.rindex("// ----", 0, src.index("// K6: copy-cast"))]
    a = src.index("// ---- warp primitives (PTX) ----")
    b = src.index("// ---- end of warp primitives ----")
    src = src[:a] + WARP_PRIMITIVES + src[b:]
    decl = "extern __shared__ __align__(16) unsigned char smem_bytes[];"
    decl_f32 = "extern __shared__ float smem[];"
    assert decl in src and decl_f32 in src
    src = src.replace(decl, "unsigned char* smem_bytes = emu_smem();")
    src = src.replace(decl_f32, "float* smem = reinterpret_cast<float*>(emu_smem());")
    return src + "\n}  // namespace\n"


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's emulation")
    d = tmp_path_factory.mktemp("k5_emulation")
    for name, text in (("cuda_runtime.h", CUDA_RUNTIME_H), ("cuda_bf16.h", CUDA_BF16_H),
                       ("kernel.inc", _kernel_source()), ("harness.cpp", HARNESS)):
        (d / name).write_text(text)
    so = d / "libk5emu.so"
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-fPIC", "-shared",
                        "-Wno-unknown-pragmas", f"-I{d}", "-o", str(so), str(d / "harness.cpp")],
                       capture_output=True, text=True)
    if r.returncode and "c++20" in r.stderr:
        pytest.skip("needs a g++ with C++20 (std::barrier)")
    assert r.returncode == 0, r.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    lib.emu_k5_bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11
    lib.emu_fwd_served.argtypes = [ctypes.c_int] * 4
    lib.emu_k5_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
    lib.emu_k5_fwd_block.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p] + [ctypes.c_int] * 7
    lib.emu_k5_fwd_block.restype = None
    return lib


def _case(b, e, n_layers, acts, dtypes, seed):
    """The served model's message widths, inputs drawn with numpy."""
    rng = np.random.default_rng(seed)
    conv = gvp.GVPConv((16, 4), (16, 4), (32, 1), n_layers=n_layers, activations=acts,
                       vector_gate=True, generator=torch.Generator().manual_seed(seed))
    weights = [w.detach() for w in cgm.layer_weights(conv.message_func)]

    def randn(*shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dtype)

    return (randn(b, 2 * e, 28, dtype=dtypes[0]), randn(b, e, 32, dtype=dtypes[1]),
            randn(b, e, 3, dtype=dtypes[2]), weights, randn(b, e, 28, dtype=dtypes[0]))


# (B, E): edge counts off the 16-edge tiles; grid: emulated blocks of 4
# warps, so a warp walks several tiles where the tiles outnumber the warps.
# (relu, none) with the bf16 step's dtypes runs the kernel's instance for
# the served model's step, every other case its run-time instance.
@pytest.mark.parametrize("b,e,n_layers,acts,dtypes,grid", [
    (2, 77, 3, ("relu", None), (F32, F32, BF16), 2),            # the bf16 step's dtypes
    (3, 17, 3, ("sigmoid", "sigmoid"), (F32, F32, BF16), 3),
    (1, 40, 1, ("relu", None), (BF16, BF16, BF16), 1),          # one layer, all bf16
    (2, 33, 2, ("relu", "sigmoid"), (F32, F32, F32), 1),
    (1, 16 * 11 + 7, 3, ("relu", None), (F32, F32, BF16), 1),   # 12 tiles on 4 warps
])
def test_k5_bwd_warp_tiles_emulated(emulated, b, e, n_layers, acts, dtypes, grid):
    both, es, ev, weights, dout = _case(b, e, n_layers, acts, dtypes, seed=b * 1000 + e)
    spec = cgm.MessageSpec(16, 4, acts[0], acts[1], BF16)
    w = cgm._pack(weights)
    dboth, des, dev = (torch.full_like(t, float("nan")) for t in (both, es, ev))
    dw = torch.empty(w.numel())
    codes = [cgm._ACT_CODES[a] for a in acts]
    flags = [cgm._is_bf16(t) for t in (both, es, ev, dout)]
    got = emulated.emu_k5_bwd(both.data_ptr(), es.data_ptr(), ev.data_ptr(), w.data_ptr(),
                              dout.data_ptr(), dboth.data_ptr(), des.data_ptr(), dev.data_ptr(),
                              dw.data_ptr(), b, e, n_layers, w.numel(), *codes, *flags, grid)
    assert got > 0, "a weight gradient was never written"
    want = cgm.message_bwd_plain(both, es, ev, weights, dout, spec)
    grads = [g.view(t.shape) for g, t in zip(dw.split([t.numel() for t in weights]), weights)]
    # exact sums against the plain version's f32 sums of the same bf16
    # operands: they differ by f32 rounding, and where that moves a value
    # across a bf16 rounding boundary, by one bf16 ulp of it
    for i, (x, ref) in enumerate(zip([dboth, des, dev] + grads, list(want[:3]) + want[3])):
        assert x.dtype == ref.dtype and x.shape == ref.shape
        x, ref = x.float(), ref.float()
        assert not torch.isnan(x).any(), f"output {i} not written everywhere"
        scale = ref.abs().max().item()
        assert (x - ref).abs().max().item() <= 1e-3 * scale, f"output {i}"


def _fwd_args(both, es, ev, w, out, acts):
    return (both.data_ptr(), es.data_ptr(), ev.data_ptr(), w.data_ptr(), out.data_ptr(),
            both.shape[0], es.shape[1])


def _flags(acts, tensors):
    return [cgm._ACT_CODES[a] for a in acts] + [cgm._is_bf16(t) for t in tensors]


# The forward's warp tiles: 16 edges (mma.sync, bf16 products) or 32 (f32,
# a lane each), 4 warps a block; edge counts off the tiles (E = 17 puts
# tiles across graphs), 1 and 3 layers, both activation pairs, and grids
# smaller than the tile count, so warps walk several tiles. (relu, none)
# with the bf16 step's dtypes, or all f32, runs the served instance.
@pytest.mark.parametrize("b,e,n_layers,acts,dtypes,cdt,grid", [
    (2, 77, 3, ("relu", None), (F32, F32, BF16), BF16, 2),        # the bf16 step
    (3, 17, 3, ("sigmoid", "sigmoid"), (F32, F32, BF16), BF16, 1),
    (1, 40, 1, ("relu", None), (BF16, BF16, BF16), BF16, 1),      # one layer, all bf16
    (1, 16 * 11 + 7, 3, ("relu", None), (F32, F32, BF16), BF16, 1),  # 12 tiles on 4 warps
    (2, 77, 3, ("relu", None), (F32, F32, F32), F32, 1),          # f32 serving, 5 tiles
    (3, 17, 3, ("sigmoid", "sigmoid"), (F32, F32, F32), F32, 1),
    (1, 40, 1, ("relu", None), (F32, F32, F32), F32, 1),
    (2, 130, 2, ("relu", "sigmoid"), (BF16, F32, BF16), F32, 2),  # bf16 inputs, f32 products
    (1, 32 * 9 + 5, 3, ("relu", None), (F32, F32, F32), F32, 1),  # 10 tiles on 4 warps
])
def test_k5_fwd_warp_tiles_emulated(emulated, b, e, n_layers, acts, dtypes, cdt, grid):
    both, es, ev, weights, _ = _case(b, e, n_layers, acts, dtypes, seed=b * 1000 + e + 7)
    spec = cgm.MessageSpec(16, 4, acts[0], acts[1], cdt)
    w = cgm._pack(weights)
    out = torch.full((b, e, 28), float("nan"), dtype=both.dtype)
    flags = _flags(acts, (both, es, ev))
    served = acts == ("relu", None) and tuple(dtypes) == ((F32, F32, BF16) if cdt == BF16
                                                          else (F32, F32, F32))
    assert emulated.emu_fwd_served(int(cdt == BF16), flags[0], flags[1],
                                   flags[2] | flags[3] << 1 | flags[4] << 2) == served
    got = emulated.emu_k5_fwd(*_fwd_args(both, es, ev, w, out, acts), n_layers, *flags,
                              int(cdt == BF16), grid)
    assert got > 0
    want = cgm.message_fwd_plain(both, es, ev, weights, spec)
    assert out.dtype == want.dtype and out.shape == want.shape
    assert not torch.isnan(out).any(), "an output row was not written"
    # K5_TOL: exact sums of the same bf16 operands against the plain
    # version's f32 sums move a value across a bf16 rounding boundary now and
    # then (2e-2 of the largest entry); f32 sums differ only in order
    x, ref = out.float(), want.float()
    scale = ref.abs().max().item()
    tol = 2e-2 * scale if BF16 in (cdt, both.dtype) else 1e-5 * (1 + scale)
    assert (x - ref).abs().max().item() <= tol


# The f32 kernel sums each output in the block-tile kernel's order with its
# elementwise math, so the two give the same bits (both compiled alike here;
# the card tests hold the compiled kernels to each other).
@pytest.mark.parametrize("b,e,n_layers,acts,dtypes", [
    (2, 77, 3, ("relu", None), (F32, F32, F32)),                 # f32 serving
    (3, 17, 3, ("sigmoid", "sigmoid"), (F32, F32, F32)),
    (2, 130, 2, ("relu", "sigmoid"), (BF16, F32, BF16)),
])
def test_k5_fwd_f32_warp_tiles_give_the_block_tiles_bits_emulated(emulated, b, e, n_layers, acts,
                                                                   dtypes):
    both, es, ev, weights, _ = _case(b, e, n_layers, acts, dtypes, seed=b * 1000 + e + 11)
    w = cgm._pack(weights)
    spec = cgm.MessageSpec(16, 4, acts[0], acts[1], F32)
    dims = cgm._layer_dims(weights, spec, 32, 1)
    flat = (ctypes.c_int * (3 * len(dims)))(*[x for d in dims for x in d])
    flags = _flags(acts, (both, es, ev))
    warp, block = (torch.full((b, e, 28), float("nan"), dtype=both.dtype) for _ in range(2))
    emulated.emu_k5_fwd(*_fwd_args(both, es, ev, w, warp, acts), n_layers, *flags, 0, 2)
    emulated.emu_k5_fwd_block(*_fwd_args(both, es, ev, w, block, acts), flat, n_layers, *flags,
                              0)
    assert not torch.isnan(block).any()
    assert torch.equal(warp, block)
