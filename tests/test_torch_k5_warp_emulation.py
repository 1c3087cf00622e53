"""K5 bwd's warp-tile kernel (``message_bwd_mma_kernel`` in
caster_dta_torch/csrc/gvp_message.cu) run on the CPU, warp by warp, against
the plain version of K5 bwd.

The card's compiler is not here, so the kernel's source is compiled with the
host's C++ compiler against a small emulation of what it uses of CUDA: each
thread of a block is a host thread, ``__syncthreads`` a barrier, and the warp
primitives (``mma.sync`` m16n8k16 bf16, ``movmatrix`` transposes, xor
shuffles) exchange their lanes' fragments through memory and compute them as
PTX lays them out, with exact sums. So the test holds the kernel's fragment
layouts, tiling, shared-memory layout and weight-gradient slabs to the
function it must compute; the card tests (tests/test_torch_kernels.py) hold
the compiled kernel. The code between the ``warp primitives (PTX)`` markers
of the source is replaced by the emulation, and the source up to its K6
section is compiled. Skips where no ``g++`` with C++20 is found.
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
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
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
  blockDim.x = MMA_THREADS;
  gridDim.x = grid;
  for (int blk = 0; blk < grid; ++blk) {
    g_smem.assign(s.total, 0xA5);
    std::barrier<> block(MMA_THREADS);
    g_block = &block;
    std::vector<std::unique_ptr<std::barrier<>>> warps;
    for (int v = 0; v < MMA_WARPS; ++v) {
      warps.emplace_back(new std::barrier<>(32));
      g_warps[v].bar = warps.back().get();
    }
    std::vector<std::thread> threads;
    for (int t = 0; t < MMA_THREADS; ++t) {
      threads.emplace_back([&, t, blk] {
        threadIdx.x = t;
        blockIdx.x = blk;
        // the instance the launcher picks (bwd_step_instance)
        const int dt = both_bf16 | es_bf16 << 1 | ev_bf16 << 2 | dout_bf16 << 3;
        const auto kernel = bwd_step_instance(act_s, act_v, dt)
                                ? message_bwd_mma_kernel<ServedNet, ACT_RELU, ACT_NONE, DT_STEP>
                                : message_bwd_mma_kernel<ServedNet, -1, -1, -1>;
        kernel(in, n_layers, w, act_s, act_v, dout, dout_bf16, dboth, des, dev, partial.data(),
               n_w);
      });
    }
    for (auto& t : threads) t.join();
  }
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
    assert decl in src
    return src.replace(decl, "unsigned char* smem_bytes = emu_smem();") + "\n}  // namespace\n"


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
