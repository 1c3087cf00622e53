"""K4's row kernel in caster_dta_torch/csrc/attention.cu
(``masked_mha_rows_kernel``, every head dim up to 16) run on the CPU, block
by block, against the plain version ``masked_mha_plain``.

The card's compiler is not here, so the kernel's source is compiled with the
host's C++ compiler against a small emulation of what it uses of CUDA: each
thread of a block is a host thread, ``__syncthreads`` a barrier, shared
memory the kernel's own static arrays, the ticket ``atomicAdd`` a host
atomic and ``__threadfence`` a fence. Blocks run one after the other, in the
grid's order or reversed, so the last block of a split tile to take its
ticket is once the last split and once the first: both must give the same
bits. The test holds the kernel's tiling, staging, step loop, split merges
and counter reset to the function it must compute; the card tests
(tests/test_torch_kernels.py) hold the compiled kernel. The source is
compiled up to its wide kernel (``// ---- the wide kernel``), with the
launch arguments from its own ``rows_args``, in the launcher's instance and
two others of the template. Skips where no ``g++`` with
C++20 is found.
"""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from caster_dta_torch.ops import build
from caster_dta_torch.ops import cuda_attention as ca

# the card tests' tolerance: the same f32 products summed in another order,
# one exp per key against a dense softmax
K4_TOL = dict(rtol=2e-5, atol=2e-5)

CUDA_RUNTIME_H = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#define __host__
#define __device__
#define __global__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
struct dim3 { unsigned x = 1, y = 1, z = 1; };
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float __ldcg(const float* p) { return *p; }
inline int atomicAdd(int* p, int x) { return __atomic_fetch_add(p, x, __ATOMIC_SEQ_CST); }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
using std::min;
extern thread_local dim3 threadIdx, blockIdx;
extern dim3 blockDim, gridDim;
void __syncthreads();
"""

HARNESS = r"""
#include <barrier>
#include <thread>
#include <vector>
#include "cuda_runtime.h"
thread_local dim3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
static std::barrier<>* g_block;
void __syncthreads() { g_block->arrive_and_wait(); }
// the launcher's instance and two more of the template, as the timing
// script builds them
#define K4_ROWS_INSTANCES(X) X(2, 8, 4) X(2, 16, 3) X(4, 8, 2)
#include "kernel.inc"

// The row kernel on emulated blocks of RT_THREADS threads, the grid walked in
// its order or reversed. Allocates the partials and the tickets as the
// wrapper does; returns the number of tickets not back at 0, or -1 for an
// instance the launcher does not have.
extern "C" int emu_k4_rows(const float* q, const float* k, const float* v, const uint8_t* mask,
                           float* out, int BH, int H, int Lq, int Lk, int hd, float scale, int R,
                           int KS, int MINB, int s_in, int s_out, int reverse) {
  const int rows_block = 32 * R * (RT_WARPS / s_in);
  const int tiles = (Lq + rows_block - 1) / rows_block;
  std::vector<float> partial(s_out > 1 ? (size_t)tiles * BH * s_out * RT_F * rows_block : 0,
                             NAN);
  std::vector<int> counters(s_out > 1 ? (size_t)tiles * BH : 0, 0);
  const RowsArgs a = rows_args(q, k, v, mask, out, partial.data(), counters.data(), H, Lq, Lk,
                               hd, scale, R, s_in, s_out);
  void (*kernel)(RowsArgs) = nullptr;
#define EMU_PICK(R_, KS_, B_) \
  if (R == R_ && KS == KS_ && MINB == B_) kernel = masked_mha_rows_kernel<R_, KS_, B_>;
  K4_ROWS_INSTANCES(EMU_PICK)
  if (!kernel) return -1;
  gridDim = {(unsigned)a.tiles, (unsigned)BH, (unsigned)s_out};
  blockDim = {RT_THREADS, 1, 1};
  std::vector<dim3> blocks;
  for (unsigned y = 0; y < gridDim.y; ++y)
    for (unsigned x = 0; x < gridDim.x; ++x)
      for (unsigned z = 0; z < gridDim.z; ++z) blocks.push_back({x, y, z});
  if (reverse) std::reverse(blocks.begin(), blocks.end());
  for (const dim3& blk : blocks) {
    std::barrier<> block(RT_THREADS);
    g_block = &block;
    std::vector<std::thread> pool;
    for (int t = 0; t < RT_THREADS; ++t) {
      pool.emplace_back([&, t] {
        threadIdx = {(unsigned)t, 1, 1};
        blockIdx = blk;
        kernel(a);
      });
    }
    for (auto& t : pool) t.join();
  }
  int dirty = 0;
  for (int c : counters) dirty += c != 0;
  return dirty;
}
"""


# ex2.approx.ftz as the host computes it (no flush: a weight below 2^-126
# adds under 1e-38 to a sum of at least 1)
PTX = r"""
inline float ex2(float x) { return std::exp2(x); }
"""


def _kernel_source() -> str:
    """attention.cu up to its wide kernel, the namespace closed, its PTX
    replaced by the emulation's."""
    with open(os.path.join(build.CSRC_DIR, "attention.cu")) as f:
        src = f.read()
    src = src[:src.index("// ---- the wide kernel")] + "\n}  // namespace\n"
    a, b = src.index("// ---- PTX ----"), src.index("// ---- end of PTX ----")
    return src[:a] + PTX + src[b:]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's emulation")
    d = tmp_path_factory.mktemp("k4_emulation")
    for name, text in (("cuda_runtime.h", CUDA_RUNTIME_H), ("kernel.inc", _kernel_source()),
                       ("harness.cpp", HARNESS)):
        (d / name).write_text(text)
    so = d / "libk4emu.so"
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-fPIC", "-shared",
                        "-Wno-unknown-pragmas", f"-I{d}", "-o", str(so), str(d / "harness.cpp")],
                       capture_output=True, text=True)
    if r.returncode and "c++20" in r.stderr:
        pytest.skip("needs a g++ with C++20 (std::barrier)")
    assert r.returncode == 0, r.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    lib.emu_k4_rows.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float] + [
        ctypes.c_int] * 6
    return lib


def _inputs(b, h, lq, lk, hd, mask_kind, seed):
    """q, k, v [B, H, L, hd] and the padding mask [B, Lk] (True = masked),
    drawn with numpy."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, n, hd), dtype=np.float32))
               for n in (lq, lk, lk))
    if mask_kind is None:
        return q, k, v, None
    mask = torch.from_numpy(rng.random((b, lk)) < 0.3)
    if mask_kind == "a fully masked graph":
        mask[0] = True
    elif mask_kind in ("trailing", "leading"):
        # each graph padded as a batch pads it, or its padding first: whole
        # steps of masked keys, which the kernel skips
        n_real = torch.from_numpy(rng.integers(1, lk + 1, b))
        at = torch.arange(lk)[None, :]
        mask = at >= n_real[:, None] if mask_kind == "trailing" else at < lk - n_real[:, None]
    return q, k, v, mask


def _run(lib, q, k, v, mask, tile, reverse=False):
    b, h, lq, hd = q.shape
    lk = k.shape[2]
    r, ks, per_sm, s_in, s_out = tile
    out = torch.full((b, h, lq, hd), float("nan"))
    mask_u8 = None if mask is None else mask.to(torch.uint8).contiguous()
    dirty = lib.emu_k4_rows(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            None if mask_u8 is None else mask_u8.data_ptr(), out.data_ptr(),
                            b * h, h, lq, lk, hd, ca.scale_of(hd), r, ks, per_sm, s_in,
                            s_out, int(reverse))
    assert dirty == 0, f"{dirty} tickets not set back to 0" if dirty > 0 else "no such instance"
    return out


# (B, H, Lq, Lk, hd, mask, tiling): None takes the wrapper's tiling for the
# shape; the others force a branch or instance the served shapes do not take.
CASES = [
    (2, 3, 50, 70, 16, "a fully masked graph", None),   # s_in 4
    (2, 2, 7, 1, 16, "padding", None),                  # one key
    (1, 2, 130, 33, 16, None, None),                    # Lq off the tiles, s_in 1, no mask
    (2, 2, 67, 300, 16, "padding", None),               # s_in 2, Lk off the chunk
    (3, 2, 64, 512, 16, "trailing", None),              # padding keys last, as batched
    (3, 2, 200, 150, 16, "leading", None),              # padding keys first
    (1, 2, 40, 600, 16, "padding", None),               # s_in 4, s_out 2
    (2, 3, 50, 70, 8, "padding", None),                 # hd 8
    (1, 1, 1, 1, 5, None, None),                        # hd 5, one row, one key
    (2, 2, 45, 90, 5, "a fully masked graph", None),    # hd 5
    (2, 2, 100, 700, 16, "trailing", (2, 8, 4, 2, 4)),  # s_out 4 over padding keys
    (1, 2, 100, 300, 16, "padding", (2, 8, 4, 2, 4)),   # s_out 4, every block 75 keys
    (1, 2, 60, 5, 16, "padding", (2, 8, 4, 2, 4)),      # s_out 4, the last block empty
    (1, 2, 70, 40, 16, None, (2, 8, 4, 1, 1)),          # two warps of rows, one empty
    (2, 2, 300, 130, 16, "padding", (4, 8, 2, 1, 2)),   # R 4, s_out 2
    (2, 2, 140, 200, 8, "padding", (2, 16, 3, 2, 2)),   # KS 16, hd 8
]


@pytest.mark.parametrize("b,h,lq,lk,hd,mask_kind,tile", CASES)
def test_k4_row_kernel_matches_plain_emulated(emulated, b, h, lq, lk, hd, mask_kind, tile):
    q, k, v, mask = _inputs(b, h, lq, lk, hd, mask_kind, seed=b * 1000 + lq + lk + hd)
    if tile is None:
        kind, *tile = ca.tiling(b * h, lq, lk, hd)
        assert kind == "rows"
    got = _run(emulated, q, k, v, mask, tile)
    assert not torch.isnan(got).any(), "an output row was not written"
    torch.testing.assert_close(got, ca.masked_mha_plain(q, k, v, mask), **K4_TOL)
    if mask_kind == "a fully masked graph":
        # uniform weights over every key: the mean of v
        torch.testing.assert_close(got[0], v[0].mean(dim=1, keepdim=True).expand_as(got[0]),
                                   **K4_TOL)
    # a second run, and the grid walked the other way round: the same bits
    assert torch.equal(got, _run(emulated, q, k, v, mask, tile))
    assert torch.equal(got, _run(emulated, q, k, v, mask, tile, reverse=True))


def test_the_cases_take_every_branch_of_the_tiling():
    """The wrapper's tiling of the cases above takes every s_in, and s_out of
    1 and more."""
    picked = [tuple(ca.tiling(b * h, lq, lk, hd)[1:]) for b, h, lq, lk, hd, _, tile in CASES
              if tile is None]
    assert {t[:3] for t in picked} == {ca._ROWS}
    assert {t[3] for t in picked} == {1, 2, 4}
    assert {t[4] > 1 for t in picked} == {False, True}
