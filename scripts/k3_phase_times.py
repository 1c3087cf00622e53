#!/usr/bin/env python3
"""Per-phase device times of K3's kernels, on the card.

    python3 scripts/k3_phase_times.py

No profiler of this machine sees inside a kernel, so this script copies
``caster_dta_torch/csrc/segment.cu`` into ``caster_dta_torch/_build/k3_phase/``
with ``%globaltimer`` stamps that thread 0 of every block writes at the phase
boundaries of ``scatter_csr_kernel`` (the CSR build), ``scatter_small_kernel``
(the one-launch path) and ``scatter_sum_kernel`` (the start and the end of a
long-row block). Two more copies take the long-row blocks' row loads out
("chain only") or their add chain out ("loads only"). It builds the copies
with nvcc, runs K3 on the merged src||dst ids of the flagship, Davis and
large-protein buckets and on their molecule ids at F=51
(``synthetic_pair_batch``, seed 0; rows N(0, 1)), and prints, per case and
phase, the median and the largest duration over the blocks in microseconds,
the spread of the blocks' start times and the span from the first start to
the last stamp. A stamp costs a global store per block, so these times run a
little above the uninstrumented kernels'. It fails loudly when the source no
longer has a line that it stamps after.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (bucket sizes, k3_cases)
from caster_dta_torch.data.batching import synthetic_pair_batch  # noqa: E402
from caster_dta_torch.ops import build  # noqa: E402

OUT = os.path.join(build.BUILD_DIR, "k3_phase")
STAMP = '''
__device__ unsigned long long g_stamp[8192][16];
__device__ __forceinline__ void stamp(int k) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    const unsigned blk = blockIdx.x + blockIdx.y * gridDim.x;
    if (blk < 8192) g_stamp[blk][k] = t;
  }
}
'''
READ = '''extern "C" {
int k3_stamps_read(void* host) { return (int)cudaMemcpyFromSymbol(host, g_stamp, sizeof(g_stamp)); }
int k3_stamps_zero() {
  static unsigned long long zero[8192][16];
  return (int)cudaMemcpyToSymbol(g_stamp, zero, sizeof(zero));
}
'''
# (first stamp slot, phase names after the start, the lines that the stamps follow)
CSR = (0, ["zero", "count", "walker offsets + cluster sync", "cluster totals", "scan", "place",
           "final cluster sync"],
       ["  int* mine = table + (int64_t)warp * N;\n",
        "  for (int64_t i = tid; i < (int64_t)nw * N; i += blockDim.x) table[i] = 0;\n"
        "  __syncthreads();\n",
        "  k3_count(ids_b, lo, hi, N, mine);\n  __syncthreads();\n",
        "    tot[n] = run;\n  }\n  cluster.sync();\n",
        "    cols[n] = all;\n  }\n  __syncthreads();\n",
        "                                   warp_sum);\n",
        "  k3_place(ids_b, lo, hi, mine, csr.perm + (int64_t)b * E);\n",
        "  cluster.sync();  // no block leaves while another may still read its totals\n"])
SMALL = (8, ["stage ids and rows", "count", "scan + place", "sums"],
         ["  const T* rows_b = rows + (int64_t)b * EF;\n",
          "  for (int i = tid; i < walkers * N; i += blockDim.x) table[i] = 0;\n"
          "  __syncthreads();\n",
          "  if (warp < walkers) k3_count(s_ids, lo, hi, N, mine);\n  __syncthreads();\n",
          "    k3_place(s_ids, lo, hi, mine, perm);\n  }\n  __syncthreads();\n",
          "      out_b[(int64_t)n * F + f] = acc;\n    }\n  }\n"])
SUM = (13, ["long-row block"],
       ["  float* out_b = out + (int64_t)b * N * F;\n\n",
        "        if (warp == 0 && lane < fw) out_b[(int64_t)n * F + c0 + lane] = acc;\n"
        "      }\n    }\n"])
CHAIN = ("            acc = k3_chain(s_stage + buf * K3_TILE * 32 + lane,\n"
         "                           min(K3_TILE, count - t * K3_TILE), acc);\n")


def instrumented() -> dict:
    src = open(os.path.join(build.CSRC_DIR, "segment.cu")).read()
    src = src.replace("namespace {\n", "namespace {\n" + STAMP, 1)
    for base, _, anchors in (CSR, SMALL, SUM):
        for k, line in enumerate(anchors):
            if src.count(line) != 1:
                raise SystemExit(f"segment.cu has {src.count(line)} copies of {line!r}")
            src = src.replace(line, line + f"  stamp({base + k});\n")
    # the one-launch path's last stamp waits for the block's slowest warp
    src = src.replace(SMALL[2][-1] + "  stamp(12);", SMALL[2][-1] + "  __syncthreads();\n  stamp(12);")
    src = src.replace('extern "C" {\n', READ, 1)
    start = src.index("  const int u = threadIdx.x - 32;")
    end = src.index("// Warp 0 adds len staged values")
    return {"normal": src,
            "chain only": src[:start] + '  asm volatile("bar.sync 1, %0;" ::"r"(K3_LOADERS));\n'
                          '  asm volatile("bar.sync 1, %0;" ::"r"(K3_LOADERS));\n}\n\n' + src[end:],
            "loads only": src.replace(CHAIN, "            acc += s_stage[buf * K3_TILE * 32 + lane];\n")}


def load(item) -> ctypes.CDLL:
    name, src = item
    os.makedirs(OUT, exist_ok=True)
    stem = os.path.join(OUT, name.replace(" ", "_"))
    with open(stem + ".cu", "w") as f:
        f.write(src)
    r = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", stem + ".so", stem + ".cu"],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(r.stdout + r.stderr)
    lib = ctypes.CDLL(stem + ".so")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.k3_workspace_ints.argtypes, lib.k3_workspace_ints.restype = [i, i, i], ctypes.c_int64
    lib.k3_scatter_csr.argtypes = [vp, vp, i, i, i, vp]
    lib.k3_scatter_rows.argtypes = [vp, vp, vp, vp, i, i, i, i, i, vp]
    lib.k3_stamps_read.argtypes = [vp]
    return lib


def stamps(lib, call) -> np.ndarray:
    lib.k3_stamps_zero()
    call()
    torch.cuda.synchronize()
    buf = np.zeros((8192, 16), dtype=np.uint64)
    assert lib.k3_stamps_read(buf.ctypes.data) == 0
    return buf.astype(np.int64)


def report(what: str, t: np.ndarray, kernel) -> None:
    base, names, _ = kernel
    t = t[t[:, base] != 0, base:base + len(names) + 1]
    t0 = t[:, 0].min()
    parts = [f"{what}: {len(t)} blocks, starts over {(t[:, 0].max() - t0) / 1e3:.2f}"]
    last = 0
    for k, name in enumerate(names, 1):
        ok = t[:, k] != 0
        if ok.any():
            d = (t[ok, k] - t[ok, k - 1]) / 1e3
            parts.append(f"{name} {np.median(d):.2f} (max {d.max():.2f})")
            last = k
    parts.append(f"span {(t[:, last].max() - t0) / 1e3:.2f}")
    print("; ".join(parts), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_phase_times: needs an NVIDIA card", file=sys.stderr)
        return 1
    with ThreadPoolExecutor(3) as pool:
        libs = dict(zip(("normal", "chain only", "loads only"),
                        pool.map(load, instrumented().items())))
    print(f"{chip_smoke.nvidia_smi()}; times in microseconds (median and largest over blocks)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for label, size in (("flagship", chip_smoke.FLAGSHIP), ("davis", chip_smoke.DAVIS),
                        ("large protein", chip_smoke.LARGE)):
        batch = synthetic_pair_batch(**size, seed=0)
        for name, r32, ids, n in chip_smoke.k3_cases(torch, batch, gen)[:2]:
            b, e, f = r32.shape
            for dtype in (torch.bfloat16, torch.float32):
                rows = r32.to(dtype)
                out = torch.empty(b, n, f, device="cuda")
                for variant, lib in libs.items():
                    ws = torch.empty(lib.k3_workspace_ints(b, e, n), dtype=torch.int32,
                                     device="cuda")

                    def call_rows():
                        assert lib.k3_scatter_rows(rows.data_ptr(), ids.data_ptr(), ws.data_ptr(),
                                                   out.data_ptr(), b, e, n, f,
                                                   int(dtype == torch.bfloat16), stream) == 0

                    def call_csr():
                        assert lib.k3_scatter_csr(ids.data_ptr(), ws.data_ptr(), b, e, n,
                                                  stream) == 0

                    for _ in range(3):
                        call_rows()
                        call_csr()
                    what = f"{label} {name} {str(dtype)[6:]}"
                    t = stamps(lib, call_rows)
                    small = t[:, SMALL[0]].any()
                    if small:
                        if variant == "normal":
                            report(f"{what} one launch", t, SMALL)
                        continue
                    if variant == "normal":
                        report(f"{what} csr", stamps(lib, call_csr), CSR)
                    report(f"{what} sums [{variant}]", t, SUM)
    return 0


if __name__ == "__main__":
    sys.exit(main())
