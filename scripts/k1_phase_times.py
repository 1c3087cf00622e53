#!/usr/bin/env python3
"""Per-phase device times of K1's kernels (and of the narrow K3 kernel), on
the card.

    python3 scripts/k1_phase_times.py [--source FILE --tag NAME ...]

No profiler of this machine sees inside a kernel, so this script copies each
source (default ``caster_dta_torch/csrc/segment.cu``) into
``caster_dta_torch/_build/k1_phase/`` with ``%globaltimer`` stamps that
thread 0 of every block writes at the phase boundaries of
``segment_walk_kernel`` (start; the warp's outer and inner searches of its
rows' edge range; its short rows; the block's barrier; the long rows, which
on the zoo's graphs are the padding row's masked passes, for the blocks
that walked one and for the others), and, where the source has them,
``segment_small_kernel`` (stage; row bounds; sums), the narrow kernels
``segment_narrow_kernel`` (loads and ballots; placing the kept edges; row
starts; sums) and ``scatter_narrow_kernel`` (loads; count; column pass; row
scan; row starts; place; sums), and the tile kernels ``segment_tile_kernel``
and ``scatter_tile_kernel`` (loads staged; row bits and the barrier; K3's
row scan and places; sums).
The last stamp of a kernel follows a barrier, so it waits for the block's
slowest row. It builds the copies with nvcc and runs K1 on the flagship
protein graph (the zoo's) at F = 1, 2 and 32 and on its molecule graph at
F = 1, 16 and 51 (``synthetic_pair_batch``, seed 0; N(0, 1) messages), and
K3 at F = 1 and 2 on both graphs, on random rows and on segment_softmax's
cotangents (``chip_smoke.softmax_cotangent_cases``), and at F = 16 and 51
on the molecule graph by src (random rows, f32 and bf16) where the source
has the tile kernels.
For each case and kernel it prints, in microseconds, the median and the
largest duration of each phase over the blocks, the spread of the blocks'
start times, the span from the first start to the last stamp, and the
phases of the block that ends last (the one that sets the kernel's time). A
stamp costs a global store per block, so these times run a little above
the uninstrumented kernels'. It fails loudly when a source no longer has a
line that it stamps after.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (bucket sizes, nvidia-smi, softmax cotangents)
from caster_dta_torch.data.batching import synthetic_pair_batch  # noqa: E402
from caster_dta_torch.ops import build  # noqa: E402
from caster_dta_torch.ops import cuda_segment as cs  # noqa: E402

OUT = os.path.join(build.BUILD_DIR, "k1_phase")
STAMP = '''
__device__ unsigned long long g_stamp[8192][16];
__device__ __forceinline__ void stamp(int k) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    const unsigned blk = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    if (blk < 8192) g_stamp[blk][k] = t;
  }
}
'''
READ = '''extern "C" {
int phase_stamps_read(void* host) { return (int)cudaMemcpyFromSymbol(host, g_stamp, sizeof(g_stamp)); }
int phase_stamps_zero() {
  static unsigned long long zero[8192][16];
  return (int)cudaMemcpyToSymbol(g_stamp, zero, sizeof(zero));
}
'''
# kernel: (phase names by stamp slot, [(line the stamp follows, slot)]);
# slot 0 is the start
WALK = ({1: "outer search", 2: "inner search", 3: "short rows (warp 0)",
         4: "block barrier", 5: "long rows"},
        [("  const int g0 = n0 + warp * group;\n", 0),
         ("    const int lo = __shfl_sync(0xffffffffu, ends, 0), hi = "
          "__shfl_sync(0xffffffffu, ends, 16);\n", 1),
         ("      if (lane > 0) bound = from;\n    }\n", 2),
         ("      walk_group<T, MASKED>(msgs_b, dst_b, mask_b, out_b, r, r_end, start, end - start, "
          "F);\n      r = r_end;\n    }\n  }\n", 3),
         ("  stamp(3);\n  __syncthreads();\n", 4),   # the barrier after the short rows
         ("      if (warp == 0 && lane < fw) out_row[c0 + lane] = acc;\n    }\n  }\n", 5),
         ("    if (range.y < 0) continue;\n", 15)])   # a long row's start (the last)
SMALL = ({1: "stage", 2: "row bounds", 3: "sums"},
         [("  float v[SMALL_FLOATS / WALK_THREADS];\n", 0),
          ("  for (int r = tid; r <= N; r += WALK_THREADS) s_ptr[r] = E;  // rows past the last "
           "edge\n  __syncthreads();\n", 1),
          ("    for (int r = prev + 1; r <= min(d, N); ++r) s_ptr[r] = tid;\n  }\n"
           "  __syncthreads();\n", 2),
          ("      if (c0 + lane < F) out_b[(int64_t)r * F + c0 + lane] = acc;\n    }\n  }\n"
           "}\n", 3)])
K1_NARROW = ({1: "loads + ballots", 2: "place", 3: "row starts", 9: "sums"},
             [("  int q[NARROW_IPT];\n", 0),
              ("  if (lane == 0) warp_sum[warp] = count;\n  __syncthreads();\n", 1),
              ("      for (int f = 0; f < F; ++f) vals[k[j] * F + f] = v[j][f];\n    }\n  }\n"
               "  __syncthreads();\n", 2),
              ("  for (int r = last + 1 + tid; r <= nr; r += blockDim.x) start[r] = total;\n"
               "  __syncthreads();\n", 3)])
K3_NARROW = ({1: "loads + zero (warp 0)", 2: "count", 3: "column pass (thread 0)", 4: "row scan",
              5: "row starts", 6: "place", 9: "sums"},
             [("  int id[NARROW_IPT];\n", 0),
              ("  for (int r = lane; r < nr; r += 32) mine[r * NARROW_TABLE] = 0;\n"
               "  __syncwarp();\n", 1),
              ("      rank[j] = at + before;\n    }\n  }\n  __syncthreads();\n", 2),
              ("    start[r] = run;\n    own += run;\n  }\n", 3),
              ("  if (lane == 31) warp_sum[warp] = inc;\n  __syncthreads();\n", 4),
              ("  if (tid == 0) start[nr] = pre.y;\n  __syncthreads();\n", 5),
              ("      for (int f = 0; f < F; ++f) vals[p * F + f] = v[j][f];\n    }\n  }\n"
               "  __syncthreads();\n", 6)])
SUMS_END = "  narrow_sums<F>(vals, start, nr, out + ((int64_t)b * N + r0) * F);\n"
TILE = ({1: "loads staged", 2: "row bits + barrier", 3: "K3: row scan", 4: "K3: place", 9: "sums"},
        [("  int q[PER];  // edge tid + k * nt's row in the tile, -1 outside it\n", 0),
         ("  int d[PER], dp[PER];  // edge tid + k * nt's row and the previous edge's\n", 0),
         ("  tile_stage<WIDE>(rows + (int64_t)b * E * F, E, F, u0, su, nu, "
          "reinterpret_cast<float*>(vals));\n", 1),
         ("  tile_stage<WIDE>(msgs + (int64_t)b * E * F, E, F, u0, su, nu, "
          "reinterpret_cast<float*>(\n      tile_smem + vals_at));\n", 1),
         ("  __syncthreads();\n  if (tid < 32) {", 2),
         ("    if (lane == 31) start[nr] = inc;\n  }\n  __syncthreads();\n", 3),
         ("  __syncthreads();\n\n  // a thread per (row, unit): the row's run of sorted units, "
          "in order\n", 4),
         ("  __syncthreads();\n\n  float* out_b = out + ((int64_t)b * N + r0) * F;\n", 2)])
# the ends of the two tile kernels (K1's, K3's)
TILE_ENDS = ["    tile_store<WIDE>(out_b + (int64_t)q * F, (u0 + u) * 4, F, acc);\n  }\n}\n",
             "    tile_store<WIDE>(out_b + (int64_t)r * F, (u0 + u) * 4, F, acc);\n  }\n}\n"]


def instrumented(source: str) -> tuple:
    """The source with stamps, and whether it has the narrow kernels."""
    src = open(source).read()
    narrow = "segment_narrow_kernel" in src
    small = "segment_small_kernel" in src
    tile = "segment_tile_kernel" in src
    src = src.replace("namespace {\n", "namespace {\n" + STAMP, 1)
    anchors = WALK[1] + (K1_NARROW[1] + K3_NARROW[1] if narrow else []) + (
        TILE[1] if tile else [])
    if small:
        # the small kernel's last anchor ends the kernel: its stamp goes
        # before the closing brace, after a barrier
        small_end = SMALL[1][-1][0]
        if src.count(small_end) != 1:
            raise SystemExit(f"{source} has {src.count(small_end)} copies of {small_end!r}")
        src = src.replace(small_end, small_end[:-2] + "  __syncthreads();\n  stamp(3);\n}\n")
        anchors += SMALL[1][:-1]
    if tile:   # both tile kernels' ends, after a barrier
        for line in TILE_ENDS:
            if src.count(line) != 1:
                raise SystemExit(f"{source} has {src.count(line)} copies of {line!r}")
            src = src.replace(line, line[:-2] + "  __syncthreads();\n  stamp(9);\n}\n")
    for line, slot in anchors:
        if src.count(line) != 1:
            raise SystemExit(f"{source} has {src.count(line)} copies of {line!r}")
        src = src.replace(line, line + f"  stamp({slot});\n")
    if narrow:
        if src.count(SUMS_END) != 2:
            raise SystemExit(f"{source} has {src.count(SUMS_END)} copies of {SUMS_END!r}")
        src = src.replace(SUMS_END, SUMS_END + "  __syncthreads();\n  stamp(9);\n")
    return src.replace('extern "C" {\n', READ, 1), narrow


def load(item) -> tuple:
    tag, source = item
    text, narrow = instrumented(source)
    os.makedirs(OUT, exist_ok=True)
    stem = os.path.join(OUT, tag)
    with open(stem + ".cu", "w") as f:
        f.write(text)
    r = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", stem + ".so", stem + ".cu"],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(r.stdout + r.stderr)
    lib = ctypes.CDLL(stem + ".so")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.k1_segment_sum_sorted.argtypes = [vp, vp, vp, vp, i, i, i, i, i, vp]
    lib.k3_workspace_ints.argtypes, lib.k3_workspace_ints.restype = [i, i, i], ctypes.c_int64
    lib.k3_scatter_rows.argtypes = [vp, vp, vp, vp, i, i, i, i, i, vp]
    lib.phase_stamps_read.argtypes = [vp]
    for name in ("k1_route", "k3_route"):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = [i, i, i, i]
    lib.tile = "segment_tile_kernel" in text
    return lib, narrow


def stamps(lib, call) -> np.ndarray:
    for _ in range(3):
        call()
    lib.phase_stamps_zero()
    call()
    torch.cuda.synchronize()
    buf = np.zeros((8192, 16), dtype=np.uint64)
    assert lib.phase_stamps_read(buf.ctypes.data) == 0
    return buf.astype(np.int64)


def report(what: str, t: np.ndarray, names: dict) -> None:
    slots = [0] + sorted(names)
    t = t[t[:, 0] != 0][:, slots]
    if not len(t):
        print(f"{what}: no block stamped", flush=True)
        return
    t0 = t[:, 0].min()
    durations = {s: [] for s in slots[1:]}
    ends = np.zeros(len(t), dtype=np.int64)
    for row_i, row in enumerate(t):
        prev = row[0]
        for k, s in enumerate(slots[1:], 1):
            if row[k]:
                durations[s].append((row[k] - prev) / 1e3)
                prev = row[k]
        ends[row_i] = prev
    parts = [f"{what}: {len(t)} blocks, starts over {(t[:, 0].max() - t0) / 1e3:.2f}"]
    for s, d in durations.items():
        if d:
            parts.append(f"{names[s]} {np.median(d):.2f} (max {max(d):.2f}, {len(d)} blocks)")
    last = int(np.argmax(ends))
    parts.append(f"span {(ends.max() - t0) / 1e3:.2f}")
    row, prev, steps = t[last], t[last][0], []
    for k, s in enumerate(slots[1:], 1):
        if row[k]:
            steps.append(f"{names[s]} {(row[k] - prev) / 1e3:.2f}")
            prev = row[k]
    parts.append(f"last block (start +{(row[0] - t0) / 1e3:.2f}): " + ", ".join(steps))
    print("; ".join(parts), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[])
    ap.add_argument("--tag", action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_phase_times: needs an NVIDIA card", file=sys.stderr)
        return 1
    sources = dict(zip(args.tag, args.source)) or {
        "segment": os.path.join(build.CSRC_DIR, "segment.cu")}
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(load, sources.items())))
    print(f"{chip_smoke.nvidia_smi()}; times in microseconds (median and largest over blocks)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    batch = synthetic_pair_batch(**chip_smoke.FLAGSHIP, seed=0)
    for what, g, widths in (("zoo protein", batch.protein, (1, 2, 32)),
                            ("zoo molecule", batch.molecule, (1, 16, 51))):
        dst, mask, n = g.edge_dst.cuda(), g.edge_mask.cuda(), g.n_pad
        b, e = dst.shape
        for f in widths:
            msgs = torch.randn(b, e, f, generator=gen, device="cuda")
            out = torch.empty(b, n, f, device="cuda")
            for tag, (lib, narrow) in libs.items():
                route = lib.k1_route(b, e, n, f) if narrow else None
                small = route == 1 or (route is None and e * f <= 16384 and e <= 512
                                       and n <= 1024)
                kernel = (K1_NARROW if route == 0 else (TILE if lib.tile else SMALL) if small
                          else WALK)

                def call():
                    assert lib.k1_segment_sum_sorted(msgs.data_ptr(), dst.data_ptr(),
                                                     mask.data_ptr(), out.data_ptr(), b, e, n,
                                                     f, 0, stream) == 0

                t = stamps(lib, call)
                report(f"{tag} K1 {what} F={f} f32 B={b} E={e} N={n}", t, kernel[0])
                if kernel is WALK:   # the blocks that walked a long row, and the others
                    ran = t[:, 0] != 0
                    long_ = ran & (t[:, 15] != 0)
                    for part, sel in (("with a long row", long_), ("without", ran & ~long_)):
                        d = (t[sel, 5] - t[sel, 4]) / 1e3
                        print(f"  {part}: {int(sel.sum())} blocks, long rows phase "
                              + (f"{np.median(d):.2f} (max {d.max():.2f})" if len(d) else "-"),
                              flush=True)
    cotangents = {}   # (N, F) -> the denominators' cotangent, computed on the CPU
    for _, rows, _, n in chip_smoke.softmax_cotangent_cases(
            torch, batch, torch.Generator().manual_seed(1), dev="cpu"):
        cotangents.setdefault((n, rows.shape[2]), rows)
    for what, g in (("zoo protein", batch.protein), ("zoo molecule", batch.molecule)):
        ids, n = g.edge_dst.cuda(), g.n_pad
        b, e = ids.shape
        for f in (1, 2):
            inputs = [("random rows", torch.randn(b, e, f, generator=gen, device="cuda")),
                      ("softmax cotangent", cotangents[(n, f)].cuda())]
            for kind, rows32 in inputs:
                rows = rows32.to(torch.bfloat16)
                out = torch.empty(b, n, f, device="cuda")
                for tag, (lib, narrow) in libs.items():
                    if not narrow or lib.k3_route(b, e, n, f) != 0:
                        continue
                    ws = torch.empty(1, dtype=torch.int32, device="cuda")

                    def call():
                        assert lib.k3_scatter_rows(rows.data_ptr(), ids.data_ptr(), ws.data_ptr(),
                                                   out.data_ptr(), b, e, n, f, 1, stream) == 0

                    t = stamps(lib, call)
                    if not torch.equal(out.cpu(), cs.scatter_rows_plain(rows.cpu(), ids.cpu(), n)):
                        raise AssertionError(f"{tag} K3 {what} F={f} {kind}: not the plain bits")
                    report(f"{tag} K3 narrow {what} F={f} bf16 {kind} B={b} E={e} N={n}", t,
                           K3_NARROW[0])
    # the tile kernel's K3: the molecule gathers' cotangents by src
    ids, n = batch.molecule.edge_src.cuda(), batch.molecule.n_pad
    b, e = ids.shape
    for f in (16, 51):
        rows32 = torch.randn(b, e, f, generator=gen, device="cuda")
        for rows in (rows32, rows32.to(torch.bfloat16)):
            out = torch.empty(b, n, f, device="cuda")
            for tag, (lib, _) in libs.items():
                if not lib.tile:
                    continue
                ws = torch.empty(1, dtype=torch.int32, device="cuda")

                def call():
                    assert lib.k3_scatter_rows(rows.data_ptr(), ids.data_ptr(), ws.data_ptr(),
                                               out.data_ptr(), b, e, n, f,
                                               int(rows.dtype == torch.bfloat16), stream) == 0

                t = stamps(lib, call)
                if not torch.equal(out.cpu(), cs.scatter_rows_plain(rows.cpu(), ids.cpu(), n)):
                    raise AssertionError(f"{tag} K3 tile F={f}: not the plain bits")
                report(f"{tag} K3 tile zoo molecule by src F={f} {str(rows.dtype)[6:]} B={b} "
                       f"E={e} N={n}", t, TILE[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
