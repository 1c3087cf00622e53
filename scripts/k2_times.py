#!/usr/bin/env python3
"""K2's (row gather) device times on the card, for one or more versions of
``caster_dta_torch/csrc/segment.cu`` side by side.

    python3 scripts/k2_times.py [--source FILE [--tag NAME]] ...

Each ``--source`` (default ``caster_dta_torch/csrc/segment.cu``) is built
with nvcc into ``caster_dta_torch/_build/k2/`` (all builds at once) and
called through its own ``k2_gather_rows``: a source whose entry takes
(F, elem_bytes, load_bytes) gets the widest load the row and the table
allow (``cuda_segment.gather_load_bytes``), an older one (row_bytes,
vec_bytes) the widest vector that divides the row's bytes. Every version
is timed as ``chip_smoke.py`` times kernels (20 launches in a CUDA graph,
replays timed with CUDA events, L2 warm; each launch writes a new output, as
``gather_rows`` allocates one a call), in the order first, second, ...,
second, first, at every K2 shape of chip_smoke.py's ``times`` phase (the
served gathers of flagship #0 and Davis, the zoo's widths on flagship #0)
in f32 and bf16, and at chip_smoke.K2_ODD_WIDTHS on flagship #0's protein
merged indices; beside each, ``index_select`` on the same rows and the
bound (idx and the table rows it references read once, the output written
once, at 3.35 TB/s). Each version's output must equal the plain version's
bit for bit. Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (bucket sizes, cases, timing, nvidia-smi)
from caster_dta_torch.data.batching import synthetic_pair_batch  # noqa: E402
from caster_dta_torch.ops import build  # noqa: E402
from caster_dta_torch.ops import cuda_segment as cs  # noqa: E402

OUT = os.path.join(build.BUILD_DIR, "k2")


def nvcc(source: str, so: str) -> None:
    r = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", so, source],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(r.stdout + r.stderr)


class Version:
    """One build of segment.cu and its K2 entry."""

    def __init__(self, tag: str, source: str, so: str):
        self.tag, self.lib = tag, ctypes.CDLL(so)
        with open(source) as f:
            self.runs = "int elem_bytes, int load_bytes" in f.read()
        vp, i = ctypes.c_void_p, ctypes.c_int
        self.lib.k2_gather_rows.argtypes = [vp, vp, vp] + [i] * (6 if self.runs else 5) + [vp]

    def call(self, table, idx, out):
        """One call into `out`, or into a new tensor of its shape each call
        (as gather_rows allocates) where out is None."""
        b, n, f = table.shape
        fresh = out is None
        if fresh:
            out = torch.empty(b, idx.shape[1], f, dtype=table.dtype, device=table.device)
        if self.runs:
            sizes = (f, table.element_size(), cs.gather_load_bytes(table))
        else:
            row_bytes = f * table.element_size()
            sizes = (row_bytes, cs._vec_bytes(cs.K2, row_bytes, table.data_ptr(),
                                              out.data_ptr()))

        def run():   # on the current stream, which a graph capture replaces
            dst = torch.empty_like(out) if fresh else out
            err = self.lib.k2_gather_rows(table.data_ptr(), idx.data_ptr(), dst.data_ptr(), b,
                                          idx.shape[1], n, *sizes,
                                          torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
            return dst
        return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[])
    ap.add_argument("--tag", action="append", default=[])
    args = ap.parse_args()
    sources = args.source or [os.path.join(build.CSRC_DIR, "segment.cu")]
    tags = args.tag + [f"v{k}" for k in range(len(args.tag), len(sources))]
    if not torch.cuda.is_available():
        print("k2_times: needs an NVIDIA card", file=sys.stderr)
        return 1
    print(f"nvidia-smi: {chip_smoke.nvidia_smi()}")
    os.makedirs(OUT, exist_ok=True)
    jobs = [(src, os.path.join(OUT, f"{tag}.so")) for src, tag in zip(sources, tags)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda j: nvcc(*j), jobs))
    versions = [Version(tag, src, so) for (src, so), tag in zip(jobs, tags)]
    for (src, _), tag in zip(jobs, tags):
        print(f"source {os.path.relpath(os.path.abspath(src), ROOT)} as {tag}")
    turns = versions + versions[::-1]

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flagship = synthetic_pair_batch(**chip_smoke.FLAGSHIP, seed=0)
    davis = synthetic_pair_batch(**chip_smoke.DAVIS, seed=chip_smoke.N_REQUESTS_FLAGSHIP)
    cases = [("flagship #0", c) for c in chip_smoke.kernel_cases(torch, flagship, gen)["K2"]]
    cases += [("flagship #0", c) for c in chip_smoke.zoo_kernel_cases(torch, flagship, gen)["K2"]]
    cases += [("davis", c) for c in chip_smoke.kernel_cases(torch, davis, gen)["K2"]]
    p = flagship.protein.to("cuda")
    merged = torch.cat([p.edge_src, p.edge_dst], 1)
    cases += [("flagship #0", (f"protein merged gather F={f}",
                               torch.randn(p.batch_size, p.n_pad, f, generator=gen,
                                           device="cuda"), merged))
              for f in chip_smoke.K2_ODD_WIDTHS]
    for label, (name, table32, idx) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            table = table32.to(dtype)
            b, n, f = table.shape
            e = idx.shape[1]
            out = torch.empty(b, e, f, dtype=dtype, device="cuda")
            want = cs.gather_rows_plain(table, idx)
            times = {v.tag: [] for v in versions}
            for v in turns:
                out.fill_(float("nan"))
                v.call(table, idx, out)()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"{v.tag} K2 {label} {name} {dtype}: not bit-exact")
                times[v.tag].append(chip_smoke.graph_time_ms(torch, v.call(table, idx, None)))
            flat = table.reshape(b * n, f)
            rows = (idx.long() + n * torch.arange(b, device="cuda")[:, None]).reshape(-1)
            lib = chip_smoke.graph_time_ms(
                torch, lambda: torch.index_select(flat, 0, rows, out=out.view(b * e, f)))
            size = table.element_size()
            nbytes = idx.numel() * 4 + (int(torch.unique(rows).numel()) + b * e) * f * size
            bound = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
            parts = "; ".join(f"{tag} {' / '.join(f'{t:.4f}' for t in ts)} ms"
                              for tag, ts in times.items())
            print(f"K2 {label} {name} {str(dtype)[6:]} table {tuple(table.shape)} idx "
                  f"{tuple(idx.shape)}: {parts}; index_select {lib:.4f} ms; bound {bound:.4f} "
                  f"ms (bytes); loads {cs.gather_load_bytes(table)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
