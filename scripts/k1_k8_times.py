#!/usr/bin/env python3
"""K1's and K8's device times with the padding row and without it, on the card.

    python3 scripts/k1_k8_times.py [--source FILE] [--tag NAME]

Builds FILE (default ``caster_dta_torch/csrc/segment.cu``; any version of it
with the same ``k1_segment_sum_sorted`` and ``k8_segment_sum_2d`` entry
points) with nvcc into ``caster_dta_torch/_build/k1_k8/``, and times both
entry points as ``chip_smoke.py`` times kernels (20 launches in a CUDA graph,
replays timed with CUDA events, L2 warm) at:

- K1: the protein aggregation of the flagship, Davis and large-protein
  buckets (f32 and bf16 messages) and the flagship's molecule aggregations
  (F=51 and F=16);
- K8: the same protein aggregations, on messages zeroed where masked.

Each case runs twice at the same shapes: with the edges as the bucket pads
them (every padding edge on row N-1, masked), and with no padding row, every
edge real and dst[b, e] = e // ceil(E / N), so that no row holds more than
ceil(E / N) edges. Beside each: ``index_add_`` on the same inputs and the longest
dst range (the edges of one row) of each graph set. Inputs are
``synthetic_pair_batch`` (seed 0) with N(0, 1) messages from a seeded card
generator. Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (bucket sizes, timing, nvidia-smi)
from caster_dta_torch.data.batching import synthetic_pair_batch  # noqa: E402
from caster_dta_torch.ops import build  # noqa: E402

OUT = os.path.join(build.BUILD_DIR, "k1_k8")


def load(source: str, tag: str) -> ctypes.CDLL:
    os.makedirs(OUT, exist_ok=True)
    so = os.path.join(OUT, f"{tag}.so")
    r = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", so, source],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(r.stdout + r.stderr)
    entry = ""
    for line in (r.stdout + r.stderr).splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "segment_walk" in entry and ("registers" in line or "stack frame" in line):
            print(f"{entry}: {line.strip()}")
    lib = ctypes.CDLL(so)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.k1_segment_sum_sorted.argtypes = [vp, vp, vp, vp, i, i, i, i, i, vp]
    lib.k8_segment_sum_2d.argtypes = [vp, vp, vp, i, i, i, i, vp]
    return lib


def longest_range(dst: torch.Tensor) -> int:
    if dst.shape[1] == 0:
        return 0
    return max(int(torch.unique_consecutive(g, return_counts=True)[1].max()) for g in dst.cpu())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default=os.path.join(build.CSRC_DIR, "segment.cu"))
    ap.add_argument("--tag", default="segment")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_k8_times: needs an NVIDIA card", file=sys.stderr)
        return 1
    print(f"nvidia-smi: {chip_smoke.nvidia_smi()}")
    print(f"source {os.path.relpath(os.path.abspath(args.source), ROOT)} as {args.tag}")
    lib = load(args.source, args.tag)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def k1(msgs, dst, mask, out):
        b, e, f = msgs.shape
        err = lib.k1_segment_sum_sorted(msgs.data_ptr(), dst.data_ptr(), mask.data_ptr(),
                                        out.data_ptr(), b, e, out.shape[1], f,
                                        int(msgs.dtype == torch.bfloat16), stream())
        assert err == 0, err

    def k8(msgs, dst, out):
        b, e, f = msgs.shape
        err = lib.k8_segment_sum_2d(msgs.data_ptr(), dst.data_ptr(), out.data_ptr(), b, e,
                                    out.shape[1], f, stream())
        assert err == 0, err

    buckets = [("flagship", chip_smoke.FLAGSHIP), ("davis", chip_smoke.DAVIS),
               ("large protein", chip_smoke.LARGE)]
    for label, size in buckets:
        batch = synthetic_pair_batch(**size, seed=0)
        graphs = [("protein", batch.protein, (28,))]
        if label == "flagship":
            graphs.append(("molecule", batch.molecule, (51, 16)))
        for what, g, widths in graphs:
            dst, mask, n = g.edge_dst.cuda(), g.edge_mask.cuda(), g.n_pad
            b, e = dst.shape
            even = (torch.arange(e, device="cuda", dtype=torch.int32) // -(-e // n)).expand(b, e)
            forms = (("as padded", dst, mask),
                     ("no padding row", even.contiguous(), torch.ones_like(mask)))
            for f in widths:
                msgs32 = torch.randn(b, e, f, generator=gen, device="cuda")
                dtypes = (torch.float32, torch.bfloat16) if what == "protein" else (torch.float32,)
                for kernel in ("K1", "K8"):
                    for dtype in dtypes if kernel == "K1" else (torch.float32,):
                        if kernel == "K8" and what != "protein":
                            continue
                        parts = []
                        for form, d, m in forms:
                            x = msgs32
                            if kernel == "K8":
                                x = torch.where(m[..., None], x, 0.0).contiguous()
                            x = x.to(dtype)
                            out = torch.empty(b, n, f, device="cuda")
                            flat = torch.where(m[..., None], x.float(), 0.0).reshape(b * e, f)
                            rows = (d.long() + n * torch.arange(b, device="cuda")[:, None]).reshape(-1)
                            lib_out = torch.empty(b * n, f, device="cuda")

                            def library():
                                lib_out.zero_()
                                lib_out.index_add_(0, rows, flat)

                            if kernel == "K1":
                                ms = chip_smoke.graph_time_ms(torch, lambda: k1(x, d, m, out))
                            else:
                                ms = chip_smoke.graph_time_ms(torch, lambda: k8(x, d, out))
                            lib_ms = chip_smoke.graph_time_ms(torch, library)
                            parts.append(f"{form}: longest dst range {longest_range(d)}, "
                                         f"kernel {ms:.4f} ms, index_add_ {lib_ms:.4f} ms")
                        print(f"{args.tag} {kernel} {label} {what} aggregation F={f} "
                              f"{str(dtype)[6:]} B={b} E={e} N={n}: " + "; ".join(parts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
