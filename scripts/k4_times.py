#!/usr/bin/env python3
"""K4's device times on the card, for one or more versions of
``caster_dta_torch/csrc/attention.cu`` side by side.

    python3 scripts/k4_times.py [--source FILE [--tag NAME]] ...
        [--ablate loads|exp|products] ... [--sweep [--instances "R,KS,MINB ..."]]

Each ``--source`` (default ``caster_dta_torch/csrc/attention.cu``) is built
with nvcc into ``caster_dta_torch/_build/k4/`` (all builds at once), and its
ptxas lines (registers, stack frame, spills, shared memory) are printed, with
the blocks of each row-kernel instance that fit on one SM. A source without
the row kernel (``k4_masked_mha_rows``: the first version) is called
through its own C interface with its own tiling. At the served model's
cross-attention shapes (``runs/davis_seed9``: 8 heads of 16) of the
flagship, Davis and large-protein buckets, both directions, with each
bucket's padding masks (``chip_smoke.k4_cases``), every version is timed as
``chip_smoke.py`` times
kernels (20 launches in a CUDA graph, replays timed with CUDA events, L2
warm), in the order first, second, ..., second, first, beside the bound (the
larger of the bytes at 3.35 TB/s and the operations at 67 TF/s in f32,
``chip_smoke.k4_work``) and ``scaled_dot_product_attention`` on the same
inputs with an additive -1e9 mask.

``--ablate X`` also builds the last source with ``-DK4_ABLATE_X`` (see the
source's head: no K/V/mask loads, no ex2, or no FFMA chains) and times it
after the versions. ``--sweep`` times the last source's row kernel at every
instance, s_in and s_out at each case (the wrapper's pick marked), which is
how ``cuda_attention.tiling`` was chosen; ``--instances`` builds the last
source with those instances of the row kernel (``K4_ROWS_INSTANCES``) in
place of its own, for the sweep and its timed run.
Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (bucket sizes, K4 cases and work, timing, nvidia-smi)
from caster_dta_torch.data.batching import synthetic_pair_batch  # noqa: E402
from caster_dta_torch.inference.serve import load_run  # noqa: E402
from caster_dta_torch.ops import build  # noqa: E402
from caster_dta_torch.ops import cuda_attention as ca  # noqa: E402

OUT = os.path.join(build.BUILD_DIR, "k4")


def nvcc(source: str, so: str, defines=(), instances=None) -> str:
    """Build ``source`` (with -D ``defines``, and with the row kernel's
    ``instances`` through a file that defines them and includes it)."""
    if instances:
        wrapper = so[:-3] + ".cu"
        with open(wrapper, "w") as f:
            f.write("#define K4_ROWS_INSTANCES(X) " + " ".join(f"X({r}, {ks}, {b})"
                                                             for r, ks, b in instances)
                    + f'\n#include "{os.path.abspath(source)}"\n')
        source = wrapper
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, *[f"-D{d}" for d in defines], "-o", so, source]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(" ".join(cmd) + "\n" + r.stdout + r.stderr)
    return r.stdout + r.stderr


def demangle(names: list) -> list:
    tool = shutil.which("cu++filt") or os.path.join(os.path.dirname(build.find_nvcc()),
                                                     "cu++filt")
    if not os.path.isfile(tool):
        tool = shutil.which("c++filt")
    if not tool:
        return names
    r = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    out = r.stdout.splitlines()
    return [n.replace("(anonymous namespace)::", "") for n in out] if len(out) == len(names) \
        else names


def ptxas_lines(log: str) -> list:
    """ptxas's lines for the K4 kernels, each after its entry."""
    entries, lines, entry = [], [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
            entry = entry if "masked_mha" in entry else None
            if entry:
                entries.append(entry)
        elif entry and ("registers" in line or "stack frame" in line):
            lines.append((entry, line.strip()))
    names = dict(zip(entries, demangle(entries)))
    return [f"{names[e]}: {text}" for e, text in lines]


def parent_tiling(bh: int, lq: int, hd: int) -> tuple:
    """The first version's tiling (lanes per row, rows per block, key
    splits), for a source without the row kernel."""
    lanes = 1 << max(0, (hd - 1).bit_length() - 4)
    rows = min(128 // lanes, 1 << max(0, (lq - 1).bit_length()))
    splits = 128 // lanes // rows
    while splits < 32 and rows > 1 and -(-lq // rows) * bh < 2 * 132:
        rows //= 2
        splits *= 2
    return lanes, rows, min(splits, 32)


class Version:
    """One build of attention.cu, called through its own C interface."""

    def __init__(self, tag: str, lib: ctypes.CDLL):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.tag, self.lib = tag, lib
        self.rows_api = hasattr(lib, "k4_masked_mha_rows")
        if self.rows_api:
            lib.k4_masked_mha_rows.argtypes = [vp] * 7 + [i] * 5 + [f] + [i] * 5 + [vp]
            lib.k4_rows_blocks_per_sm.argtypes = [i, i, i]
        else:
            lib.k4_masked_mha.argtypes = [vp] * 5 + [i] * 5 + [f] + [i] * 3 + [vp]

    def tile(self, q, k) -> tuple:
        b, h, lq, hd = q.shape
        if self.rows_api:
            return ca.tiling(b * h, lq, k.shape[2], hd)
        return ("first version",) + parent_tiling(b * h, lq, hd)

    def call(self, q, k, v, mask, tile=None):
        """A function that launches this version's K4 on the inputs (with
        the row kernel's tiling ``tile`` = (R, KS, MINB, s_in, s_out) if
        given)."""
        b, h, lq, hd = q.shape
        lk = k.shape[2]
        out = torch.empty_like(q)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr())

        def stream():   # at each call: a graph captures on its own stream
            return torch.cuda.current_stream().cuda_stream

        if not self.rows_api:
            lanes, rows, splits = parent_tiling(b * h, lq, hd)
            launch = lambda: self.lib.k4_masked_mha(  # noqa: E731
                *ptrs, b * h, h, lq, lk, hd, ca.scale_of(hd), lanes, rows, splits, stream())
        else:
            r, ks, per_sm, s_in, s_out = tile or self.tile(q, k)[1:]
            rows_block = 32 * r * (4 // s_in)
            tiles = -(-lq // rows_block)
            partial = torch.empty(max(1, b * h * tiles * s_out * 18 * rows_block), device="cuda")
            counters = torch.zeros(b * h * tiles, dtype=torch.int32, device="cuda")
            launch = lambda: self.lib.k4_masked_mha_rows(  # noqa: E731
                *ptrs, partial.data_ptr(), counters.data_ptr(), b * h, h, lq, lk, hd,
                ca.scale_of(hd), r, ks, per_sm, s_in, s_out, stream())

        def call():
            err = launch()
            assert err == 0, f"{self.tag}: cudaError {err}"
            return out
        return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[])
    ap.add_argument("--tag", action="append", default=[])
    ap.add_argument("--ablate", action="append", default=[],
                    choices=["loads", "exp", "products"])
    ap.add_argument("--sweep", action="store_true",
                    help="time every tiling of the last source's row kernel")
    ap.add_argument("--instances", default="",
                    help="the row kernel's (R, KS, MINB) instances to build the last source "
                         "with, as 'R,KS,MINB R,KS,MINB ...'")
    args = ap.parse_args()
    sources = args.source or [os.path.join(build.CSRC_DIR, "attention.cu")]
    tags = args.tag + [f"v{k}" for k in range(len(args.tag), len(sources))]
    if not torch.cuda.is_available():
        print("k4_times: needs an NVIDIA card", file=sys.stderr)
        return 1
    print(f"nvidia-smi: {chip_smoke.nvidia_smi()}")
    os.makedirs(OUT, exist_ok=True)
    instances = [tuple(int(x) for x in i.split(",")) for i in args.instances.split()]
    jobs = [(src, os.path.join(OUT, f"{tag}.so"), (), None) for src, tag in zip(sources, tags)]
    jobs[-1] = jobs[-1][:3] + (instances,)
    jobs += [(sources[-1], os.path.join(OUT, f"{tags[-1]}-no-{x}.so"),
              (f"K4_ABLATE_{x.upper()}",), None) for x in args.ablate]
    tags += [f"{tags[-1]}-no-{x}" for x in args.ablate]
    with ThreadPoolExecutor(len(jobs)) as pool:
        logs = list(pool.map(lambda j: nvcc(*j), jobs))
    versions = []
    for (src, so, defines, inst), tag, log in zip(jobs, tags, logs):
        flags = " ".join(f"-D{d}" for d in defines) + (f" instances {inst}" if inst else "")
        print(f"source {os.path.relpath(os.path.abspath(src), ROOT)} {flags} as {tag}")
        for line in ptxas_lines(log):
            print(f"  {tag} {line}")
        v = Version(tag, ctypes.CDLL(so))
        if v.rows_api:
            v.instances = [x for x in sorted(set(instances) | {ca._ROWS})
                           if v.lib.k4_rows_blocks_per_sm(*x) > 0]
            print(f"  {tag} blocks of 128 threads an SM: " + ", ".join(
                f"{x}: {v.lib.k4_rows_blocks_per_sm(*x)}" for x in v.instances))
        versions.append(v)
    turns = versions[:len(sources)] + versions[:len(sources)][::-1] + versions[len(sources):]

    model = load_run(chip_smoke.RUN_DIR, device="cpu").model
    mha = model.cross_attn_module.cross_attn_layers[0].embed1_to_2
    heads, hd = mha.num_heads, mha.embed_dim // mha.num_heads
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    buckets = (("flagship", chip_smoke.FLAGSHIP, 0), ("davis", chip_smoke.DAVIS,
                                                      chip_smoke.N_REQUESTS_FLAGSHIP),
               ("large protein", chip_smoke.LARGE, chip_smoke.N_REQUESTS_FLAGSHIP + 1))
    for label, size, seed in buckets:
        batch = synthetic_pair_batch(**size, seed=seed)
        for name, q, k, v, mask in chip_smoke.k4_cases(torch, batch, gen, heads, hd):
            nbytes, ops = chip_smoke.k4_work(torch, q, mask)
            bound = max(nbytes / chip_smoke.HBM_BYTES_PER_S, ops / chip_smoke.F32_OPS_PER_S) * 1e3
            additive = torch.zeros(mask.shape, device="cuda").masked_fill(
                mask, -1e9)[:, None, None, :]
            sdpa = [chip_smoke.graph_time_ms(torch, lambda: torch.nn.functional.
                                             scaled_dot_product_attention(q, k, v,
                                                                          attn_mask=additive))
                    for _ in range(2)]
            want = ca.masked_mha_plain(q, k, v, mask)
            for x in versions[:len(sources)]:   # each version right, once, before timing
                err = (x.call(q, k, v, mask)() - want).abs().max().item()
                torch.cuda.synchronize()
                print(f"  {x.tag} max|K4 - plain| {err:.3e}")
            got = {x.tag: [] for x in versions}
            for x in turns:
                got[x.tag].append(chip_smoke.graph_time_ms(torch, x.call(q, k, v, mask)))
            print(f"K4 {label} {name} q {tuple(q.shape)} k {tuple(k.shape)}: bound "
                  f"{bound:.4f} ms (operations {ops}, bytes {nbytes}); SDPA "
                  f"{sdpa[0]:.4f} / {sdpa[1]:.4f} ms")
            for x in versions:
                ts = got[x.tag]
                print(f"  {x.tag} {x.tile(q, k)}: {' / '.join(f'{t:.4f}' for t in ts)} ms, "
                      f"{bound / min(ts):.1%} of bound")
            if args.sweep and versions[len(sources) - 1].rows_api:
                last = versions[len(sources) - 1]
                pick = last.tile(q, k)[1:]
                lk = k.shape[2]
                parts = []
                for inst in last.instances:
                    for s_in in (1, 2, 4):
                        for s_out in (1, 2, 4, 8, 16):
                            if s_out > 1 and lk < s_out * 128:
                                continue
                            t = inst + (s_in, s_out)
                            ms = chip_smoke.graph_time_ms(torch, last.call(q, k, v, mask, t))
                            parts.append(f"{t}{'*' if t == tuple(pick) else ''} {ms:.4f}")
                print(f"  sweep {last.tag} (R, KS, MINB, s_in, s_out) ms: " + ", ".join(parts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
