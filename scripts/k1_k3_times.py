#!/usr/bin/env python3
"""K1's and K3's device times for several versions of ``segment.cu`` side by
side, at every shape the port runs them at, on the card.

    python3 scripts/k1_k3_times.py --source A.cu --tag a --source B.cu --tag b \
        [--set TAG:NAME=VALUE[,NAME=VALUE...]] [--rounds 2] [--only narrow|wide|small]

Builds each source with nvcc (all at once) into
``caster_dta_torch/_build/k1_k3/``; ``--set`` adds a copy of the repo's
``caster_dta_torch/csrc/segment.cu`` with the named ``constexpr int``
constants changed (``--set wide:K3_NARROW_F=4,K1_NARROW_F=4`` takes rows of up
to 4 columns to the narrow kernels, to find where they stop paying). Each
case is timed as ``chip_smoke.py`` times kernels (20 launches in a CUDA
graph, replays timed with CUDA events, L2 warm), each version in turn, the
order reversed every other round (a, b, b, a), beside ``index_add_`` on the
same inputs and the bound (inputs read and outputs written once at 3.35
TB/s; K1 reads only its real edges' rows, K3 every row). A version that
exports ``k1_route`` / ``k3_route`` names the kernel it runs.

Cases (``synthetic_pair_batch`` seed 0 at chip_smoke's buckets; N(0, 1)
rows from a seeded card generator):

- wide: K1 at the protein aggregation of the flagship (f32, bf16), Davis and
  large-protein buckets (F=28); K3 at the merged src||dst backward of the
  three buckets (F=28, bf16 and f32 at the flagship); both at the zoo's
  widths 32 and 128 on the flagship protein graph;
- small (the molecule graphs, the tile kernels' route): K1 at the flagship
  molecule aggregations (F=16, 51) and the zoo's F=59, K3 at the molecule
  gathers' backward by src (F=16, 51), f32 and bf16, at the flagship (B=32)
  and at the evaluate phase's batches (``chip_smoke.EVAL_MOLECULE_PADS``,
  B=8: 48 and 128 rows, 256 edges); K8 (f32, every edge counting) at the
  flagship molecule graph, F=16 and 51, whose route K1's rule names;
- narrow: both at F = 1, 2, 3 and 4 on the flagship protein graph (the zoo's
  graph) and its molecule graph, f32 and bf16, at B = 1 and 3 (its first
  graphs) and at the Davis protein graph; K3 also on segment_softmax's own
  cotangents at H = 1 and 2 (``chip_smoke.softmax_cotangent_cases`` on the
  CPU: +-0 on the masked edges).

Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (bucket sizes, timing, nvidia-smi)
from caster_dta_torch.data.batching import synthetic_pair_batch  # noqa: E402
from caster_dta_torch.ops import build  # noqa: E402
from caster_dta_torch.ops import cuda_segment as cs  # noqa: E402

OUT = os.path.join(build.BUILD_DIR, "k1_k3")
NARROW_WIDTHS = (1, 2, 3, 4)


def with_constants(source: str, settings: str) -> str:
    """The text of ``source`` with each ``constexpr int NAME = ...;`` of
    ``settings`` ("NAME=VALUE,...") set to VALUE."""
    text = open(source).read()
    for item in settings.split(","):
        name, value = item.split("=")
        text, n = re.subn(rf"constexpr int {name} = [^;]+;", f"constexpr int {name} = {value};",
                          text)
        if n != 1:
            raise SystemExit(f"{source} has {n} definitions of {name}")
    return text


def load(item) -> ctypes.CDLL:
    tag, source = item
    os.makedirs(OUT, exist_ok=True)
    stem = os.path.join(OUT, re.sub(r"\W", "_", tag))
    r = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", stem + ".so", source],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(r.stdout + r.stderr)
    entry = ""
    for line in (r.stdout + r.stderr).splitlines():   # the narrow kernels' registers
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif ("narrow" in entry or "tile" in entry) and ("registers" in line or "spill" in line):
            print(f"{tag} {entry}: {line.strip()}", flush=True)
    lib = ctypes.CDLL(stem + ".so")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.k1_segment_sum_sorted.argtypes = [vp, vp, vp, vp, i, i, i, i, i, vp]
    lib.k3_workspace_ints.argtypes, lib.k3_workspace_ints.restype = [i, i, i], ctypes.c_int64
    lib.k3_scatter_rows.argtypes = [vp, vp, vp, vp, i, i, i, i, i, vp]
    lib.k8_segment_sum_2d.argtypes = [vp, vp, vp, i, i, i, i, vp]
    for name in ("k1_route", "k3_route"):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = [i, i, i, i]
    # a version without the tile kernels numbers its routes without them
    lib.route_names = ((cs.K1_ROUTES, cs.K3_ROUTES) if "segment_tile_kernel" in open(source).read()
                       else (("narrow", "small", "walk"), ("narrow", "small", "csr + sum")))
    return lib


def cases(only: str) -> list:
    """(kernel, label, inputs on the card, N, bytes for the bound)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    flag = synthetic_pair_batch(**chip_smoke.FLAGSHIP, seed=0)
    davis = synthetic_pair_batch(**chip_smoke.DAVIS, seed=0)
    large = synthetic_pair_batch(**chip_smoke.LARGE, seed=0)
    out = []

    def k1(label, g, f, dtypes, graphs=None):
        dst, mask = g.edge_dst.cuda(), g.edge_mask.cuda()
        if graphs is not None:
            dst, mask = dst[:graphs].contiguous(), mask[:graphs].contiguous()
        b, e = dst.shape
        msgs = torch.randn(b, e, f, generator=gen, device="cuda")
        for dtype in dtypes:
            out.append(("K1", f"{label} F={f} {str(dtype)[6:]} B={b}", (msgs.to(dtype), dst, mask),
                        g.n_pad))

    def k3(label, ids, n, f, dtypes, rows=None):
        b, e = ids.shape
        if rows is None:
            rows = torch.randn(b, e, f, generator=gen, device="cuda")
        for dtype in dtypes:
            out.append(("K3", f"{label} F={f} {str(dtype)[6:]} B={b}",
                        (rows.to(dtype).contiguous(), ids.contiguous()), n))

    f32, bf16 = torch.float32, torch.bfloat16
    p, m = flag.protein, flag.molecule
    if only in (None, "wide"):
        k1("flagship protein", p, 28, (f32, bf16))
        k1("davis protein", davis.protein, 28, (f32,))
        k1("large protein", large.protein, 28, (f32, bf16))
        for f in (32, 128):
            k1("zoo protein", p, f, (f32,))
        for label, batch in (("flagship", flag), ("davis", davis), ("large protein", large)):
            merged = torch.cat([batch.protein.edge_src, batch.protein.edge_dst], 1).cuda()
            k3(f"{label} merged", merged, batch.protein.n_pad, 28,
               (bf16, f32) if label == "flagship" else (bf16,))
        for f in (32, 128):
            k3("zoo protein", p.edge_dst.cuda(), p.n_pad, f, (bf16,))
    if only in (None, "small"):
        evaluate = [(f"evaluate molecule N={n_m}", synthetic_pair_batch(
            chip_smoke.EVAL_BATCH, 128, 1024, n_m, e_m, seed=90 + i).molecule)
            for i, (n_m, e_m) in enumerate(chip_smoke.EVAL_MOLECULE_PADS)]
        for label, g in [("flagship molecule", m)] + evaluate:
            for f in (16, 51) + ((59,) if g is m else ()):
                k1(label, g, f, (f32, bf16))
            for f in (16, 51):
                k3(label, g.edge_src.cuda(), g.n_pad, f, (f32, bf16))
        for f in (16, 51):   # K8 (every edge counts) on the same tile kernel as K1
            dst, mask = m.edge_dst.cuda(), m.edge_mask.cuda()
            msgs = torch.randn(*dst.shape, f, generator=gen, device="cuda")
            out.append(("K8", f"flagship molecule F={f} float32 B={dst.shape[0]}",
                        (torch.where(mask[..., None], msgs, 0.0).contiguous(), dst), m.n_pad))
    if only in (None, "narrow"):
        for f in NARROW_WIDTHS:
            k1("zoo protein", p, f, (f32, bf16))
            k1("zoo molecule", m, f, (f32, bf16))
            k3("zoo protein", p.edge_dst.cuda(), p.n_pad, f, (bf16, f32))
            k3("zoo molecule", m.edge_dst.cuda(), m.n_pad, f, (bf16, f32))
        for f in (1, 2):
            for graphs in (1, 3):
                k1("zoo protein", p, f, (f32,), graphs)
                k3("zoo protein", p.edge_dst[:graphs].cuda(), p.n_pad, f, (bf16,))
            k1("davis protein", davis.protein, f, (f32,))
            k3("davis protein", davis.protein.edge_dst.cuda(), davis.protein.n_pad, f, (bf16,))
        # computed on the CPU (the plain versions), timed on the card
        for name, rows, ids, n in chip_smoke.softmax_cotangent_cases(
                torch, flag, torch.Generator().manual_seed(1), dev="cpu"):
            k3(name, ids.cuda(), n, rows.shape[2], (bf16, f32), rows.cuda())
    return out


def work_bytes(kernel, inputs, n) -> int:
    if kernel == "K1":
        msgs, dst, mask = inputs
        b, e, f = msgs.shape
        return (int(mask.sum()) * f * msgs.element_size() + dst.numel() * 4 + mask.numel()
                + b * n * f * 4)
    rows, ids = inputs   # K3 and K8: every row counts
    b, e, f = rows.shape
    return rows.numel() * rows.element_size() + ids.numel() * 4 + b * n * f * 4


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[])
    ap.add_argument("--tag", action="append", default=[])
    ap.add_argument("--set", action="append", default=[], metavar="TAG:NAME=VALUE,...")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", choices=("narrow", "wide", "small"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_k3_times: needs an NVIDIA card", file=sys.stderr)
        return 1
    if len(args.source) != len(args.tag):
        raise SystemExit("give a --tag for every --source")
    sources = dict(zip(args.tag, args.source))
    os.makedirs(OUT, exist_ok=True)
    for spec in args.set:
        tag, settings = spec.split(":", 1)
        path = os.path.join(OUT, re.sub(r"\W", "_", tag) + ".cu")
        with open(path, "w") as f:
            f.write(with_constants(os.path.join(build.CSRC_DIR, "segment.cu"), settings))
        sources[tag] = path
    print(f"nvidia-smi: {chip_smoke.nvidia_smi()}")
    for tag, source in sources.items():
        print(f"{tag}: {os.path.relpath(os.path.abspath(source), ROOT)}")
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(load, sources.items())))
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    for kernel, label, inputs, n in cases(args.only):
        if kernel == "K1":
            msgs, dst, mask = inputs
            b, e, f = msgs.shape
            bf16 = int(msgs.dtype == torch.bfloat16)
            out = torch.empty(b, n, f, device="cuda")
            flat = torch.where(mask[..., None], msgs.float(), 0.0).reshape(b * e, f)
            rows_i = (dst.long() + n * torch.arange(b, device="cuda")[:, None]).reshape(-1)
            want = cs.segment_sum_sorted_plain(msgs.cpu(), dst.cpu(), mask.cpu(), n)

            def call(lib):
                assert lib.k1_segment_sum_sorted(msgs.data_ptr(), dst.data_ptr(),
                                                 mask.data_ptr(), out.data_ptr(), b, e, n, f,
                                                 bf16, stream()) == 0
        elif kernel == "K8":
            msgs, dst = inputs
            b, e, f = msgs.shape
            out = torch.empty(b, n, f, device="cuda")
            flat = msgs.reshape(b * e, f)
            rows_i = (dst.long() + n * torch.arange(b, device="cuda")[:, None]).reshape(-1)
            want = cs.segment_sum_2d_plain(msgs.cpu(), dst.cpu(), n)

            def call(lib):
                assert lib.k8_segment_sum_2d(msgs.data_ptr(), dst.data_ptr(), out.data_ptr(), b,
                                             e, n, f, stream()) == 0
        else:
            rows, ids = inputs
            b, e, f = rows.shape
            bf16 = int(rows.dtype == torch.bfloat16)
            out = torch.empty(b, n, f, device="cuda")
            flat = rows.reshape(b * e, f)
            rows_i = (ids.long() + n * torch.arange(b, device="cuda")[:, None]).reshape(-1)
            want = cs.scatter_rows_plain(rows.cpu(), ids.cpu(), n)
            ws = {tag: torch.empty(max(1, lib.k3_workspace_ints(b, e, n)), dtype=torch.int32,
                                   device="cuda") for tag, lib in libs.items()}

            def call(lib):
                assert lib.k3_scatter_rows(rows.data_ptr(), ids.data_ptr(),
                                           ws[tag_of[id(lib)]].data_ptr(), out.data_ptr(), b, e,
                                           n, f, bf16, stream()) == 0
        tag_of = {id(lib): tag for tag, lib in libs.items()}
        lib_out = torch.empty(b * n, f, device="cuda")

        def library():
            lib_out.zero_()
            lib_out.index_add_(0, rows_i, flat.float())

        routes, times = {}, {tag: [] for tag in libs}
        for tag, lib in libs.items():
            rule = getattr(lib, f"{'k1' if kernel == 'K8' else kernel.lower()}_route", None)
            names = lib.route_names[kernel == "K3"]
            routes[tag] = names[rule(b, e, n, f)] if rule is not None else "parent's"
            call(lib)
            torch.cuda.synchronize()
            if not torch.equal(out.cpu(), want):
                raise AssertionError(f"{kernel} {label} {tag}: not the plain version's bits")
        order = list(libs)
        for r in range(args.rounds):
            for tag in (order if r % 2 == 0 else order[::-1]):
                times[tag].append(chip_smoke.graph_time_ms(torch, lambda: call(libs[tag])))
        lib_ms = chip_smoke.graph_time_ms(torch, library)
        bound = work_bytes(kernel, inputs, n) / chip_smoke.HBM_BYTES_PER_S * 1e3
        print(f"{kernel} {label} E={e} N={n}: " + "; ".join(
            f"{tag} ({routes[tag]}) {statistics.median(t):.4f} ms "
            f"[{' '.join(f'{x:.4f}' for x in t)}]" for tag, t in times.items())
            + f"; index_add_ {lib_ms:.4f} ms; bound {bound:.5f} ms; bit for bit the plain "
              f"version", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
