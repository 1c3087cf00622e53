#!/usr/bin/env python3
"""K5's error on the card against its contract with exact sums.

    python3 scripts/k5_bwd_error.py [--source FILE]

K5's contract fixes where values are rounded to the compute dtype but not
the order of its f32 sums. So the plain version on the card, K5 of this tree
(``caster_dta_torch/csrc/gvp_message.cu``) and, with ``--source``, K5 of
another version of that file are each held against the plain version with
the same rounding points and f64 sums, at the flagship cases of
``chip_smoke.py`` (the served model's message weights, ``runs/davis_seed9``):
K5 fwd in f32 and with the bf16 step's dtypes, K5 bwd with the bf16 step's.
Prints, for every output tensor, its largest entry and max |x - exact| /
that entry for each version; and, with ``--source``, whether each K5 fwd
case gives the other version's bits.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from caster_dta_torch.inference.serve import load_run  # noqa: E402
from caster_dta_torch.ops import cuda_gvp_message as cgm  # noqa: E402
from scripts.k5_k6_times import OUT, Version, nvcc  # noqa: E402


def other_bwd(source: str, both, es, ev, weights, dout, spec):
    """K5 bwd of another version of gvp_message.cu, through its C interface."""
    os.makedirs(OUT, exist_ok=True)
    so = os.path.join(OUT, "error_other.so")
    if not os.path.isfile(so):
        nvcc(source, so)
    v = Version("other", ctypes.CDLL(so))
    b, e, se = es.shape
    w = cgm._pack(weights)
    dims = cgm._layer_dims(weights, spec, se, 1)
    flat = [x for d in dims for x in d]
    dims_host = (ctypes.c_int * len(flat))(*flat)
    dims_dev = torch.tensor(flat, dtype=torch.int32, device="cuda")
    dboth, des, dev = torch.empty_like(both), torch.empty_like(es), torch.empty_like(ev)
    dw = torch.empty(w.numel(), device="cuda")
    partial = torch.empty(v.bwd_rows(dims_host, len(dims), 1, b * e), w.numel(), device="cuda")
    isb = cgm._is_bf16
    err = v.lib.k5_message_bwd(
        both.data_ptr(), es.data_ptr(), ev.data_ptr(), w.data_ptr(), dims_dev.data_ptr(),
        dims_host, dout.data_ptr(), dboth.data_ptr(), des.data_ptr(), dev.data_ptr(),
        partial.data_ptr(), dw.data_ptr(), b, e, spec.ns, spec.nv, se, 1, len(dims), w.numel(),
        cgm._ACT_CODES[spec.act_s], cgm._ACT_CODES[spec.act_v], isb(both), isb(es), isb(ev),
        isb(dout), 1, torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    sizes = [t.numel() for t in weights]
    return dboth, des, dev, [g.view(t.shape) for g, t in zip(dw.split(sizes), weights)]


def other_fwd(source: str, both, es, ev, weights, spec):
    """K5 fwd of another version of gvp_message.cu, through its C interface."""
    os.makedirs(OUT, exist_ok=True)
    so = os.path.join(OUT, "error_other.so")
    if not os.path.isfile(so):
        nvcc(source, so)
    v = Version("other", ctypes.CDLL(so))
    b, e, se = es.shape
    w = cgm._pack(weights)
    dims = cgm._layer_dims(weights, spec, se, 1)
    flat = [x for d in dims for x in d]
    dims_host = (ctypes.c_int * len(flat))(*flat)
    dims_dev = torch.tensor(flat, dtype=torch.int32, device="cuda")
    out = torch.empty(b, e, dims[-1][1] + 3 * dims[-1][2], dtype=both.dtype, device="cuda")
    isb = cgm._is_bf16
    err = v.lib.k5_message_fwd(
        both.data_ptr(), es.data_ptr(), ev.data_ptr(), w.data_ptr(), dims_dev.data_ptr(),
        dims_host, out.data_ptr(), b, e, spec.ns, spec.nv, se, 1, len(dims), w.numel(),
        cgm._ACT_CODES[spec.act_s], cgm._ACT_CODES[spec.act_v], isb(both), isb(es), isb(ev),
        cgm._cdt_bf16(spec), torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return out


def exact_sums(fn):
    """fn() with the plain versions' rounding points kept and every product
    and sum in f64."""
    rnd = cgm._rnd
    cgm._rnd = lambda x, cdt: x.to(cdt).to(torch.float64)
    try:
        return fn()
    finally:
        cgm._rnd = rnd


def print_errors(title: str, names, exact, flat: dict) -> None:
    print(f"{title}, max |x - exact| / max |exact|: " + ", ".join(flat))
    for i, (name, ref) in enumerate(zip(names, exact)):
        ref = ref.double()
        scale = ref.abs().max().item()
        errs = [(x[i].double() - ref).abs().max().item() / scale if scale else 0.0
                for x in flat.values()]
        print(f"  {name}: max|exact| {scale:.3e}; " + ", ".join(
            f"{k} {r:.3e}" for k, r in zip(flat, errs)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", help="another version of gvp_message.cu to hold alongside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k5_bwd_error: needs an NVIDIA card", file=sys.stderr)
        return 1
    print(f"nvidia-smi: {chip_smoke.nvidia_smi()}")
    conv = load_run(chip_smoke.RUN_DIR, device="cuda").model.protein_gnn.gnn_model.conv_list[0].conv
    weights = [w.detach() for w in cgm.layer_weights(conv.message_func)]
    spec = cgm.MessageSpec(16, 4, conv.activations[0], conv.activations[1], torch.bfloat16)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    b, e = chip_smoke.FLAGSHIP["b"], chip_smoke.FLAGSHIP["e_p"]
    other = os.path.relpath(os.path.abspath(args.source), ROOT) if args.source else None
    for kind in chip_smoke.K5_DTYPES:
        fspec = cgm.MessageSpec(spec.ns, spec.nv, spec.act_s, spec.act_v,
                                getattr(torch, chip_smoke.K5_DTYPES[kind][3]))
        fb, fes, fev, _ = chip_smoke.k5_inputs(torch, gen, b, e, kind)
        outs = {f"this tree ({cgm.fwd_kernel(fb, fes, fev, weights, fspec)})":
                cgm.message_fwd(fb, fes, fev, weights, fspec)}
        if other:
            outs[other] = other_fwd(args.source, fb, fes, fev, weights, fspec)
        outs["plain f32"] = cgm.message_fwd_plain(fb, fes, fev, weights, fspec)

        def exact_fwd():
            s, v, _ = cgm._forward_layers(fb, fes, fev, weights, fspec, keep=False)
            return torch.cat([s, v.reshape(s.shape[0], -1)], -1).reshape(b, e, -1)

        print_errors(f"K5 fwd flagship {kind} B={b} E={e}", ["out"], [exact_sums(exact_fwd)],
                     {k: [x] for k, x in outs.items()})
        if other:
            mine = next(iter(outs.values()))
            same = torch.equal(mine, outs[other])
            d = (mine.float() - outs[other].float()).abs().max().item()
            print(f"  K5 fwd {kind}: this tree {'gives' if same else 'does not give'} the bits of "
                  f"{other} (max |d| {d:.3e})")
    gen.manual_seed(0)   # K5 bwd's inputs as the script has always drawn them
    both, es, ev, dout = chip_smoke.k5_inputs(torch, gen, b, e, "bf16 step")
    runs = {"this tree": cgm.message_bwd(both, es, ev, weights, dout, spec)}
    if other:
        runs[other] = other_bwd(args.source, both, es, ev, weights, dout, spec)
    runs["plain f32"] = cgm.message_bwd_plain(both, es, ev, weights, dout, spec)
    exact = exact_sums(lambda: cgm.message_bwd_plain(both, es, ev, weights, dout, spec))
    names = ["d both", "d es", "d ev"] + [f"layer {k} {n}" for k in range(len(weights) // 6)
                                         for n in ("wh", "ws", "bs", "wv", "wsv", "bsv")]
    print_errors(f"K5 bwd flagship bf16 step B={b} E={e}", names,
                 list(exact[:3]) + list(exact[3]),
                 {k: list(v[:3]) + list(v[3]) for k, v in runs.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
