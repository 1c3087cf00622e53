"""Operations of a step or a served batch, counted once from the plain
reference at a bucket's padded shapes (torch.utils.flop_counter, matrix
products only), on the meta device: shapes in, counts out, no data. Never
counted from the program's code."""
from __future__ import annotations

import os

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchlib.spec import BENCH_DIR, load_module


def _plain():
    return load_module(os.path.join(BENCH_DIR, "reference", "plain.py"), "bench_reference_plain")


def _graph(b, n, e, kw_in, kw_edge, device="meta") -> dict:
    (s, v), (es, ev) = ((kw_in, 0) if isinstance(kw_in, int) else tuple(kw_in),
                        (kw_edge, 0) if isinstance(kw_edge, int) else tuple(kw_edge))
    f = dict(device=device)
    return {"node_s": torch.zeros(b, n, s, **f), "node_v": torch.zeros(b, n, v, 3, **f),
            "node_type": torch.zeros(b, n, dtype=torch.int32, **f),
            "node_mask": torch.ones(b, n, dtype=torch.bool, **f),
            "edge_src": torch.zeros(b, e, dtype=torch.int32, **f),
            "edge_dst": torch.zeros(b, e, dtype=torch.int32, **f),
            "edge_s": torch.zeros(b, e, es, **f), "edge_v": torch.zeros(b, e, ev, 3, **f),
            "edge_type": torch.zeros(b, e, dtype=torch.int32, **f),
            "edge_mask": torch.ones(b, e, dtype=torch.bool, **f)}


def meta_batch(kwargs: dict, bucket: tuple, b: int) -> tuple:
    n_p, e_p, n_m, e_m = bucket
    pk, mk = kwargs["protein_gnn_kwargs"], kwargs["molecule_gnn_kwargs"]
    return (_graph(b, n_p, e_p, pk["in_channels"], pk["edge_dim"]),
            _graph(b, n_m, e_m, mk["in_channels"], mk["edge_dim"]))


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def train_step(kwargs: dict, bucket: tuple, b: int) -> int:
    """Forward, masked loss and the gradients of every parameter."""
    plain = _plain()
    params = {k: torch.zeros(s, device="meta", requires_grad=True)
              for k, s in plain.param_shapes(kwargs).items()}
    protein, molecule = meta_batch(kwargs, bucket, b)

    def step():
        pred = plain.forward(plain.Run(params), kwargs, protein, molecule)[0]
        loss = plain.masked_loss(pred, torch.zeros(b, device="meta"),
                                 torch.ones(b, device="meta"))
        torch.autograd.grad(loss, list(params.values()), allow_unused=True)

    return _count(step)


def forward(kwargs: dict, bucket: tuple, b: int) -> int:
    plain = _plain()
    params = {k: torch.zeros(s, device="meta") for k, s in plain.param_shapes(kwargs).items()}
    protein, molecule = meta_batch(kwargs, bucket, b)
    with torch.no_grad():
        return _count(lambda: plain.forward(plain.Run(params), kwargs, protein, molecule))


def explain(kwargs: dict, bucket: tuple, b: int, n_epochs: int) -> int:
    """The explainer's steps on both towers (its forward of the unmasked
    batch once)."""
    plain = _plain()
    params = {k: torch.zeros(s, device="meta") for k, s in plain.param_shapes(kwargs).items()}
    protein, molecule = meta_batch(kwargs, bucket, b)
    init = {(side, kind): torch.zeros(g[f"{kind}_mask"].shape, device="meta")
            for side, g in (("protein", protein), ("molecule", molecule))
            for kind in ("node", "edge")}
    return _count(lambda: plain.explain(kwargs, params, protein, molecule, init,
                                        plain.Precision(), n_epochs=n_epochs))
