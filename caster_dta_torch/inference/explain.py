"""Node- and edge-mask explanations (counterpart of caster_dta_tpu/inference/
explain.py ``DTAModelExplainer``).

Per batch and tower, sigmoid node-mask logits multiply the tower's node
features (and, on the protein, its node vectors) and sigmoid edge-mask logits
its edge features; Adam with optax's defaults moves the logits for
``n_epochs`` steps to pull the masked prediction toward the unmasked one, with
the size and entropy terms of ``_mask_reg`` averaged over the real nodes and
edges. The initial logits are 0.1 x ``jax.random.normal`` under
``split(PRNGKey(0))``, drawn by the port's own threefry (inference/
jax_random.py), so the same inputs give the JAX package's masks.

The model runs in eval mode under ``f32_precision``; only the logits get
gradients. On the card each bucket, tower and model path captures the whole
loop, forward, backward and Adam for every step, as one CUDA graph (the
counterpart of JAX's jitted ``lax.scan``), kept with the model for every
explainer of it: its first batch runs eagerly on the capture stream and gives
the answer, every later batch replays. ``eager=True``
runs the loop eagerly on the card, as on the CPU. Each tower's loop is a
span ``inference.explain`` whose value is the replayed graph's device
operations (-1 where the loop ran eagerly).

The blockwise attention path (``use_pallas``) has no gradient, in JAX as here
(K4 is forward only): the explainer refuses such a model before any work.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Literal

import numpy as np
import torch

from caster_dta_torch.data.graphs import GraphBatch
from caster_dta_torch.inference import jax_random
from caster_dta_torch.inference.replay import BatchLayout, model_path
from caster_dta_torch.nn.common import f32_precision
from caster_dta_torch.train.graphs import GraphCache
from caster_dta_torch.utils.profiling import annotate

# optax.adam's defaults
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _mask_reg(m, valid, coeff_size: float, coeff_ent: float):
    n = torch.clamp(valid.sum(), min=1)
    size = torch.where(valid, m, 0.0).sum() / n
    ent = -m * torch.log(m + 1e-10) - (1 - m) * torch.log(1 - m + 1e-10)
    ent = torch.where(valid, ent, 0.0).sum() / n
    return coeff_size * size + coeff_ent * ent


@contextlib.contextmanager
def _eval_mode(model: torch.nn.Module):
    was = model.training
    model.eval()
    try:
        yield
    finally:
        model.train(was)


_GRAPHS: "weakref.WeakKeyDictionary[torch.nn.Module, GraphCache]" = weakref.WeakKeyDictionary()


def _graph_cache(model: torch.nn.Module) -> GraphCache:
    """The captured loops of ``model``'s explainers, shared by every
    explainer of the model (the key holds the explainer's settings) and kept
    while the model lives."""
    if model not in _GRAPHS:
        _GRAPHS[model] = GraphCache(next(model.parameters()).device)
    return _GRAPHS[model]


class DTAModelExplainer:
    """explain_model(protein, molecule) -> dict of masks: 'protein' and
    'molecule' per node [B, N], 'protein_edges' and 'molecule_edges' per edge
    [B, E], each in [0, 1]. The model carries its weights, so no
    ``variables`` argument; the graphs lie on the model's device."""

    def __init__(self, model: torch.nn.Module, n_epochs: int = 10, lr: float = 0.01,
                 coeff_size: float = 0.005, coeff_ent: float = 0.1,
                 coeff_edge_size: float = 0.005, coeff_edge_ent: float = 1.0):
        self.model = model
        self.n_epochs = n_epochs
        self.lr = lr
        self.coeff_size = coeff_size
        self.coeff_ent = coeff_ent
        self.coeff_edge_size = coeff_edge_size
        self.coeff_edge_ent = coeff_edge_ent
        self.device = next(model.parameters()).device
        self._graphs = _graph_cache(model) if self.device.type == "cuda" else None
        self._init: dict = {}       # (shape, key index) -> initial logits
        self.replays = 0

    # ------------------------------------------------------------ the loop
    def _initial_logits(self, shape: tuple, which: int) -> torch.Tensor:
        """0.1 x jax.random.normal of key ``which`` of split(PRNGKey(0))."""
        key = (shape, which)
        if key not in self._init:
            k = jax_random.split(jax_random.prng_key(0))[which]
            draw = np.float32(0.1) * jax_random.normal(k, shape)
            self._init[key] = torch.from_numpy(draw).to(self.device)
        return self._init[key]

    def _masked_pred(self, protein: GraphBatch, molecule: GraphBatch, node_logits,
                     edge_logits, side: str):
        m = torch.sigmoid(node_logits)[..., None]
        em = torch.sigmoid(edge_logits)[..., None]
        if side == "protein":
            protein = dataclasses.replace(
                protein, node_s=protein.node_s * m, node_v=protein.node_v * m[..., None],
                edge_s=protein.edge_s * em, edge_v=protein.edge_v * em[..., None])
        else:
            molecule = dataclasses.replace(molecule, node_s=molecule.node_s * m,
                                           edge_s=molecule.edge_s * em)
        pred, _ = self.model(protein, molecule, return_attention=False)
        return pred[:, 0]

    def _explain(self, protein: GraphBatch, molecule: GraphBatch, side: str) -> tuple:
        """The n_epochs Adam steps on one tower's mask logits -> (node mask
        [B, N], edge mask [B, E]). The same calls run eagerly and under
        capture."""
        graph = protein if side == "protein" else molecule
        with torch.no_grad(), f32_precision():
            full_pred = self.model(protein, molecule, return_attention=False)[0][:, 0]
        logits = [self._initial_logits(tuple(graph.node_mask.shape), 0).clone(),
                  self._initial_logits(tuple(graph.edge_mask.shape), 1).clone()]
        mu = [torch.zeros_like(t) for t in logits]
        nu = [torch.zeros_like(t) for t in logits]
        for step in range(1, self.n_epochs + 1):
            x = [t.detach().requires_grad_(True) for t in logits]
            with torch.enable_grad(), f32_precision():
                pred = self._masked_pred(protein, molecule, x[0], x[1], side)
                loss = (torch.mean((pred - full_pred) ** 2)
                        + _mask_reg(torch.sigmoid(x[0]), graph.node_mask, self.coeff_size,
                                    self.coeff_ent)
                        + _mask_reg(torch.sigmoid(x[1]), graph.edge_mask,
                                    self.coeff_edge_size, self.coeff_edge_ent))
                grads = torch.autograd.grad(loss, x)
            bc1 = float(np.float32(1) - np.float32(_B1) ** np.float32(step))
            bc2 = float(np.float32(1) - np.float32(_B2) ** np.float32(step))
            with torch.no_grad():
                for i, g in enumerate(grads):
                    mu[i] = (1 - _B1) * g + _B1 * mu[i]
                    nu[i] = (1 - _B2) * (g * g) + _B2 * nu[i]
                    update = (mu[i] / bc1) / (torch.sqrt(nu[i] / bc2) + _EPS)
                    logits[i] = logits[i] + (-self.lr) * update
        return torch.sigmoid(logits[0]), torch.sigmoid(logits[1])

    # ------------------------------------------------------------- replays
    def _replayed(self, protein: GraphBatch, molecule: GraphBatch, side: str) -> tuple:
        """-> (the masks, as ``_explain`` gives them; the replayed graph's
        device operations, -1 for the bucket's first batch, run eagerly)."""
        layout = BatchLayout(protein, molecule)
        key = (side, layout.key, model_path(self.model), self.n_epochs, self.lr,
               self.coeff_size, self.coeff_ent, self.coeff_edge_size, self.coeff_edge_ent)
        step = self._graphs.get(key)
        if step is None:
            with annotate("graph.warmup"), self._graphs.side_stream():
                out = self._explain(protein, molecule, side)
            graph = protein if side == "protein" else molecule
            keep = [self._initial_logits(tuple(m.shape), i)
                    for i, m in enumerate((graph.node_mask, graph.edge_mask))]
            self._graphs.capture(key, keep, layout.width,
                                 {True: lambda r: self._explain(*layout.views(r), side)})
            return out, -1
        layout.pack(step.row, protein, molecule)
        self.replays += 1
        return tuple(t.clone() for t in step.replay()), step.nodes[True]

    def explain_model(self, protein: GraphBatch, molecule: GraphBatch,
                      side: Literal["protein", "molecule", "both"] = "both",
                      eager: bool = False) -> dict:
        if any(getattr(m, "use_pallas", False) for m in self.model.modules()):
            raise NotImplementedError(
                "the explainer differentiates the model, and the blockwise attention path "
                "(use_pallas, K4) is forward only, as in the JAX package, whose gradient "
                "through masked_mha fails; serve the model dense to explain it")
        if side not in ("protein", "molecule", "both"):
            raise ValueError(f"side must be 'protein', 'molecule' or 'both', not {side!r}")
        replayed = self._graphs is not None and not eager
        out = {}
        with _eval_mode(self.model):
            for name in ("protein", "molecule"):
                if side in (name, "both"):
                    with annotate("inference.explain") as span:
                        if replayed:
                            masks, span.value = self._replayed(protein, molecule, name)
                        else:
                            masks = self._explain(protein, molecule, name)
                    out[name], out[f"{name}_edges"] = masks
        return out
