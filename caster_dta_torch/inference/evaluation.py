"""Batched model evaluation over a dataset (counterpart of caster_dta_tpu/
inference/evaluation.py ``run_model_on_dataset``).

Unscaled predictions, each pair's cross-attention maps of the first layer
trimmed to its real lengths (both directions), their mean and max profiles,
and, with the explainer, node-mask explanations softmaxed per graph over the
real nodes and edge masks trimmed to the real edges. The port has no pandas:
the result is records, a dict of equal-length column lists (as data/
datasets.py keeps a dataset), sorted by ``pair_idx``. The model carries its
weights, so there is no ``variables`` argument.

On the card the forward is a CUDA-graph replay per bucket fed from a pinned
buffer (inference/replay.py) and the explainer's loop a replay per bucket
and tower (inference/explain.py); ``eager=True`` runs both eagerly, as on the
CPU. On the blockwise attention path (``use_pallas``) the model returns no
attention maps: the six attention columns hold None there (the JAX package's
function fails on that path), and the explainer refuses it.

A batch's spans (utils/profiling.py), in turn: ``inference.forward``
(replay.py's, or the eager forward here), ``inference.explain`` (one a
tower, explain.py), ``inference.fetch`` (every output to the host: the
first copy waits for the card) and ``inference.records`` (unscaling and the
records; its value is the batch's real pairs).
"""
from __future__ import annotations

import numpy as np
import torch

from caster_dta_torch.data.batching import BucketedLoader
from caster_dta_torch.inference import replay
from caster_dta_torch.inference.explain import DTAModelExplainer
from caster_dta_torch.utils.profiling import annotate

COLUMNS = ("protein_id", "molecule_id", "affinity_score", "protein_attention",
           "molecule_attention", "max_protein_attention", "max_molecule_attention",
           "prot_mol_attention", "mol_prot_attention", "protein_explanation",
           "molecule_explanation", "protein_edge_explanation", "molecule_edge_explanation",
           "protein_len", "molecule_len", "pair_idx")


def _softmax(x):
    e = np.exp(x - x.max())
    return e / e.sum()


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def run_model_on_dataset(model: torch.nn.Module, dataset, max_batch_size: int = 8,
                         max_num: int = 4_000_000, do_explainer: bool = True,
                         explainer_epochs: int = 10, eager: bool = False) -> dict:
    """-> records: each column of COLUMNS plus ``max_protein_explanation``
    and ``max_molecule_explanation`` (copies of the plain explanation
    columns, as the JAX package's), one entry a real pair, sorted by
    ``pair_idx``. ``dataset`` is a PairDataset (``pair_indices``,
    ``unscale_target``); the model runs on its own device."""
    loader = BucketedLoader(dataset, max_num=max_num, max_batch_size=max_batch_size,
                            shuffle=False)
    return evaluate_batches(model, dataset, loader, do_explainer, explainer_epochs, eager)


def evaluate_batches(model: torch.nn.Module, dataset, batches, do_explainer: bool = True,
                     explainer_epochs: int = 10, eager: bool = False) -> dict:
    """``run_model_on_dataset`` over the given batches of ``dataset`` (a
    BucketedLoader's, or some of them) -> records sorted by ``pair_idx``."""
    device = next(model.parameters()).device
    explainer = DTAModelExplainer(model, n_epochs=explainer_epochs) if do_explainer else None
    replayed = device.type == "cuda" and not eager
    rows = {k: [] for k in COLUMNS}
    was = model.training
    model.eval()
    try:
        for batch in batches:
            if replayed:
                (score, w_rd, w_dr), (protein, molecule) = replay.replayed_forward(model)(
                    batch.protein, batch.molecule)
            else:
                with annotate("inference.forward"):
                    protein, molecule = batch.protein.to(device), batch.molecule.to(device)
                    score, w_rd, w_dr = replay.forward(model, protein, molecule)
            exp = None
            if explainer is not None:
                exp = explainer.explain_model(protein, molecule, eager=eager)
            with annotate("inference.fetch"):
                score, w_rd, w_dr = _np(score), _np(w_rd), _np(w_dr)
                if exp is not None:
                    exp = {k: _np(v) for k, v in exp.items()}
            with annotate("inference.records", int((batch.weight > 0).sum())):
                _add_rows(rows, dataset, batch, dataset.unscale_target(score), w_rd, w_dr, exp)
    finally:
        model.train(was)
    order = np.argsort(np.asarray(rows["pair_idx"]), kind="stable")
    out = {k: [v[i] for i in order] for k, v in rows.items()}
    out["max_protein_explanation"] = list(out["protein_explanation"])
    out["max_molecule_explanation"] = list(out["molecule_explanation"])
    return out


def _add_rows(rows: dict, dataset, batch, pred, w_rd, w_dr, exp) -> None:
    """One batch's real pairs. w_rd: residues->atoms [B, R, A]; w_dr:
    atoms->residues [B, A, R] (JAX's evaluation.py:40-43)."""
    p_lens = batch.protein.n_node.numpy()
    m_lens = batch.molecule.n_node.numpy()
    p_elens = batch.protein.n_edge.numpy()
    m_elens = batch.molecule.n_edge.numpy()
    weight = batch.weight.numpy()
    pair_idx = batch.pair_idx.numpy()
    for k in range(len(pred)):
        if weight[k] == 0:
            continue
        i = int(pair_idx[k])
        pid, mid = dataset.pair_indices[i]
        plen, mlen = int(p_lens[k]), int(m_lens[k])
        rows["protein_id"].append(pid)
        rows["molecule_id"].append(mid)
        rows["affinity_score"].append(float(pred[k]))
        if w_rd is None:
            for name in ("protein_attention", "molecule_attention", "max_protein_attention",
                         "max_molecule_attention", "prot_mol_attention", "mol_prot_attention"):
                rows[name].append(None)
        else:
            pd_attn = w_dr[k][:mlen, :plen]     # [A, R]
            dp_attn = w_rd[k][:plen, :mlen]     # [R, A]
            rows["protein_attention"].append(pd_attn.mean(axis=0))
            rows["molecule_attention"].append(dp_attn.mean(axis=0))
            rows["max_protein_attention"].append(pd_attn.max(axis=0))
            rows["max_molecule_attention"].append(dp_attn.max(axis=0))
            rows["prot_mol_attention"].append(pd_attn)
            rows["mol_prot_attention"].append(dp_attn)
        if exp is not None:
            rows["protein_explanation"].append(_softmax(exp["protein"][k][:plen]))
            rows["molecule_explanation"].append(_softmax(exp["molecule"][k][:mlen]))
            rows["protein_edge_explanation"].append(exp["protein_edges"][k][:int(p_elens[k])])
            rows["molecule_edge_explanation"].append(exp["molecule_edges"][k][:int(m_elens[k])])
        else:
            for name in ("protein_explanation", "molecule_explanation",
                         "protein_edge_explanation", "molecule_edge_explanation"):
                rows[name].append(None)
        rows["protein_len"].append(plen)
        rows["molecule_len"].append(mlen)
        rows["pair_idx"].append(i)
