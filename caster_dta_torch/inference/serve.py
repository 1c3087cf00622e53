"""Serve a trained run: load its weights and answer affinity requests.

Counterpart of ``load_model_from_checkpoint`` (caster_dta_tpu/inference/
checkpoint.py) and of the forward and unscaling in ``run_model_on_dataset``
(caster_dta_tpu/inference/evaluation.py). A run directory holds
``model_kwargs.json``, ``dataset_rescale_params.json`` and the flax
``.msgpack`` checkpoints; all three are read here with ``json`` and the
port's own msgpack reader.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

import torch

from caster_dta_torch.data.batching import PairBatch
from caster_dta_torch.device import resolve_device
from caster_dta_torch.interop.from_jax import load_jax_params
from caster_dta_torch.models.joint import JointGNN, make_joint_gnn
from caster_dta_torch.nn.common import f32_precision
from caster_dta_torch.train import checkpoints


@dataclass
class LoadedRun:
    model: JointGNN
    model_kwargs: dict
    rescale: dict           # dataset_rescale_params.json
    param_file: str
    device: torch.device


def load_run(run_dir: str, device: str | torch.device = "cuda") -> LoadedRun:
    """Build the model of ``run_dir`` on ``device`` with its best-val
    checkpoint, in eval mode."""
    device = resolve_device(device)
    with open(os.path.join(run_dir, "model_kwargs.json")) as f:
        model_kwargs = json.load(f)
    with open(os.path.join(run_dir, "dataset_rescale_params.json")) as f:
        rescale = json.load(f)
    param_file = checkpoints.get_best_model(run_dir, "val")
    # the random init is overwritten by the checkpoint; a local generator
    # leaves the process's global RNG alone
    model = make_joint_gnn(model_kwargs["protein_gnn_kwargs"],
                           model_kwargs["molecule_gnn_kwargs"],
                           generator=torch.Generator().manual_seed(0),
                           **model_kwargs["joint_gnn_kwargs"])
    load_jax_params(model, checkpoints.load_params(param_file))
    return LoadedRun(model.to(device).eval(), model_kwargs, rescale, param_file, device)


def unscale_target(values: torch.Tensor, rescale: dict) -> torch.Tensor:
    """Undo the dataset's target scaling, last scaling first."""
    for scale_type in rescale["scale_output"][::-1]:
        d = rescale.get(scale_type, {})
        if scale_type == "standardize":
            values = values * d["scale_std_factor"] + d["scale_mean_factor"]
        elif scale_type == "minmax":
            values = (values + 1) * 0.5
            values = values * (d["scale_max_factor"] - d["scale_min_factor"]) + d["scale_min_factor"]
        elif scale_type == "log":
            values = torch.expm1(values)
    return values


@torch.no_grad()
def predict(run: LoadedRun, batch: PairBatch):
    """-> (affinities [B] unscaled, (residues->atoms [B, R, A],
    atoms->residues [B, A, R]) attention of the first cross-attention
    layer). With ``use_pallas`` set on the model's MultiheadAttention modules
    (the blockwise K4 path), the attention comes back as (None, None). The
    outputs stay on the run's device; nothing synchronises.
    Serving is f32 end to end: the forward runs under ``f32_precision``, so
    the card's scores stay comparable with the CPU's and the JAX package's,
    and the process's TF32 settings are as they were afterwards."""
    batch = batch.to(run.device)
    with f32_precision():
        score, attn = run.model(batch.protein, batch.molecule)
    return unscale_target(score[:, 0], run.rescale), attn[0]
