"""Checkpoint reload: rebuild the model and the dataset from a run's artifacts
(counterpart of caster_dta_tpu/inference/checkpoint.py).

Behavioral spec: reference inference/inference_utils.py:40-90. Reads the same
JSON artifacts and the flax ``.msgpack`` checkpoints that either package
writes, with the port's own msgpack reader. The reference's torch ``.pt``
checkpoints are not read yet.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle

import torch

from caster_dta_torch.data.pairs import ProteinMoleculeDataset
from caster_dta_torch.device import resolve_device
from caster_dta_torch.interop.from_jax import load_jax_params
from caster_dta_torch.models.joint import JointGNN, make_joint_gnn
from caster_dta_torch.train import checkpoints


def load_model_from_checkpoint(check_path: str, best_model_type: str = "val",
                               param_file: str | None = None,
                               device: str | torch.device = "cuda"):
    """-> (model in eval mode on ``device``, JAX param tree, model_kwargs).

    ``param_file`` pins an exact checkpoint file (the reference torch.loads
    whatever path it is given, inference_utils.py:40-70); when None the best
    ``best_model_type`` file in ``check_path`` is selected."""
    device = resolve_device(device)
    with open(os.path.join(check_path, "model_kwargs.json")) as f:
        model_kwargs = json.load(f)
    if param_file is None:
        try:
            param_file = checkpoints.get_best_model(check_path, best_model_type)
        except FileNotFoundError:
            pt = [n for n in sorted(os.listdir(check_path)) if n.endswith(".pt")]
            if not pt:
                raise
            param_file = os.path.join(check_path, pt[0])
    if param_file.endswith(".pt"):
        raise NotImplementedError(
            f"{param_file}: the reference's torch .pt checkpoints are not read yet: "
            "ROADMAP Queue 1 item 5 (what waits)")
    params = checkpoints.load_params(param_file)
    model = build_model(model_kwargs)
    load_jax_params(model, params)
    return model.to(device).eval(), params, model_kwargs


def build_model(model_kwargs: dict) -> JointGNN:
    """The JointGNN of a run's model_kwargs.json, at a seeded random init (a
    local generator leaves the process's global RNG alone)."""
    return make_joint_gnn(model_kwargs["protein_gnn_kwargs"],
                          model_kwargs["molecule_gnn_kwargs"],
                          generator=torch.Generator().manual_seed(0),
                          **model_kwargs["joint_gnn_kwargs"])


def content_hash(obj) -> str:
    """sha256 of a JSON-able object (records, dataset kwargs): the key of the
    dataset caches (the JAX package hashes its DataFrame instead)."""
    return hashlib.sha256(json.dumps(obj, sort_keys=True, default=str).encode()).hexdigest()


def create_dataset_with_checkpoint_params(records: dict, check_path: str,
                                          cache_dir: str | None = None,
                                          n_workers=None) -> ProteinMoleculeDataset:
    """Rebuild the dataset of ``records`` with the run's dataset_kwargs.json
    and adopt its dataset_rescale_params.json (inference_utils.py:73-90),
    with an optional pickle cache keyed by the records' hash."""
    dataset = None
    ds_file = None
    if cache_dir:
        ds_file = os.path.join(cache_dir, f"dataset_torch_{content_hash(records)}.pkl")
        if os.path.exists(ds_file):
            with open(ds_file, "rb") as f:
                dataset = pickle.load(f)
    if dataset is None:
        with open(os.path.join(check_path, "dataset_kwargs.json")) as f:
            dataset_kwargs = json.load(f)
        dataset_kwargs.setdefault("n_workers", n_workers)
        dataset = ProteinMoleculeDataset(records, **dataset_kwargs)
        if ds_file:
            os.makedirs(cache_dir, exist_ok=True)
            with open(ds_file, "wb") as f:
                pickle.dump(dataset, f)
    with open(os.path.join(check_path, "dataset_rescale_params.json")) as f:
        dataset._load_scale_data_from_dict(json.load(f))
    return dataset
