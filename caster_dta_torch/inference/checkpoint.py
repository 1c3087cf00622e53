"""Checkpoint reload: rebuild the model and the dataset from a run's artifacts
(counterpart of caster_dta_tpu/inference/checkpoint.py).

Behavioral spec: reference inference/inference_utils.py:40-90. Reads the same
JSON artifacts and the flax ``.msgpack`` checkpoints that either package
writes, with the port's own msgpack reader, and the reference's torch ``.pt``
state dicts, whose names the port's JointGNN has for the family the JAX
package's importer takes (an lbamodel protein tower with a gine molecule
tower, any depth).
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle

import torch

from caster_dta_torch.data.pairs import ProteinMoleculeDataset
from caster_dta_torch.device import resolve_device
from caster_dta_torch.interop.from_jax import load_jax_params, to_jax_params
from caster_dta_torch.models.joint import JointGNN, make_joint_gnn
from caster_dta_torch.train import checkpoints


def load_model_from_checkpoint(check_path: str, best_model_type: str = "val",
                               param_file: str | None = None,
                               device: str | torch.device = "cuda"):
    """-> (model in eval mode on ``device``, JAX param tree, model_kwargs);
    for a ``.pt`` file the tree holds the loaded weights in the JAX layout.

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
    model = build_model(model_kwargs)
    if param_file.endswith(".pt"):
        model.load_state_dict(load_reference_state_dict(param_file, model_kwargs), strict=True)
        params = to_jax_params(model)
    else:
        params = checkpoints.load_params(param_file)
        load_jax_params(model, params)
    return model.to(device).eval(), params, model_kwargs


def load_reference_state_dict(path: str, model_kwargs: dict) -> dict:
    """A reference ``.pt`` state dict (train_model.py:672-682), read on the
    CPU with ``weights_only``, without torch.compile's ``_orig_mod.``
    prefixes and the GVPs' ``dummy_param`` entries (inference_utils.py:52-66),
    for the pairs of towers the JAX package's ``import_joint_gnn`` takes."""
    pk, mk = model_kwargs["protein_gnn_kwargs"], model_kwargs["molecule_gnn_kwargs"]
    if pk["base_conv"] != "lbamodel" or mk["base_conv"] != "gine":
        raise NotImplementedError(
            "transplant currently supports base_conv lbamodel (protein) + gine "
            f"(molecule); got {pk['base_conv']}/{mk['base_conv']}")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k.replace("_orig_mod.", ""): v for k, v in sd.items()
            if not k.endswith("dummy_param")}


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
