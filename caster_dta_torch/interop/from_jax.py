"""Carry JointGNN weights between the JAX package's flax param tree and the
port, both ways.

``params`` is the flax param tree as nested dicts of numpy arrays (for
example what train/checkpoints.load_params reads from a ``.msgpack``
checkpoint, or ``jax.device_get(variables['params'])``). Flax Dense kernels
are ``[in, out]`` and torch weights ``[out, in]``; names map to the reference
state-dict names the port's modules use. ``state_dict_from_jax`` is the
inverse of ``caster_dta_tpu.interop.torch_import.import_joint_gnn``, and
``to_jax_params`` the inverse of ``state_dict_from_jax``: one walk over the
model's modules (``_Bridge``) serves both directions.
"""
from __future__ import annotations

import numpy as np
import torch

from caster_dta_torch.models.joint import JointGNN


def _same(a: np.ndarray) -> np.ndarray:
    return a


class _Bridge:
    """Maps each torch state-dict key to its leaf of the flax tree. With
    ``to_torch`` it reads the tree and fills ``sd``; otherwise it reads
    ``sd`` and builds the tree. Each method maps one module kind."""

    def __init__(self, to_torch: bool, sd: dict | None = None):
        self.to_torch = to_torch
        self.sd: dict[str, np.ndarray] = {} if sd is None else sd

    def sub(self, p: dict, name: str) -> dict:
        return p[name] if self.to_torch else p.setdefault(name, {})

    def has(self, key: str, p: dict, name: str) -> bool:
        return name in p if self.to_torch else key in self.sd

    def leaf(self, key: str, p: dict, name: str, to_torch=_same, to_jax=_same) -> None:
        # np.array copies: the results own writable f32 memory
        if self.to_torch:
            self.sd[key] = np.array(to_torch(np.asarray(p[name])), dtype=np.float32)
        else:
            p[name] = np.array(to_jax(self.sd[key]), dtype=np.float32)

    def linear(self, prefix: str, p: dict) -> None:
        self.leaf(f"{prefix}.weight", p, "kernel", np.transpose, np.transpose)
        if self.has(f"{prefix}.bias", p, "bias"):
            self.leaf(f"{prefix}.bias", p, "bias")

    def layernorm(self, prefix: str, p: dict) -> None:
        self.leaf(f"{prefix}.weight", p, "scale")
        self.leaf(f"{prefix}.bias", p, "bias")

    def gvp(self, prefix: str, p: dict) -> None:
        for name in ("wh", "ws", "wv", "wsv"):
            if self.has(f"{prefix}.{name}.weight", p, name):
                self.linear(f"{prefix}.{name}", self.sub(p, name))

    def gvp_layernorm(self, prefix: str, p: dict) -> None:
        self.layernorm(f"{prefix}.scalar_norm", self.sub(p, "scalar_norm"))

    def gvp_conv_layer(self, prefix: str, p: dict, layer=None) -> None:
        """``layer`` gives the message and feedforward depths; without it
        they are counted in the tree (reading it only)."""
        conv = self.sub(p, "conv")
        n_message = len(layer.conv.message_func) if layer is not None else len(conv)
        n_ff = (len(layer.ff_func) if layer is not None
                else sum(k.startswith("ff_") for k in p))
        for j in range(n_message):
            self.gvp(f"{prefix}.conv.message_func.{j}", self.sub(conv, f"message_{j}"))
        self.gvp_layernorm(f"{prefix}.norm.0", self.sub(p, "norm0"))
        self.gvp_layernorm(f"{prefix}.norm.1", self.sub(p, "norm1"))
        for j in range(n_ff):
            self.gvp(f"{prefix}.ff_func.{j}", self.sub(p, f"ff_{j}"))

    def gine_conv(self, prefix: str, p: dict) -> None:
        def one(a):
            return a.reshape(1)
        self.leaf(f"{prefix}.eps", p, "eps", one, one)
        self.linear(f"{prefix}.lin", self.sub(p, "edge_lin"))
        mlp = self.sub(p, "mlp")
        self.linear(f"{prefix}.nn.lins.0", self.sub(mlp, "lin0"))
        self.linear(f"{prefix}.nn.lins.1", self.sub(mlp, "lin1"))

    def type_embedding(self, prefix: str, tower: dict, name: str) -> None:
        key = f"{prefix}.{name}.weight"
        if self.has(key, tower, name):
            self.leaf(key, self.sub(self.sub(tower, name), "embedding"), "embedding")

    def mha(self, prefix: str, p: dict, packed: bool) -> None:
        subs = [self.sub(p, n) for n in ("q_proj", "k_proj", "v_proj")]
        w_keys = ([f"{prefix}.in_proj_weight"] if packed else
                  [f"{prefix}.{n}_proj_weight" for n in "qkv"])
        b_key = f"{prefix}.in_proj_bias"
        if self.to_torch:
            ws = [np.asarray(s["kernel"]).T for s in subs]
            for key, w in zip(w_keys, [np.concatenate(ws, axis=0)] if packed else ws):
                self.sd[key] = np.array(w, dtype=np.float32)
            self.sd[b_key] = np.concatenate([s["bias"] for s in subs]).astype(np.float32)
        else:
            ws = np.split(self.sd[w_keys[0]], 3) if packed else [self.sd[k] for k in w_keys]
            for s, w, b in zip(subs, ws, np.split(self.sd[b_key], 3)):
                s["kernel"] = np.array(w.T, dtype=np.float32)
                s["bias"] = np.array(b, dtype=np.float32)
        self.linear(f"{prefix}.out_proj", self.sub(p, "out_proj"))

    def joint(self, params: dict, model: JointGNN) -> None:
        pg, prot = "protein_gnn.gnn_model", self.sub(params, "protein_gnn")
        tower = model.protein_gnn.gnn_model
        self.gvp(f"{pg}.gvp_node.0", self.sub(prot, "gvp_node_gvp"))
        self.gvp_layernorm(f"{pg}.gvp_node.1", self.sub(prot, "gvp_node_norm"))
        self.gvp(f"{pg}.gvp_edge.0", self.sub(prot, "gvp_edge_gvp"))
        self.gvp_layernorm(f"{pg}.gvp_edge.1", self.sub(prot, "gvp_edge_norm"))
        for i, layer in enumerate(tower.conv_list):
            self.gvp_conv_layer(f"{pg}.conv_list.{i}", self.sub(prot, f"conv_{i}"), layer)
        self.gvp_layernorm(f"{pg}.gvp_norm_before_scalar",
                           self.sub(prot, "gvp_norm_before_scalar"))
        self.gvp(f"{pg}.gvp_to_scalar", self.sub(prot, "gvp_to_scalar"))
        self.type_embedding(pg, prot, "ntype_embedding")
        self.type_embedding(pg, prot, "etype_embedding")

        mg, mol = "molecule_gnn.gnn_model", self.sub(params, "molecule_gnn")
        for i in range(len(model.molecule_gnn.gnn_model.conv_list)):
            self.gine_conv(f"{mg}.conv_list.{i}", self.sub(mol, f"conv_{i}"))
        self.type_embedding(mg, mol, "ntype_embedding")
        self.type_embedding(mg, mol, "etype_embedding")

        for name in ("residue", "atom", "protein", "molecule"):
            for i in range(len(getattr(model, f"{name}_lins"))):
                self.linear(f"{name}_lins.{i}", self.sub(params, f"{name}_lin{i}"))
        for i, layer in enumerate(model.cross_attn_module.cross_attn_layers):
            ca, p = f"cross_attn_module.cross_attn_layers.{i}", self.sub(params, f"cross_attn_{i}")
            self.layernorm(f"{ca}.preattn_norm1", self.sub(p, "preattn_norm1"))
            self.layernorm(f"{ca}.preattn_norm2", self.sub(p, "preattn_norm2"))
            self.mha(f"{ca}.embed1_to_2", self.sub(p, "embed1_to_2"), layer.embed1_to_2.packed)
            self.mha(f"{ca}.embed2_to_1", self.sub(p, "embed2_to_1"), layer.embed2_to_1.packed)
            if layer.include_residual_stream:
                self.layernorm(f"{ca}.ff_norm1", self.sub(p, "ff_norm1"))
                self.layernorm(f"{ca}.ff_norm2", self.sub(p, "ff_norm2"))
                self.linear(f"{ca}.ff1.0", self.sub(p, "ff1_lin0"))
                self.linear(f"{ca}.ff1.3", self.sub(p, "ff1_lin1"))
                self.linear(f"{ca}.ff2.0", self.sub(p, "ff2_lin0"))
                self.linear(f"{ca}.ff2.3", self.sub(p, "ff2_lin1"))
        if model.include_post_pool_layernorm:
            self.layernorm("protein_post_pool_norm", self.sub(params, "protein_post_pool_norm"))
            self.layernorm("molecule_post_pool_norm", self.sub(params, "molecule_post_pool_norm"))
        self.linear("pm_embed_lin", self.sub(params, "pm_embed_lin"))
        for i in range(len(model.out_fc_layers)):
            self.linear(f"out_fc_layers.{i}", self.sub(params, f"out_fc_lin{i}"))
            if self.has(f"out_fc_norms.{i}.weight", params, f"out_fc_norm{i}"):
                self.layernorm(f"out_fc_norms.{i}", self.sub(params, f"out_fc_norm{i}"))
        self.linear("output_layer", self.sub(params, "output_layer"))


class StateDictWriter(_Bridge):
    """Collects torch state-dict entries from pieces of a flax param tree."""

    def __init__(self):
        super().__init__(to_torch=True)

    def put(self, key: str, value) -> None:
        self.sd[key] = np.array(value, dtype=np.float32)  # a writable copy

    def tensors(self, strip: str = "") -> dict[str, torch.Tensor]:
        """The collected entries as tensors, with ``strip`` cut from the front
        of every key."""
        return {k[len(strip):]: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in self.sd.items()}


def state_dict_from_jax(params: dict, model: JointGNN) -> dict[str, torch.Tensor]:
    """Map a JAX JointGNN param tree onto the port's state-dict names."""
    writer = StateDictWriter()
    writer.joint(params.get("params", params), model)
    return writer.tensors()


def load_jax_params(model: JointGNN, params: dict) -> JointGNN:
    """Load a JAX param tree into ``model`` in place (strict: every tensor of
    the model must be given, and nothing else)."""
    model.load_state_dict(state_dict_from_jax(params, model), strict=True)
    return model


def to_jax_params(model: JointGNN) -> dict:
    """The model's weights as the JAX package's JointGNN param tree: nested
    dicts of f32 numpy arrays, the tree ``checkpoints.save_params`` writes
    and ``caster_dta_tpu`` reads. Every tensor of the state dict is used."""
    return tree_from_tensors(model, model.state_dict())


def tree_from_tensors(model: JointGNN, tensors: dict) -> dict:
    """Tensors named and shaped as ``model``'s state dict (its weights, or
    per-parameter optimizer moments) as the JAX param tree's leaves, in that
    tree's layout. Every tensor is used."""
    sd = {k: v.detach().to("cpu", torch.float32).numpy() for k, v in tensors.items()}
    read: set = set()
    params: dict = {}
    _Bridge(to_torch=False, sd=_TrackingDict(sd, read)).joint(params, model)
    unused = set(sd) - read
    if unused:
        raise ValueError(f"state-dict entries with no place in the JAX tree: {sorted(unused)}")
    return params


class _TrackingDict(dict):
    """A dict that records which keys were read."""

    def __init__(self, data: dict, read: set):
        super().__init__(data)
        self.read = read

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)
