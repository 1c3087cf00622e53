"""Carry the JAX package's JointGNN params into the port.

``params`` is the flax param tree as nested dicts of numpy arrays (for
example what train/checkpoints.load_params reads from a ``.msgpack``
checkpoint, or ``jax.device_get(variables['params'])``). Flax Dense kernels
are ``[in, out]`` and torch weights ``[out, in]``; names map to the reference
state-dict names the port's modules use. This is the inverse of
``caster_dta_tpu.interop.torch_import.import_joint_gnn``.
"""
from __future__ import annotations

import numpy as np
import torch

from caster_dta_torch.models.joint import JointGNN


class StateDictWriter:
    """Collects torch state-dict entries from pieces of a flax param tree;
    each method maps one module kind."""

    def __init__(self):
        self.sd: dict[str, np.ndarray] = {}

    def tensors(self, strip: str = "") -> dict[str, torch.Tensor]:
        """The collected entries as tensors, with ``strip`` cut from the front
        of every key."""
        return {k[len(strip):]: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in self.sd.items()}

    def put(self, key: str, value) -> None:
        self.sd[key] = np.array(value, dtype=np.float32)  # a writable copy

    def linear(self, prefix: str, p: dict) -> None:
        self.put(f"{prefix}.weight", np.asarray(p["kernel"]).T)
        if "bias" in p:
            self.put(f"{prefix}.bias", p["bias"])

    def layernorm(self, prefix: str, p: dict) -> None:
        self.put(f"{prefix}.weight", p["scale"])
        self.put(f"{prefix}.bias", p["bias"])

    def gvp(self, prefix: str, p: dict) -> None:
        for name in ("wh", "ws", "wv", "wsv"):
            if name in p:
                self.linear(f"{prefix}.{name}", p[name])

    def gvp_layernorm(self, prefix: str, p: dict) -> None:
        self.layernorm(f"{prefix}.scalar_norm", p["scalar_norm"])

    def gvp_conv_layer(self, prefix: str, p: dict) -> None:
        for j in range(len(p["conv"])):
            self.gvp(f"{prefix}.conv.message_func.{j}", p["conv"][f"message_{j}"])
        self.gvp_layernorm(f"{prefix}.norm.0", p["norm0"])
        self.gvp_layernorm(f"{prefix}.norm.1", p["norm1"])
        for j in range(sum(k.startswith("ff_") for k in p)):
            self.gvp(f"{prefix}.ff_func.{j}", p[f"ff_{j}"])

    def gine_conv(self, prefix: str, p: dict) -> None:
        self.put(f"{prefix}.eps", np.asarray(p["eps"]).reshape(1))
        self.linear(f"{prefix}.lin", p["edge_lin"])
        self.linear(f"{prefix}.nn.lins.0", p["mlp"]["lin0"])
        self.linear(f"{prefix}.nn.lins.1", p["mlp"]["lin1"])

    def type_embedding(self, prefix: str, tower: dict, name: str) -> None:
        if name in tower:
            self.put(f"{prefix}.{name}.weight", tower[name]["embedding"]["embedding"])

    def mha(self, prefix: str, p: dict, packed: bool) -> None:
        wq, wk, wv = (np.asarray(p[k]["kernel"]).T for k in ("q_proj", "k_proj", "v_proj"))
        if packed:
            self.put(f"{prefix}.in_proj_weight", np.concatenate([wq, wk, wv], axis=0))
        else:
            self.put(f"{prefix}.q_proj_weight", wq)
            self.put(f"{prefix}.k_proj_weight", wk)
            self.put(f"{prefix}.v_proj_weight", wv)
        self.put(f"{prefix}.in_proj_bias",
                 np.concatenate([p[k]["bias"] for k in ("q_proj", "k_proj", "v_proj")]))
        self.linear(f"{prefix}.out_proj", p["out_proj"])


def state_dict_from_jax(params: dict, model: JointGNN) -> dict[str, torch.Tensor]:
    """Map a JAX JointGNN param tree onto the port's state-dict names."""
    params = params.get("params", params)
    m = StateDictWriter()

    pg, prot = "protein_gnn.gnn_model", params["protein_gnn"]
    m.gvp(f"{pg}.gvp_node.0", prot["gvp_node_gvp"])
    m.gvp_layernorm(f"{pg}.gvp_node.1", prot["gvp_node_norm"])
    m.gvp(f"{pg}.gvp_edge.0", prot["gvp_edge_gvp"])
    m.gvp_layernorm(f"{pg}.gvp_edge.1", prot["gvp_edge_norm"])
    for i in range(len(model.protein_gnn.gnn_model.conv_list)):
        m.gvp_conv_layer(f"{pg}.conv_list.{i}", prot[f"conv_{i}"])
    m.gvp_layernorm(f"{pg}.gvp_norm_before_scalar", prot["gvp_norm_before_scalar"])
    m.gvp(f"{pg}.gvp_to_scalar", prot["gvp_to_scalar"])
    m.type_embedding(pg, prot, "ntype_embedding")
    m.type_embedding(pg, prot, "etype_embedding")

    mg, mol = "molecule_gnn.gnn_model", params["molecule_gnn"]
    for i in range(len(model.molecule_gnn.gnn_model.conv_list)):
        m.gine_conv(f"{mg}.conv_list.{i}", mol[f"conv_{i}"])
    m.type_embedding(mg, mol, "ntype_embedding")
    m.type_embedding(mg, mol, "etype_embedding")

    for name in ("residue", "atom", "protein", "molecule"):
        for i in range(len(getattr(model, f"{name}_lins"))):
            m.linear(f"{name}_lins.{i}", params[f"{name}_lin{i}"])
    for i, layer in enumerate(model.cross_attn_module.cross_attn_layers):
        ca, p = f"cross_attn_module.cross_attn_layers.{i}", params[f"cross_attn_{i}"]
        m.layernorm(f"{ca}.preattn_norm1", p["preattn_norm1"])
        m.layernorm(f"{ca}.preattn_norm2", p["preattn_norm2"])
        m.mha(f"{ca}.embed1_to_2", p["embed1_to_2"], layer.embed1_to_2.packed)
        m.mha(f"{ca}.embed2_to_1", p["embed2_to_1"], layer.embed2_to_1.packed)
        if layer.include_residual_stream:
            m.layernorm(f"{ca}.ff_norm1", p["ff_norm1"])
            m.layernorm(f"{ca}.ff_norm2", p["ff_norm2"])
            m.linear(f"{ca}.ff1.0", p["ff1_lin0"])
            m.linear(f"{ca}.ff1.3", p["ff1_lin1"])
            m.linear(f"{ca}.ff2.0", p["ff2_lin0"])
            m.linear(f"{ca}.ff2.3", p["ff2_lin1"])
    if model.include_post_pool_layernorm:
        m.layernorm("protein_post_pool_norm", params["protein_post_pool_norm"])
        m.layernorm("molecule_post_pool_norm", params["molecule_post_pool_norm"])
    m.linear("pm_embed_lin", params["pm_embed_lin"])
    for i in range(len(model.out_fc_layers)):
        m.linear(f"out_fc_layers.{i}", params[f"out_fc_lin{i}"])
        if f"out_fc_norm{i}" in params:
            m.layernorm(f"out_fc_norms.{i}", params[f"out_fc_norm{i}"])
    m.linear("output_layer", params["output_layer"])
    return m.tensors()


def load_jax_params(model: JointGNN, params: dict) -> JointGNN:
    """Load a JAX param tree into ``model`` in place (strict: every tensor of
    the model must be given, and nothing else)."""
    model.load_state_dict(state_dict_from_jax(params, model), strict=True)
    return model
