"""Carry JointGNN weights between the JAX package's flax param tree and the
port, both ways.

``params`` is the flax param tree as nested dicts of numpy arrays (for
example what train/checkpoints.load_params reads from a ``.msgpack``
checkpoint, or ``jax.device_get(variables['params'])``). Flax Dense kernels
are ``[in, out]`` and torch weights ``[out, in]``; names map to the reference
state-dict names the port's modules use. ``state_dict_from_jax`` is the
inverse of ``caster_dta_tpu.interop.torch_import.import_joint_gnn``, and
``to_jax_params`` the inverse of ``state_dict_from_jax``: one walk over the
model's modules (``_Bridge``) serves both directions. The walk dispatches on
each tower's class.

Names: the LBA tower, GINEConv, the cross-attention and the head take the
reference state dict's names; GATv2Conv, GINConv, GATConv and PNAConv take
PyG's (GATv2's ``lin_l``, ``lin_r``, ``lin_edge``, ``att`` as [1, H, C];
GAT's ``lin``, ``att_src``, ``att_dst`` as [1, H, C]; PNA's
``edge_encoder``, ``pre_nns.{t}.0``, ``post_nns.{t}.0``, ``lin``), whose
leaves map one for one onto the JAX module's; GRUCell takes torch's
(``weight_ih`` and ``bias_ih`` from the JAX Dense ``weight_ih``, the same
for ``hh``); GATEConv takes PyG's where PyG has the piece (``att_l`` and
``att_r`` as [1, C]) and JAX's ``lin_dst``; every other new module (the
PocketMiner and CPD towers' blocks, HEATConv, the GPS layers' pieces,
AttentiveFP's ``lin1`` and ``lin2``, MaskedBatchNorm's ``scale`` as
``weight``) takes the JAX names, a Dense's ``kernel`` becoming a transposed
``weight`` and an ``Embed``'s ``embedding`` an embedding ``weight``.
MaskedBatchNorm's running statistics (the ``pe_norm`` of GPS, the head's
batch norm) are in neither tree: JAX checkpoints hold ``params`` only, and
both packages serve a loaded model with the init's statistics (mean 0,
variance 1). A GIN or GINE conv with a fixed eps keeps a zero buffer in the
state dict, as PyG's does, and has no leaf in the JAX tree.
"""
from __future__ import annotations

import numpy as np
import torch

from caster_dta_torch.models import protein as protein_towers
from caster_dta_torch.models.joint import JointGNN
from caster_dta_torch.models import molecule as molecule_towers
from caster_dta_torch.models.scalar_gnns import GATv2GNN, HEATGNN


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

    def gin_eps(self, prefix: str, p: dict, conv) -> None:
        """A trained eps is a leaf; a fixed one is a zero buffer here and
        nothing there."""
        key = f"{prefix}.eps"
        if isinstance(conv.eps, torch.nn.Parameter):
            self.leaf(key, p, "eps", lambda a: a.reshape(1), lambda a: a.reshape(1))
        elif self.to_torch:
            self.sd[key] = np.zeros(1, np.float32)
        elif key in self.sd and np.any(self.sd[key]):   # optimizer moments have no buffer
            raise ValueError(f"{key}: a fixed eps is 0 in the JAX package")

    def gin_mlp(self, prefix: str, p: dict) -> None:
        self.linear(f"{prefix}.lins.0", self.sub(p, "lin0"))
        self.linear(f"{prefix}.lins.1", self.sub(p, "lin1"))

    def gine_conv(self, prefix: str, p: dict, conv) -> None:
        self.gin_eps(prefix, p, conv)
        self.linear(f"{prefix}.lin", self.sub(p, "edge_lin"))
        self.gin_mlp(f"{prefix}.nn", self.sub(p, "mlp"))

    def gin_conv(self, prefix: str, p: dict, conv) -> None:
        self.gin_eps(prefix, p, conv)
        self.gin_mlp(f"{prefix}.nn", self.sub(p, "mlp"))

    def gat_conv(self, prefix: str, p: dict) -> None:
        self.linear(f"{prefix}.lin", self.sub(p, "lin"))
        # flax's [1, 1, H, C] against PyG's [1, H, C]
        for name in ("att_src", "att_dst"):
            self.leaf(f"{prefix}.{name}", p, name, lambda a: a[0], lambda a: a[None])
        self.leaf(f"{prefix}.bias", p, "bias")

    def gate_conv(self, prefix: str, p: dict) -> None:
        for name in ("lin1", "lin_dst", "lin2"):
            self.linear(f"{prefix}.{name}", self.sub(p, name))
        # flax's [1, 1, C] against PyG's [1, C]
        for name in ("att_l", "att_r"):
            self.leaf(f"{prefix}.{name}", p, name, lambda a: a[0], lambda a: a[None])
        self.leaf(f"{prefix}.bias", p, "bias")

    def gru_cell(self, prefix: str, p: dict) -> None:
        for part in ("ih", "hh"):
            dense = self.sub(p, f"weight_{part}")
            self.leaf(f"{prefix}.weight_{part}", dense, "kernel", np.transpose, np.transpose)
            self.leaf(f"{prefix}.bias_{part}", dense, "bias")

    def pna_conv(self, prefix: str, p: dict, conv) -> None:
        self.linear(f"{prefix}.edge_encoder", self.sub(p, "edge_encoder"))
        for t in range(len(conv.pre_nns)):
            self.linear(f"{prefix}.pre_nns.{t}.0", self.sub(p, f"pre_nn_{t}"))
            self.linear(f"{prefix}.post_nns.{t}.0", self.sub(p, f"post_nn_{t}"))
        self.linear(f"{prefix}.lin", self.sub(p, "lin"))

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

    def gvp_block(self, prefix: str, tower: dict, gvp_name: str, norm_name: str,
                  norm_first: bool = False) -> None:
        """An nn.Sequential of a GVP and a GVPLayerNorm (``norm_first``: the
        LayerNorm at 0) onto the JAX leaves ``gvp_name`` and ``norm_name``."""
        g, n = (1, 0) if norm_first else (0, 1)
        self.gvp(f"{prefix}.{g}", self.sub(tower, gvp_name))
        self.gvp_layernorm(f"{prefix}.{n}", self.sub(tower, norm_name))

    def lba_tower(self, pg: str, prot: dict, tower) -> None:
        self.gvp_block(f"{pg}.gvp_node", prot, "gvp_node_gvp", "gvp_node_norm")
        self.gvp_block(f"{pg}.gvp_edge", prot, "gvp_edge_gvp", "gvp_edge_norm")
        for i, layer in enumerate(tower.conv_list):
            self.gvp_conv_layer(f"{pg}.conv_list.{i}", self.sub(prot, f"conv_{i}"), layer)
        self.gvp_layernorm(f"{pg}.gvp_norm_before_scalar",
                           self.sub(prot, "gvp_norm_before_scalar"))
        self.gvp(f"{pg}.gvp_to_scalar", self.sub(prot, "gvp_to_scalar"))
        self.type_embedding(pg, prot, "ntype_embedding")
        self.type_embedding(pg, prot, "etype_embedding")

    def pocketminer_tower(self, pg: str, prot: dict, tower) -> None:
        for side in ("node", "edge"):
            if getattr(tower, f"initial_{side}_proj") is not None:
                self.gvp_block(f"{pg}.initial_{side}_proj", prot, f"{side}_proj_gvp",
                               f"{side}_proj_norm")
            self.gvp_block(f"{pg}.gvp_{side}", prot, f"gvp_{side}_gvp", f"gvp_{side}_norm",
                           norm_first=True)
        for i, layer in enumerate(tower.conv_list):
            self.gvp_conv_layer(f"{pg}.conv_list.{i}", self.sub(prot, f"conv_{i}"), layer)
        self.gvp_layernorm(f"{pg}.gvp_norm_before_scalar",
                           self.sub(prot, "gvp_norm_before_scalar"))
        self.gvp(f"{pg}.gvp_to_scalar", self.sub(prot, "gvp_to_scalar"))
        self.type_embedding(pg, prot, "ntype_embedding")
        self.type_embedding(pg, prot, "etype_embedding")

    def cpd_tower(self, pg: str, prot: dict, tower) -> None:
        self.gvp_block(f"{pg}.W_v", prot, "W_v_gvp", "W_v_norm")
        self.gvp_block(f"{pg}.W_e", prot, "W_e_gvp", "W_e_norm")
        for part, name in (("encoder_layers", "encoder"), ("decoder_layers", "decoder")):
            for i, layer in enumerate(getattr(tower, part)):
                self.gvp_conv_layer(f"{pg}.{part}.{i}", self.sub(prot, f"{name}_{i}"), layer)
        self.gvp(f"{pg}.W_out", self.sub(prot, "W_out"))
        self.type_embedding(pg, prot, "ntype_embedding")
        self.type_embedding(pg, prot, "etype_embedding")

    def gatv2_conv(self, prefix: str, p: dict, conv) -> None:
        self.linear(f"{prefix}.lin_l", self.sub(p, "lin_l"))
        self.linear(f"{prefix}.lin_r", self.sub(p, "lin_r"))
        if conv.lin_edge is not None:
            self.linear(f"{prefix}.lin_edge", self.sub(p, "lin_edge"))
        # flax's [1, 1, H, C] against PyG's [1, H, C]
        self.leaf(f"{prefix}.att", p, "att", lambda a: a[0], lambda a: a[None])
        self.leaf(f"{prefix}.bias", p, "bias")

    def heat_conv(self, prefix: str, p: dict) -> None:
        for name in ("hetero_kernel", "hetero_bias", "att"):
            self.leaf(f"{prefix}.{name}", p, name)
        self.leaf(f"{prefix}.edge_type_emb.weight", self.sub(p, "edge_type_emb"), "embedding")
        self.linear(f"{prefix}.edge_attr_emb", self.sub(p, "edge_attr_emb"))
        self.linear(f"{prefix}.att_lin", self.sub(p, "att_lin"))

    def gatv2_tower(self, prefix: str, p: dict, tower) -> None:
        for i, conv in enumerate(tower.conv_list):
            self.gatv2_conv(f"{prefix}.conv_list.{i}", self.sub(p, f"conv_{i}"), conv)
        self.type_embedding(prefix, p, "ntype_embedding")
        self.type_embedding(prefix, p, "etype_embedding")

    def heat_tower(self, prefix: str, p: dict, tower) -> None:
        for i in range(len(tower.conv_list)):
            self.heat_conv(f"{prefix}.conv_list.{i}", self.sub(p, f"conv_{i}"))

    def gine_tower(self, prefix: str, p: dict, tower) -> None:
        for i, conv in enumerate(tower.conv_list):
            self.gine_conv(f"{prefix}.conv_list.{i}", self.sub(p, f"conv_{i}"), conv)
        self.type_embedding(prefix, p, "ntype_embedding")
        self.type_embedding(prefix, p, "etype_embedding")

    def gin_tower(self, prefix: str, p: dict, tower) -> None:
        for i, conv in enumerate(tower.conv_list):
            self.gin_conv(f"{prefix}.conv_list.{i}", self.sub(p, f"conv_{i}"), conv)
        self.type_embedding(prefix, p, "ntype_embedding")
        self.type_embedding(prefix, p, "etype_embedding")

    def attentivefp_tower(self, prefix: str, p: dict, tower) -> None:
        self.linear(f"{prefix}.lin1", self.sub(p, "lin1"))
        self.gate_conv(f"{prefix}.conv_list.0", self.sub(p, "conv_0"))
        for i in range(1, len(tower.conv_list)):
            self.gat_conv(f"{prefix}.conv_list.{i}", self.sub(p, f"conv_{i}"))
        for i in range(len(tower.gru_list)):
            self.gru_cell(f"{prefix}.gru_list.{i}", self.sub(p, f"gru_{i}"))
        self.linear(f"{prefix}.lin2", self.sub(p, "lin2"))
        self.type_embedding(prefix, p, "ntype_embedding")
        self.type_embedding(prefix, p, "etype_embedding")

    def gps_tower(self, prefix: str, p: dict, tower) -> None:
        self.layernorm(f"{prefix}.pe_norm", self.sub(p, "pe_norm"))
        self.linear(f"{prefix}.pe_lin", self.sub(p, "pe_lin"))
        for i, layer in enumerate(tower.layers):
            pl = f"{prefix}.layers.{i}"
            self.gine_conv(f"{pl}.local", self.sub(p, f"conv_{i}_local"), layer.local)
            for j in (1, 2, 3):
                self.layernorm(f"{pl}.norm{j}", self.sub(p, f"conv_{i}_norm{j}"))
            if layer.attn_in is not None:
                self.linear(f"{pl}.attn_in", self.sub(p, f"conv_{i}_attn_in"))
            self.mha(f"{pl}.attn", self.sub(p, f"conv_{i}_attn"), layer.attn.packed)
            self.gin_mlp(f"{pl}.ff", self.sub(p, f"conv_{i}_ff"))
        self.type_embedding(prefix, p, "ntype_embedding")
        self.type_embedding(prefix, p, "etype_embedding")

    def pna_tower(self, prefix: str, p: dict, tower) -> None:
        for i, conv in enumerate(tower.conv_list):
            self.pna_conv(f"{prefix}.conv_list.{i}", self.sub(p, f"conv_{i}"), conv)
        self.type_embedding(prefix, p, "ntype_embedding")
        self.type_embedding(prefix, p, "etype_embedding")

    def tower(self, prefix: str, p: dict, tower) -> None:
        """One tower, by its class."""
        walk = {protein_towers.VectorProteinGNN_LBAModel: self.lba_tower,
                protein_towers.VectorProteinGNN_PocketMiner: self.pocketminer_tower,
                protein_towers.VectorProteinGNN_CPDModel: self.cpd_tower,
                GATv2GNN: self.gatv2_tower, HEATGNN: self.heat_tower,
                molecule_towers.HomoMoleculeGNN_GINE: self.gine_tower,
                molecule_towers.HomoMoleculeGNN_GIN: self.gin_tower,
                molecule_towers.HomoMoleculeGNN_AttentiveFP: self.attentivefp_tower,
                molecule_towers.HomoMoleculeGNN_GPS: self.gps_tower,
                molecule_towers.HomoMoleculeGNN_PNA: self.pna_tower}
        if type(tower) not in walk:
            raise NotImplementedError(f"no weight mapping for the tower {type(tower).__name__}")
        walk[type(tower)](prefix, p, tower)

    def joint(self, params: dict, model: JointGNN) -> None:
        self.tower("protein_gnn.gnn_model", self.sub(params, "protein_gnn"),
                   model.protein_gnn.gnn_model)
        self.tower("molecule_gnn.gnn_model", self.sub(params, "molecule_gnn"),
                   model.molecule_gnn.gnn_model)

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
