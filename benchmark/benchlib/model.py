"""Seeded weights, made on the device, handed alike to the port and to the
plain reference.

``make_weights`` draws every parameter in one call of a generator on the
device (a flat uniform vector, cut into the leaves of the reference's
``param_shapes``) in f32, the type the port keeps its parameters in: a
weight matrix of fan-in k takes U(-1, 1) / sqrt(k), as torch's Linear
does; its bias the same scale; LayerNorm weights 1 and biases 0; GINE's
eps and the attention's input biases 0. ``port_model`` builds the port's
JointGNN without initialising it and loads these tensors, strictly: a name
or a shape that differs between the two raises.
"""
from __future__ import annotations

import math

import torch


def _fan_in(name: str, shapes: dict) -> int:
    if len(shapes[name]) >= 2:
        return shapes[name][-1]
    weight = name[: -len("bias")] + "weight"
    return shapes[weight][1] if name.endswith("bias") and weight in shapes else 0


def make_weights(shapes: dict, seed: int, device) -> dict:
    """name -> f32 tensor on ``device``, drawn from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out = {}
    for name, part in zip(names, flat.split(sizes)):
        leaf = name.rsplit(".", 1)[-1]
        if "norm" in name and leaf in ("weight", "bias"):
            t = torch.full(shapes[name], 1.0 if leaf == "weight" else 0.0, device=device)
        elif leaf in ("eps", "in_proj_bias") or _fan_in(name, shapes) == 0:
            t = torch.zeros(shapes[name], device=device)
        else:
            t = part.reshape(shapes[name]) / math.sqrt(_fan_in(name, shapes))
        out[name] = t.contiguous()
    return out


def port_model(model_kwargs: dict, weights: dict, device):
    """The port's JointGNN on ``device`` holding ``weights``."""
    from caster_dta_torch.models.joint import make_joint_gnn

    with torch.device("meta"):
        model = make_joint_gnn(model_kwargs["protein_gnn_kwargs"],
                               model_kwargs["molecule_gnn_kwargs"],
                               **model_kwargs["joint_gnn_kwargs"])
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model
