"""The plain reference of CASTER-DTA that the benchmark holds the port to.

Written from the reference model's equations (gvp_layers.py, protein_gnn.py,
molecule_gnn.py and joint_gnn.py of Kumar, Romano and Ritchie's CASTER-DTA,
as tests/ref_torch_exec.py re-executes them), in plain PyTorch: a forward
over a state dict under the reference's parameter names, the masked MSE
loss, Adam as torch.optim.Adam computes it, and the explainer's ten Adam
steps on node and edge masks. Gathers are ``index_select`` and sums
``index_add_`` over the real edges only; no kernel, cache or batching of the
program is used, and nothing here imports the program or JAX.

Departures from tests/ref_torch_exec.py, each for the benchmark's needs:

* Graphs come padded, as the program's batches hold them: node arrays
  ``[B, N_pad, ...]``, edges ``[B, E_pad]`` with a mask. Padding edges take
  no part in any sum; padding nodes are computed and then masked out of the
  attention and the pooling, as the reference's dense batches do.
* Training mode draws dropout. Each mask is ``rand(shape) >= rate`` from the
  reference's own generator at the padded shape, in the order the layers run
  (towers, then the head), so a generator seeded as the program's draws the
  same masks the program's steps draw. Whole vector channels drop together.
* ``Precision`` rounds the operands of every matrix product for the
  controls: "tf32" turns TF32 on for the card's f32 products, "fp8" rounds
  both operands to float8_e4m3fn with one scale a tensor, "bf16" to
  bfloat16. "f32" (the reference itself) computes in IEEE f32 with TF32 off.
* ``half_batch`` (a fault planted in the reference for the benchmark's
  readings) leaves the second half of each batch out of the loss, the mean
  taken over the rest.
* Towers: the LBA and CPD GVP protein towers, the GINE and GATv2 molecule
  towers, chosen by the configuration's ``base_conv``.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


# ---------------------------------------------------------------- precision

@dataclass
class Precision:
    """How the reference computes its matrix products: 'f32' (IEEE, TF32
    off), 'tf32' (the card's TF32 for f32 products), 'bf16' (operands
    rounded to bfloat16, product in f32: a witness of what bf16 alone does)
    or 'fp8' (operands rounded to float8_e4m3fn, per-tensor scale, product
    in f32)."""

    mode: str = "f32"

    def __post_init__(self):
        if self.mode not in ("f32", "tf32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {self.mode!r}")

    def round(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "bf16":
            return x.to(torch.bfloat16).to(torch.float32)
        if self.mode != "fp8":
            return x
        scale = torch.clamp(x.detach().abs().amax(), min=1e-12) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale

    @contextlib.contextmanager
    def scope(self):
        """TF32 on the card for 'tf32', off otherwise; restored on exit."""
        mm, conv = torch.backends.cuda.matmul, torch.backends.cudnn
        saved = (mm.allow_tf32, conv.allow_tf32)
        mm.allow_tf32 = conv.allow_tf32 = self.mode == "tf32"
        try:
            yield
        finally:
            mm.allow_tf32, conv.allow_tf32 = saved


@dataclass
class Run:
    """What one pass of the reference needs besides its inputs."""

    params: dict
    precision: Precision = field(default_factory=Precision)
    training: bool = False
    generator: Optional[torch.Generator] = None

    def lin(self, x, w, b=None):
        r = self.precision.round
        out = r(x) @ r(w).t()
        return out if b is None else out + b

    def einsum(self, eq, a, b):
        r = self.precision.round
        return torch.einsum(eq, r(a), r(b))

    def drop(self, x, rate):
        """Inverted dropout drawn at x's shape."""
        if not self.training or rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), device=x.device))

    def drop_sv(self, s, v, rate):
        """Dropout of (s, V): V's 3-vectors drop as whole channels."""
        if not self.training or rate == 0.0:
            return s, v
        s = self.drop(s, rate)
        if v.shape[-2]:
            keep = torch.rand(v.shape[:-1], generator=self.generator, device=v.device) >= rate
            v = torch.where(keep[..., None], v / (1.0 - rate), torch.zeros((), device=v.device))
        return s, v


ACTS = {"relu": F.relu, "leaky_relu": lambda x: F.leaky_relu(x, 0.01), None: None}


def act(fn, x):
    return x if fn is None else fn(x)


def one_hot(types, n):
    """One-hot rows; a type outside [0, n) gives a zero row."""
    return (types[..., None].long() == torch.arange(n, device=types.device)).to(torch.float32)


# ---------------------------------------------------------------- graphs

def flat_ids(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Local node indices [B, E] -> rows of the flattened [B * n] table."""
    return (idx.long() + n * torch.arange(idx.shape[0], device=idx.device)[:, None]).reshape(-1)


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...], idx [B, E] -> [B, E, ...]."""
    b, n = x.shape[:2]
    rows = x.reshape((b * n,) + x.shape[2:]).index_select(0, flat_ids(idx, n))
    return rows.reshape(idx.shape + x.shape[2:])


def scatter_sum(msg: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor, n: int) -> torch.Tensor:
    """Sum of the real edges' msg [B, E, ...] into their destinations -> [B, n, ...]
    (padding edges go to a spare row that is dropped)."""
    b = msg.shape[0]
    ids = torch.where(mask.reshape(-1), flat_ids(dst, n), b * n)
    out = torch.zeros((b * n + 1,) + msg.shape[2:], dtype=msg.dtype, device=msg.device)
    out.index_add_(0, ids, msg.reshape((-1,) + msg.shape[2:]))
    return out[:-1].reshape((b, n) + msg.shape[2:])


def in_degree(dst, mask, n):
    return scatter_sum(torch.ones(dst.shape, device=dst.device), dst, mask, n)


# ---------------------------------------------------------------- GVP

def norm_no_nan(x, dim=-1, keepdim=False, sqrt=True):
    out = torch.clamp(torch.sum(x * x, dim=dim, keepdim=keepdim), min=1e-8)
    return torch.sqrt(out) if sqrt else out


def gvp(run: Run, pre: str, s, v, scalar_act=None, vector_act=None):
    """A GVP under prefix ``pre``; its widths and vector gate read from the
    parameters (gvp_layers.py:111-175)."""
    p = run.params
    vi = p[pre + "wh.weight"].shape[1] if pre + "wh.weight" in p else 0
    if vi:
        vh = run.lin(v.transpose(-1, -2), p[pre + "wh.weight"])          # [..., 3, h]
        s = run.lin(torch.cat([s, norm_no_nan(vh, dim=-2)], -1), p[pre + "ws.weight"],
                    p[pre + "ws.bias"])
        if pre + "wv.weight" in p:
            vout = run.lin(vh, p[pre + "wv.weight"]).transpose(-1, -2)   # [..., vo, 3]
            if pre + "wsv.weight" in p:
                gate = run.lin(act(vector_act, s), p[pre + "wsv.weight"], p[pre + "wsv.bias"])
                vout = vout * torch.sigmoid(gate)[..., None]
            elif vector_act is not None:
                vout = vout * vector_act(norm_no_nan(vout, keepdim=True))
        else:
            vout = s.new_zeros(s.shape[:-1] + (0, 3))
    else:
        s = run.lin(s, p[pre + "ws.weight"], p[pre + "ws.bias"])
        vout = s.new_zeros(s.shape[:-1] + (0, 3))
    return act(scalar_act, s), vout


def gvp_norm(run: Run, pre: str, s, v):
    """Scalar LayerNorm plus the vectors' RMS over channels (gvp_layers.py:221-242)."""
    p = run.params
    s = F.layer_norm(s, s.shape[-1:], p[pre + "scalar_norm.weight"],
                     p[pre + "scalar_norm.bias"], 1e-5)
    if v.shape[-2] == 0:
        return s, v
    vn = torch.sqrt(torch.mean(norm_no_nan(v, keepdim=True, sqrt=False), dim=-2, keepdim=True))
    return s, v / vn


def gvp_conv(run: Run, pre: str, s, v, g: dict, es, ev, acts, aggr: str, message_mask=None):
    """GVPConv: messages GVP-MLP((s_j, v_j), edge, (s_i, v_i)) summed (or
    averaged) at the destination over real edges (gvp_layers.py:244-308)."""
    src, dst = g["edge_src"], g["edge_dst"]
    mask = g["edge_mask"] if message_mask is None else g["edge_mask"] & message_mask
    ms = torch.cat([gather(s, src), es, gather(s, dst)], -1)
    mv = torch.cat([gather(v, src), ev, gather(v, dst)], -2)
    j = 0
    while f"{pre}message_func.{j}.ws.weight" in run.params:
        last = f"{pre}message_func.{j + 1}.ws.weight" not in run.params
        ms, mv = gvp(run, f"{pre}message_func.{j}.", ms, mv, *((None, None) if last else acts))
        j += 1
    n = s.shape[1]
    out_s, out_v = scatter_sum(ms, dst, mask, n), scatter_sum(mv, dst, mask, n)
    if aggr == "mean":
        cnt = torch.clamp(in_degree(dst, g["edge_mask"], n), min=1.0)
        out_s, out_v = out_s / cnt[..., None], out_v / cnt[..., None, None]
    return out_s, out_v


def gvp_conv_layer(run: Run, pre: str, s, v, g: dict, es, ev, acts, aggr, rate, enc=None):
    """Residual GVPConvLayer (gvp_layers.py:311-415): conv, dropout, add and
    norm, the two-GVP feedforward, dropout, add and norm. With ``enc`` (the
    encoder's (s, v)) the layer is autoregressive: forward edges (src < dst)
    message from the layer's input, the others from ``enc``, summed and
    divided by the real in-degree."""
    if enc is None:
        ds, dv = gvp_conv(run, pre + "conv.", s, v, g, es, ev, acts, aggr)
    else:
        fwd = g["edge_src"] < g["edge_dst"]
        a_s, a_v = gvp_conv(run, pre + "conv.", s, v, g, es, ev, acts, "sum", fwd)
        b_s, b_v = gvp_conv(run, pre + "conv.", enc[0], enc[1], g, es, ev, acts, "sum", ~fwd)
        cnt = torch.clamp(in_degree(g["edge_dst"], g["edge_mask"], s.shape[1]), min=1.0)
        ds, dv = (a_s + b_s) / cnt[..., None], (a_v + b_v) / cnt[..., None, None]
    ds, dv = run.drop_sv(ds, dv, rate)
    hs, hv = gvp_norm(run, pre + "norm.0.", s + ds, v + dv)
    fs, fv = gvp(run, pre + "ff_func.0.", hs, hv, *acts)
    fs, fv = gvp(run, pre + "ff_func.1.", fs, fv)
    fs, fv = run.drop_sv(fs, fv, rate)
    return gvp_norm(run, pre + "norm.1.", hs + fs, hv + fv)


def lba_tower(run: Run, pre: str, g: dict, kw: dict):
    """VectorProteinGNN_LBAModel (protein_gnn.py:289-388) -> residue rows [B, N, out]."""
    relu = ACTS["relu"]
    s = torch.cat([one_hot(g["node_type"], kw["num_ntypes"]), g["node_s"]], -1)
    es = torch.cat([one_hot(g["edge_type"], kw["num_etypes"]), g["edge_s"]], -1)
    s, v = gvp(run, pre + "gvp_node.0.", s, g["node_v"])
    s, v = gvp_norm(run, pre + "gvp_node.1.", s, v)
    es, ev = gvp(run, pre + "gvp_edge.0.", es, g["edge_v"])
    es, ev = gvp_norm(run, pre + "gvp_edge.1.", es, ev)
    for i in range(kw["num_convs"]):
        s, v = gvp_conv_layer(run, f"{pre}conv_list.{i}.", s, v, g, es, ev, (relu, None),
                              kw.get("aggr", "mean"), kw["dropout_rate"])
    s, v = gvp_norm(run, pre + "gvp_norm_before_scalar.", s, v)
    return gvp(run, pre + "gvp_to_scalar.", s, v, relu, None)[0]


# ---------------------------------------------------------------- molecule

def gine_tower(run: Run, pre: str, g: dict, kw: dict):
    """HomoMoleculeGNN_GINE (molecule_gnn.py:208-280): per conv
    MLP((1 + eps) x_i + sum_j relu(x_j + lin e_ji)), the activation, dropout
    between convs -> atom rows [B, N, out]."""
    p, f = run.params, ACTS[kw.get("activation", "relu")]
    x = torch.cat([one_hot(g["node_type"], kw["num_ntypes"]), g["node_s"]], -1)
    e = torch.cat([one_hot(g["edge_type"], kw["num_etypes"]), g["edge_s"]], -1)
    n = x.shape[1]
    for i in range(kw["num_convs"]):
        c = f"{pre}conv_list.{i}."
        msg = F.relu(gather(x, g["edge_src"]) + run.lin(e, p[c + "lin.weight"], p[c + "lin.bias"]))
        h = (1.0 + p[c + "eps"]) * x + scatter_sum(msg, g["edge_dst"], g["edge_mask"], n)
        h = run.lin(act(f, run.lin(h, p[c + "nn.lins.0.weight"], p[c + "nn.lins.0.bias"])),
                    p[c + "nn.lins.1.weight"], p[c + "nn.lins.1.bias"])
        x = act(f, h)
        if i < kw["num_convs"] - 1:
            x = run.drop(x, kw["dropout_rate"])
    return x


def cpd_tower(run: Run, pre: str, g: dict, kw: dict):
    """VectorProteinGNN_CPDModel (protein_gnn.py; the GVP paper's CPD
    model): input GVP and norm of the node features (no type) and of the
    typed edges, ``num_convs`` encoder layers (GVP activations relu and
    sigmoid, no gate, mean aggregation), then ``num_convs`` autoregressive
    decoder layers whose edges also carry the source residue's one-hot type,
    zeroed where src >= dst; the output GVP -> residue rows [B, N, out]."""
    acts, rate = (ACTS["relu"], torch.sigmoid), kw["dropout_rate"]
    es = torch.cat([one_hot(g["edge_type"], kw["num_etypes"]), g["edge_s"]], -1)
    s, v = gvp_norm(run, pre + "W_v.1.", *gvp(run, pre + "W_v.0.", g["node_s"], g["node_v"]))
    es, ev = gvp_norm(run, pre + "W_e.1.", *gvp(run, pre + "W_e.0.", es, g["edge_v"]))
    for i in range(kw["num_convs"]):
        s, v = gvp_conv_layer(run, f"{pre}encoder_layers.{i}.", s, v, g, es, ev, acts, "mean",
                              rate)
    enc = (s, v)
    h = gather(one_hot(g["node_type"], kw["num_ntypes"]), g["edge_src"])
    h = torch.where((g["edge_src"] >= g["edge_dst"])[..., None], torch.zeros((), device=h.device),
                    h)
    des = torch.cat([es, h], -1)
    for i in range(kw["num_convs"]):
        s, v = gvp_conv_layer(run, f"{pre}decoder_layers.{i}.", s, v, g, des, ev, acts, "sum",
                              rate, enc=enc)
    return gvp(run, pre + "W_out.", s, v)[0]


def segment_softmax(logit, dst, mask, n):
    """Softmax of per-edge logits [B, E, H] over each destination's real
    edges (stabilised by the row max; a row with no edge takes 0)."""
    b, e, h = logit.shape
    ids = torch.where(mask.reshape(-1), flat_ids(dst, n), b * n)[:, None].expand(-1, h)
    mx = torch.full((b * n + 1, h), float("-inf"), device=logit.device)
    mx = mx.scatter_reduce(0, ids, logit.reshape(-1, h), "amax", include_self=True)[:-1]
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros((), device=mx.device))
    ex = torch.exp(logit - gather(mx.reshape(b, n, h), dst))
    ex = torch.where(mask[..., None], ex, torch.zeros((), device=ex.device))
    den = scatter_sum(ex, dst, mask, n)
    return ex / torch.clamp(gather(den, dst), min=1e-16)


def gatv2_tower(run: Run, pre: str, g: dict, kw: dict):
    """The GATv2 molecule tower (molecule_gnn.py's GAT tower, PyG's
    GATv2Conv without self-loops): per conv, alpha_ij = softmax_j(att .
    LeakyReLU_0.2(lin_l x_i + lin_r x_j + lin_edge e_ij)) per head, out_i =
    sum_j alpha_ij lin_r x_j, heads averaged (concat off) plus the bias; the
    activation after every conv, dropout between convs -> atom rows."""
    p, f = run.params, ACTS[kw.get("activation", "relu")]
    heads, concat = kw.get("heads", 1), kw.get("concat", True)
    x = torch.cat([one_hot(g["node_type"], kw["num_ntypes"]), g["node_s"]], -1)
    e = torch.cat([one_hot(g["edge_type"], kw["num_etypes"]), g["edge_s"]], -1)
    src, dst, mask = g["edge_src"], g["edge_dst"], g["edge_mask"]
    b, n = x.shape[:2]
    for i in range(kw["num_convs"]):
        c = f"{pre}conv_list.{i}."
        ch = p[c + "lin_l.weight"].shape[0] // heads
        xl = run.lin(x, p[c + "lin_l.weight"], p[c + "lin_l.bias"]).reshape(b, n, heads, ch)
        xr = run.lin(x, p[c + "lin_r.weight"], p[c + "lin_r.bias"]).reshape(b, n, heads, ch)
        xj = gather(xr, src)
        z = gather(xl, dst) + xj + run.lin(e, p[c + "lin_edge.weight"]).reshape(
            e.shape[:2] + (heads, ch))
        z = F.leaky_relu(z, kw.get("conv_neg_slope", 0.2))
        alpha = segment_softmax((z * p[c + "att"]).sum(-1), dst, mask, n)
        out = scatter_sum(xj * alpha[..., None], dst, mask, n)
        out = out.reshape(b, n, heads * ch) if concat else out.mean(dim=-2)
        x = act(f, out + p[c + "bias"])
        if i < kw["num_convs"] - 1:
            x = run.drop(x, kw["dropout_rate"])
    return x


PROTEIN_TOWERS = {"lbamodel": lba_tower, "cpdmodel": cpd_tower}
MOLECULE_TOWERS = {"gine": gine_tower, "gatv2": gatv2_tower}


# ---------------------------------------------------------------- shapes

def _dims(x):
    return (x, 0) if isinstance(x, int) else tuple(x)


def gvp_shapes(pre, in_dims, out_dims, gate):
    (si, vi), (so, vo) = in_dims, out_dims
    if not vi:
        return {pre + "ws.weight": (so, si), pre + "ws.bias": (so,)}
    h = max(vi, vo)
    out = {pre + "wh.weight": (h, vi), pre + "ws.weight": (so, si + h), pre + "ws.bias": (so,)}
    if vo:
        out[pre + "wv.weight"] = (vo, h)
        if gate:
            out.update({pre + "wsv.weight": (vo, so), pre + "wsv.bias": (vo,)})
    return out


def norm_shapes(pre, width):
    return {pre + "weight": (width,), pre + "bias": (width,)}


def conv_layer_shapes(c, hid, edge, gate):
    msg = (2 * hid[0] + edge[0], 2 * hid[1] + edge[1])
    ff = (4 * hid[0], 2 * hid[1])
    out = {}
    for j, d in enumerate((msg, hid, hid)):
        out.update(gvp_shapes(f"{c}conv.message_func.{j}.", d, hid, gate))
    for j in range(2):
        out.update(norm_shapes(f"{c}norm.{j}.scalar_norm.", hid[0]))
    out.update(gvp_shapes(c + "ff_func.0.", hid, ff, gate))
    out.update(gvp_shapes(c + "ff_func.1.", ff, hid, gate))
    return out


def lba_shapes(pre, kw):
    (ns, nv), (es, ev) = _dims(kw["in_channels"]), _dims(kw["edge_dim"])
    hid, ehid = _dims(kw["hidden_channels"]), _dims(kw["edge_hidden_channels"])
    out = {**gvp_shapes(pre + "gvp_node.0.", (ns + kw["num_ntypes"], nv), hid, True),
           **norm_shapes(pre + "gvp_node.1.scalar_norm.", hid[0]),
           **gvp_shapes(pre + "gvp_edge.0.", (es + kw["num_etypes"], ev), ehid, True),
           **norm_shapes(pre + "gvp_edge.1.scalar_norm.", ehid[0])}
    for i in range(kw["num_convs"]):
        out.update(conv_layer_shapes(f"{pre}conv_list.{i}.", hid, ehid, True))
    out.update(norm_shapes(pre + "gvp_norm_before_scalar.scalar_norm.", hid[0]))
    out.update(gvp_shapes(pre + "gvp_to_scalar.", hid, (kw["out_channels"], 0), True))
    return out


def cpd_shapes(pre, kw):
    (ns, nv), (es, ev) = _dims(kw["in_channels"]), _dims(kw["edge_dim"])
    hid, ehid = _dims(kw["hidden_channels"]), _dims(kw["edge_hidden_channels"])
    out = {**gvp_shapes(pre + "W_v.0.", (ns, nv), hid, False),
           **norm_shapes(pre + "W_v.1.scalar_norm.", hid[0]),
           **gvp_shapes(pre + "W_e.0.", (es + kw["num_etypes"], ev), ehid, False),
           **norm_shapes(pre + "W_e.1.scalar_norm.", ehid[0])}
    for i in range(kw["num_convs"]):
        out.update(conv_layer_shapes(f"{pre}encoder_layers.{i}.", hid, ehid, False))
        out.update(conv_layer_shapes(f"{pre}decoder_layers.{i}.", hid,
                                     (ehid[0] + kw["num_ntypes"], ehid[1]), False))
    out.update(gvp_shapes(pre + "W_out.", hid, (kw["out_channels"], 0), False))
    return out


def gatv2_shapes(pre, kw):
    heads, concat = kw.get("heads", 1), kw.get("concat", True)
    hidden = kw.get("hidden_channels") or kw["out_channels"]
    width, out = kw["in_channels"] + kw["num_ntypes"], {}
    for i, ch in enumerate([hidden] * (kw["num_convs"] - 1) + [kw["out_channels"]]):
        c = f"{pre}conv_list.{i}."
        out.update({c + "lin_l.weight": (heads * ch, width), c + "lin_l.bias": (heads * ch,),
                    c + "lin_r.weight": (heads * ch, width), c + "lin_r.bias": (heads * ch,),
                    c + "lin_edge.weight": (heads * ch, kw["edge_dim"] + kw["num_etypes"]),
                    c + "att": (1, heads, ch), c + "bias": (heads * ch if concat else ch,)})
        width = heads * ch if concat else ch
    return out


def gine_shapes(pre, kw):
    dims = ([kw["in_channels"] + kw["num_ntypes"]] + [kw["hidden_channels"]] * (kw["num_convs"] - 1)
            + [kw["out_channels"]])
    out = {}
    for i in range(kw["num_convs"]):
        c = f"{pre}conv_list.{i}."
        out.update({c + "eps": (1,), c + "lin.weight": (dims[i], kw["edge_dim"] + kw["num_etypes"]),
                    c + "lin.bias": (dims[i],), c + "nn.lins.0.weight": (dims[i + 1], dims[i]),
                    c + "nn.lins.0.bias": (dims[i + 1],),
                    c + "nn.lins.1.weight": (dims[i + 1], dims[i + 1]),
                    c + "nn.lins.1.bias": (dims[i + 1],)})
    return out


PROTEIN_SHAPES = {"lbamodel": lba_shapes, "cpdmodel": cpd_shapes}
MOLECULE_SHAPES = {"gine": gine_shapes, "gatv2": gatv2_shapes}


def param_shapes(kwargs: dict) -> dict:
    """name -> shape of every parameter of the model, in the reference's names."""
    pk, mk, jk = kwargs["protein_gnn_kwargs"], kwargs["molecule_gnn_kwargs"], \
        kwargs["joint_gnn_kwargs"]
    out = {**PROTEIN_SHAPES[pk["base_conv"]]("protein_gnn.gnn_model.", pk),
           **MOLECULE_SHAPES[mk["base_conv"]]("molecule_gnn.gnn_model.", mk)}

    def stack(name, depth, d, factor=2.0):
        for i in range(depth):
            out[f"{name}.{i}.weight"], out[f"{name}.{i}.bias"] = (int(d * factor), d), \
                (int(d * factor),)
            d = int(d * factor)
        return d

    d1 = stack("residue_lins", jk["residue_lin_depth"], pk["out_channels"])
    d2 = stack("atom_lins", jk["atom_lin_depth"], mk["out_channels"])
    s = jk.get("residual_dim_ff_scale", 2)
    for layer in range(jk.get("num_cross_attn_layers", 1)):
        c = f"cross_attn_module.cross_attn_layers.{layer}."
        for k, d in (("1", d1), ("2", d2)):
            out.update(norm_shapes(f"{c}preattn_norm{k}.", d))
            out.update(norm_shapes(f"{c}ff_norm{k}.", d))
            out.update({f"{c}ff{k}.0.weight": (d * s, d), f"{c}ff{k}.0.bias": (d * s,),
                        f"{c}ff{k}.3.weight": (d, d * s), f"{c}ff{k}.3.bias": (d,)})
        for name, e, kd in (("embed1_to_2", d1, d2), ("embed2_to_1", d2, d1)):
            if kd == e:
                out[f"{c}{name}.in_proj_weight"] = (3 * e, e)
            else:
                out.update({f"{c}{name}.q_proj_weight": (e, e), f"{c}{name}.k_proj_weight": (e, kd),
                            f"{c}{name}.v_proj_weight": (e, kd)})
            out.update({f"{c}{name}.in_proj_bias": (3 * e,), f"{c}{name}.out_proj.weight": (e, e),
                        f"{c}{name}.out_proj.bias": (e,)})
    dp = stack("protein_lins", jk["protein_lin_depth"], d1)
    dm = stack("molecule_lins", jk["molecule_lin_depth"], d2)
    pe = jk["pairwise_embedding_dim"]
    out.update({"pm_embed_lin.weight": (pe, dp + dm), "pm_embed_lin.bias": (pe,)})
    do = stack("out_fc_layers", jk["out_lin_depth"], pe, jk.get("out_lin_factor", 0.5))
    out.update({"output_layer.weight": (1, do), "output_layer.bias": (1,)})
    return out


# ---------------------------------------------------------------- joint

def mha(run: Run, pre: str, q_in, kv_in, key_pad, heads: int):
    """Multi-head attention with key padding (-1e9 logits), softmax in f32;
    -> (out, weights averaged over heads)."""
    p = run.params
    e = q_in.shape[-1]
    if pre + "in_proj_weight" in p:
        wq, wk, wv = p[pre + "in_proj_weight"].chunk(3)
    else:
        wq, wk, wv = (p[pre + k] for k in ("q_proj_weight", "k_proj_weight", "v_proj_weight"))
    bq, bk, bv = p[pre + "in_proj_bias"].chunk(3)
    b, lq, lk, hd = q_in.shape[0], q_in.shape[1], kv_in.shape[1], e // heads
    q = run.lin(q_in, wq, bq).reshape(b, lq, heads, hd).transpose(1, 2)
    k = run.lin(kv_in, wk, bk).reshape(b, lk, heads, hd).transpose(1, 2)
    v = run.lin(kv_in, wv, bv).reshape(b, lk, heads, hd).transpose(1, 2)
    logits = run.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
    logits = logits.masked_fill(key_pad[:, None, None, :], -1e9)
    w = torch.softmax(logits, dim=-1)
    out = run.einsum("bhqk,bhkd->bhqd", w, v).transpose(1, 2).reshape(b, lq, e)
    return run.lin(out, p[pre + "out_proj.weight"], p[pre + "out_proj.bias"]), w.mean(dim=1)


def forward(run: Run, kwargs: dict, protein: dict, molecule: dict):
    """JointGNN (joint_gnn.py:15-317) -> (score [B], residues->atoms
    [B, R, A], atoms->residues [B, A, R]) of the first cross-attention layer."""
    p = run.params
    pk, mk, jk = kwargs["protein_gnn_kwargs"], kwargs["molecule_gnn_kwargs"], \
        kwargs["joint_gnn_kwargs"]
    f, rate = ACTS[jk.get("activation", "relu")], jk.get("dropout", 0.0)
    res = PROTEIN_TOWERS[pk["base_conv"]](run, "protein_gnn.gnn_model.", protein, pk)
    atom = MOLECULE_TOWERS[mk["base_conv"]](run, "molecule_gnn.gnn_model.", molecule, mk)

    def stack(x, name, depth):
        for i in range(depth):
            x = run.drop(act(f, run.lin(x, p[f"{name}.{i}.weight"], p[f"{name}.{i}.bias"])), rate)
        return x

    res = stack(res, "residue_lins", jk["residue_lin_depth"])
    atom = stack(atom, "atom_lins", jk["atom_lin_depth"])
    rmask, amask = protein["node_mask"], molecule["node_mask"]
    maps = None
    for layer in range(jk.get("num_cross_attn_layers", 1)):
        c = f"cross_attn_module.cross_attn_layers.{layer}."
        x1 = F.layer_norm(res, res.shape[-1:], p[c + "preattn_norm1.weight"],
                          p[c + "preattn_norm1.bias"], 1e-5)
        x2 = F.layer_norm(atom, atom.shape[-1:], p[c + "preattn_norm2.weight"],
                          p[c + "preattn_norm2.bias"], 1e-5)
        a1, w1 = mha(run, c + "embed1_to_2.", x1, x2, ~amask, jk["n_attention_heads"])
        a2, w2 = mha(run, c + "embed2_to_1.", x2, x1, ~rmask, jk["n_attention_heads"])
        if maps is None:
            maps = (w1, w2)

        def residual(e, a, k):
            e = e + run.drop(a, rate)
            h = F.layer_norm(e, e.shape[-1:], p[f"{c}ff_norm{k}.weight"],
                             p[f"{c}ff_norm{k}.bias"], 1e-5)
            h = run.drop(F.relu(run.lin(h, p[f"{c}ff{k}.0.weight"], p[f"{c}ff{k}.0.bias"])), rate)
            return e + run.drop(run.lin(h, p[f"{c}ff{k}.3.weight"], p[f"{c}ff{k}.3.bias"]), rate)

        res, atom = residual(res, a1, 1), residual(atom, a2, 2)
    prot = (res * rmask[..., None]).sum(1) / rmask.sum(1, keepdim=True)
    mol = (atom * amask[..., None]).sum(1) / amask.sum(1, keepdim=True)
    prot, mol = run.drop(act(f, prot), rate), run.drop(act(f, mol), rate)
    prot = stack(prot, "protein_lins", jk["protein_lin_depth"])
    mol = stack(mol, "molecule_lins", jk["molecule_lin_depth"])
    x = run.drop(act(f, run.lin(torch.cat([prot, mol], -1), p["pm_embed_lin.weight"],
                                p["pm_embed_lin.bias"])), rate)
    x = stack(x, "out_fc_layers", jk["out_lin_depth"])
    score = run.lin(x, p["output_layer.weight"], p["output_layer.bias"])[:, 0]
    return score, maps[0], maps[1]


# ---------------------------------------------------------------- training

def masked_loss(pred, target, weight, half_batch: bool = False):
    """sum(w (pred - target)^2) / max(sum w, 1); ``half_batch`` (a planted
    fault) keeps only the first half of the rows."""
    if half_batch:
        weight = weight.clone()
        weight[weight.shape[0] // 2:] = 0.0
    return torch.sum(weight * (pred - target) ** 2) / torch.clamp(weight.sum(), min=1.0)


class Adam:
    """torch.optim.Adam's update (betas 0.9, 0.999, eps 1e-8, no decay),
    from zero moments or from a given ``state`` (m, v, steps taken)."""

    def __init__(self, params: dict, lr: float, b1=0.9, b2=0.999, eps=1e-8, state=None):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        if state is None:
            self.m = {k: torch.zeros_like(v) for k, v in params.items()}
            self.v = {k: torch.zeros_like(v) for k, v in params.items()}
            self.t = 0
        else:
            m, v, self.t = state
            self.m = {k: m[k].clone() if k in m else torch.zeros_like(p)
                      for k, p in params.items()}
            self.v = {k: v[k].clone() if k in v else torch.zeros_like(p)
                      for k, p in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[k].sqrt() / math.sqrt(bc2) + self.eps
            params[k].addcdiv_(self.m[k], denom, value=-self.lr / bc1)


def train_steps(kwargs: dict, params: dict, batches: list, lr: float, seed: int,
                precision: Precision, half_batch: bool = False, state=None,
                generator_state: Optional[torch.Tensor] = None) -> dict:
    """Adam steps from ``params`` (copied) on ``batches`` (each a dict of
    protein, molecule, target, weight), dropout drawn from a generator on the
    params' device seeded with ``seed`` -> losses, the first gradient by
    leaf, each leaf's change after every step, and where the steps ended
    (``state``: params, Adam's m and v, steps taken; ``generator``: the
    dropout generator's state). ``state`` and ``generator_state`` start the
    steps from such an end instead of from zero moments and the seed."""
    device = next(iter(params.values())).device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if generator_state is not None:
        gen.set_state(generator_state)
    p0 = {k: v.detach().clone().float() for k, v in params.items()}
    cur = {k: v.clone() for k, v in p0.items()}
    opt = Adam(cur, lr, state=state)
    out = {"loss": [], "grad": None, "change": []}
    with precision.scope():
        for batch in batches:
            leaves = {k: v.detach().requires_grad_(True) for k, v in cur.items()}
            run = Run(leaves, precision, training=True, generator=gen)
            pred = forward(run, kwargs, batch["protein"], batch["molecule"])[0]
            loss = masked_loss(pred, batch["target"], batch["weight"], half_batch)
            names = list(leaves)
            grads = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names],
                                                        allow_unused=True)))
            grads = {k: torch.zeros_like(cur[k]) if g is None else g for k, g in grads.items()}
            if out["grad"] is None:
                out["grad"] = {k: g.detach().clone() for k, g in grads.items()}
            opt.step(cur, grads)
            out["loss"].append(float(loss.detach()))
            out["change"].append({k: cur[k] - p0[k] for k in cur})
    out["state"] = (cur, opt.m, opt.v, opt.t)
    out["generator"] = gen.get_state()
    return out


@torch.no_grad()
def predict(kwargs: dict, params: dict, protein: dict, molecule: dict,
            precision: Precision) -> tuple:
    """The eval-mode forward -> (score [B], residues->atoms, atoms->residues)."""
    with precision.scope():
        return forward(Run(params, precision), kwargs, protein, molecule)


# ---------------------------------------------------------------- explainer

def _mask_reg(m, valid, coeff_size, coeff_ent):
    n = torch.clamp(valid.sum(), min=1)
    size = torch.where(valid, m, 0.0).sum() / n
    ent = -m * torch.log(m + 1e-10) - (1 - m) * torch.log(1 - m + 1e-10)
    return coeff_size * size + coeff_ent * torch.where(valid, ent, 0.0).sum() / n


def explain(kwargs: dict, params: dict, protein: dict, molecule: dict, init: dict,
            precision: Precision, n_epochs: int = 10, lr: float = 0.01,
            coeffs=(0.005, 0.1, 0.005, 1.0), frozen: bool = False) -> dict:
    """The explainer (inference/explain.py of the reference package): per
    tower, sigmoid node-mask logits scale its node features (and vectors)
    and sigmoid edge-mask logits its edge features; ``n_epochs`` steps of
    optax's Adam (b1 0.9, b2 0.999, eps 1e-8) on mean((pred - full)^2) plus
    the masks' size and entropy terms averaged over the real nodes and edges.
    ``init[(side, 'node' | 'edge')]`` are the initial logits. -> sigmoid
    masks {'protein', 'protein_edges', 'molecule', 'molecule_edges'}.
    ``frozen`` (a planted fault) returns the initial masks unmoved."""
    cs, ce, ces, cee = coeffs
    out = {}
    with precision.scope():
        with torch.no_grad():
            full = forward(Run(params, precision), kwargs, protein, molecule)[0]
        for side in ("protein", "molecule"):
            graph = protein if side == "protein" else molecule
            logits = [init[(side, "node")].clone(), init[(side, "edge")].clone()]
            mu = [torch.zeros_like(t) for t in logits]
            nu = [torch.zeros_like(t) for t in logits]
            for step in range(1, 0 if frozen else n_epochs + 1):
                x = [t.detach().requires_grad_(True) for t in logits]
                m, em = torch.sigmoid(x[0])[..., None], torch.sigmoid(x[1])[..., None]
                g = dict(graph, node_s=graph["node_s"] * m, edge_s=graph["edge_s"] * em)
                if side == "protein":
                    g["node_v"] = graph["node_v"] * m[..., None]
                    g["edge_v"] = graph["edge_v"] * em[..., None]
                pair = (g, molecule) if side == "protein" else (protein, g)
                pred = forward(Run(params, precision), kwargs, *pair)[0]
                loss = (torch.mean((pred - full) ** 2)
                        + _mask_reg(torch.sigmoid(x[0]), graph["node_mask"], cs, ce)
                        + _mask_reg(torch.sigmoid(x[1]), graph["edge_mask"], ces, cee))
                grads = torch.autograd.grad(loss, x)
                bc1 = 1 - 0.9 ** step
                bc2 = 1 - 0.999 ** step
                with torch.no_grad():
                    for i, gr in enumerate(grads):
                        mu[i] = 0.1 * gr + 0.9 * mu[i]
                        nu[i] = 0.001 * gr * gr + 0.999 * nu[i]
                        logits[i] = logits[i] - lr * (mu[i] / bc1) / (torch.sqrt(nu[i] / bc2)
                                                                       + 1e-8)
            out[side] = torch.sigmoid(logits[0])
            out[side + "_edges"] = torch.sigmoid(logits[1])
    return out
