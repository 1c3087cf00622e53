"""Training: the train and eval steps, epochs, best checkpoints, early stop
and test metrics (counterpart of caster_dta_tpu/train/loop.py).

The train step is the JAX package's: the masked loss
``sum(w * (pred - target)^2) / max(sum(w), 1)`` over padded pairs on
``pred[:, 0]`` in f32, gradients by autograd (the segment ops' backward runs
the hand-written kernels on the card, ops/segment.py), then optax's
``clip_by_global_norm`` formula, ``MultiSteps`` gradient accumulation (the
running mean of k gradients is applied on the k-th step, and only then does
the optimizer's step count advance) and the optimizer. Mixed precision is
the JAX policy of nn/common.py, entered around each step; parameters,
gradients and optimizer moments stay f32. Dropout is drawn from the trainer's
own generator on its device.

The JAX package's defaults hold: the device-resident graph store
(data/device_cache.py, ``device_data_budget``) and scan-over-steps
(``scan_steps``). A bucket's batches of an epoch then run as one megabatch in
the epoch's order, buckets in a seeded order. On the card each bucket's train
step and eval forward are CUDA graphs (train/graphs.py), captured once after a
few eager warm-up steps and replayed for every later batch; on the CPU the
same megabatches run eagerly.

``fit`` writes the train state (train/checkpoints.py ``save_train_state``:
parameters, optimizer state, the dropout generator, the scheduler, the best
losses and the history) every ``save_state_every`` epochs and at the end, and
``resume`` continues a run from it, bit for bit the straight run's. Not
ported yet, refused by ``TrainConfig``: data and graph parallelism. The
JAX-only knobs ``prng_impl`` and ``flat_params`` have no counterpart here.
"""
from __future__ import annotations

import os
import time
import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from caster_dta_torch.data.batching import BucketedLoader, PairBatch
from caster_dta_torch.data.device_cache import DeviceResidentLoader, MegaBatch, take, upload
from caster_dta_torch.device import resolve_device
from caster_dta_torch.interop.from_jax import (load_jax_params, state_dict_from_jax,
                                               to_jax_params, tree_from_tensors)
from caster_dta_torch.nn.common import compute_dtype, f32_precision
from caster_dta_torch.nn.norm import MaskedBatchNorm
from caster_dta_torch.train import checkpoints, graphs, metrics as metrics_mod
from caster_dta_torch.train.optim import (BATCH_SCHEDULERS, make_optimizer, make_scheduler,
                                          set_learning_rate)

_COMPUTE_DTYPES = {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16,
                   "bf16": torch.bfloat16}

# field: (the value that means "off", the ROADMAP item that ports it)
_NOT_PORTED = {
    "n_dp": (None, "Queue 1 item 11 (multi-device)"),
    "gp": (None, "Queue 1 item 11 (multi-device)"),
}
# torch optimizer state -> its name in the JAX package's optax state
_OPT_STATE_NAMES = {"exp_avg": "mu", "exp_avg_sq": "nu", "momentum_buffer": "trace"}


@dataclass
class TrainConfig:
    """The reference's training constants (train_model.py:392-419), as in
    caster_dta_tpu. ``n_dp`` and ``gp`` are not ported yet: any value but
    None or 1 raises NotImplementedError."""

    n_epochs: int = 2000
    optimizer: str = "adam"
    lr: float = 1e-4
    weight_decay: float = 0.0
    scheduler: Optional[str] = "plateau"
    do_batch_schedule: bool = True
    warmup_epochs: int = 0
    early_stop_epochs: int = 200
    clip_norm: Optional[float] = None
    grad_accum: int = 1
    seed: int = 9
    # matmul compute dtype: "bfloat16" is the reference's AMP-on equivalent;
    # None (or "float32") is pure f32
    compute_dtype: Optional[str] = None
    print_unscaled_loss: bool = True
    # full train-state checkpointing (train/checkpoints.py): write
    # train_state.msgpack every k epochs and at the end (0 = never);
    # resume=True continues an interrupted run from it, bit for bit
    save_state_every: int = 25
    resume: bool = False
    log_every: int = 0           # print per-batch progress if > 0
    # the device-resident graph store (data/device_cache.py): the byte budget
    # of the stores; None (or a loader over budget) assembles on the host
    device_data_budget: Optional[int] = 4_000_000_000
    # a store-backed epoch runs bucket by bucket (train_megabatch): on the
    # card as CUDA-graph replays of the step
    scan_steps: bool = True
    n_dp: Optional[int] = None
    gp: Optional[int] = None

    def __post_init__(self):
        for name, (off, item) in _NOT_PORTED.items():
            value = getattr(self, name)
            if value != off and value != 1:
                raise NotImplementedError(f"TrainConfig.{name}={value!r} is not ported yet: "
                                          f"ROADMAP {item}")
        if self.compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(map(str, _COMPUTE_DTYPES))}")
        if self.grad_accum < 1:
            raise ValueError("grad_accum must be >= 1")


def _put(state: dict, key: str, value: torch.Tensor) -> None:
    """state[key] = value, copied into the existing tensor when there is one."""
    if key in state:
        state[key].copy_(value)
    else:
        state[key] = value.clone()


def clip_by_global_norm(grads: list, max_norm: float) -> list:
    """optax.clip_by_global_norm: unchanged when the global norm is below
    max_norm, else each gradient times max_norm / norm (no epsilon)."""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    return [torch.where(g_norm < max_norm, g, g / g_norm * max_norm) for g in grads]


class ThroughputMeter:
    """Windowed edges/s and pairs/s of the training steps (wall clock)."""

    def __init__(self, window: int = 50):
        self.window = window
        self._t: list = []
        self._edges: list = []
        self._pairs: list = []
        self.total_edges = self.total_pairs = self.total_steps = 0

    def step(self, n_edges: int, n_pairs: int) -> None:
        self.total_edges += int(n_edges)
        self.total_pairs += int(n_pairs)
        self.total_steps += 1
        self._t.append(time.perf_counter())
        self._edges.append(int(n_edges))
        self._pairs.append(int(n_pairs))
        if len(self._t) > self.window + 1:
            self._t.pop(0), self._edges.pop(0), self._pairs.pop(0)

    def _rate(self, counts: list) -> float:
        dt = self._t[-1] - self._t[0] if len(self._t) >= 2 else 0.0
        return float(sum(counts[1:]) / dt) if dt > 0 else 0.0

    @property
    def edges_per_s(self) -> float:
        return self._rate(self._edges)

    @property
    def pairs_per_s(self) -> float:
        return self._rate(self._pairs)

    def summary(self) -> dict:
        return {"edges_per_s": self.edges_per_s, "pairs_per_s": self.pairs_per_s,
                "total_edges": self.total_edges, "total_pairs": self.total_pairs,
                "total_steps": self.total_steps}


def _max_batch_width(loader) -> int:
    """The largest batch size over the loader's buckets."""
    bl = getattr(loader, "loader", loader)   # unwrap DeviceResidentLoader
    bks = bl.buckets()
    if not bks:
        return 1
    return max(bl.bucket_batch_size(b) for b in bks)


class Trainer:
    """Trains ``model`` (a JointGNN) in place on ``device``: the card unless
    the caller passes ``device='cpu'``.

    On the card with ``scan_steps`` the optimizer is capturable
    (train/optim.py), so that a CUDA graph of the step (the scan path) and an
    eager step (``train_step``) take the same step, bit for bit; with
    ``scan_steps=False`` it is the eager form. Learning rates are rounded to
    f32, as the JAX step injects them."""

    def __init__(self, model: torch.nn.Module, config: TrainConfig,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        norms = [name for name, m in model.named_modules() if isinstance(m, MaskedBatchNorm)]
        if norms:
            # the JAX Trainer applies the model with its batch_stats but not
            # as mutable, so its first train step raises on such a model
            raise NotImplementedError(
                f"training a model with MaskedBatchNorm ({', '.join(norms)}: GPS's pe_norm or "
                "out_lin_norm_type='batch'): the JAX package's Trainer cannot take a step on "
                "it either (its batch_stats are not mutable in the step); serve such a model "
                "instead")
        self.config = config
        self.model = model.to(self.device)
        self.dtype = _COMPUTE_DTYPES[config.compute_dtype]
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        on_card = self.device.type == "cuda"
        self.optimizer = make_optimizer(config.optimizer, self.params, config.lr,
                                        config.weight_decay,
                                        capturable=on_card and config.scan_steps)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        self._mini_step = 0
        self._acc: Optional[list] = None
        # the accumulation divisor of an eager step, a device tensor as in the graphs
        self._div = torch.zeros((), device=self.device)
        self._graphs = graphs.GraphCache(self.device) if on_card and config.scan_steps else None

    # ----------------------------------------------------------- params
    def params_tree(self) -> dict:
        """The weights as the JAX package's param tree (numpy, f32)."""
        return to_jax_params(self.model)

    def set_params(self, tree: dict) -> None:
        """Adopt a JAX-format param tree (for example a checkpoint), copied
        into the parameters in place."""
        load_jax_params(self.model, tree)

    # ------------------------------------------------------- train state
    def _param_names(self) -> list:
        return [n for n, p in self.model.named_parameters() if p.requires_grad]

    def opt_state_tree(self) -> dict:
        """The optimizer's state under the JAX package's optax names: ``mu``
        and ``nu`` (Adam's moments) or ``trace`` (SGD's momentum), each a
        param tree; ``count``, the optimizer steps taken; ``mini_step`` and,
        with gradient accumulation, ``acc`` (the running mean of the
        gradients so far)."""
        names = self._param_names()
        state = [self.optimizer.state.get(p, {}) for p in self.params]
        out: dict = {}
        for key, jax_name in _OPT_STATE_NAMES.items():
            if any(key in st for st in state):
                out[jax_name] = tree_from_tensors(
                    self.model, {n: st[key] for n, st in zip(names, state)})
        steps = {int(st["step"]) for st in state if "step" in st}
        if len(steps) > 1:
            raise RuntimeError(f"parameters took different numbers of optimizer steps: {steps}")
        out["count"] = steps.pop() if steps else 0
        out["mini_step"] = self._mini_step
        if self._acc is not None:
            out["acc"] = tree_from_tensors(self.model, dict(zip(names, self._acc)))
        return out

    def opt_state_from_jax(self, tree: dict) -> dict:
        """The optax state of a train state that the JAX package wrote, as
        ``opt_state_tree`` gives it: Adam's moments from ``inner_state/0``
        (a flat vector split in ``ravel_pytree``'s order, or a param tree),
        its ``count`` as the step count. Raises ValueError, before anything
        is written, on any layout but the one this trainer's optimizer and
        ``grad_accum`` would have in JAX (checkpoints.adam_state_from_jax)."""
        st = checkpoints.adam_state_from_jax(tree)
        opt = self.optimizer
        kind = {torch.optim.Adam: "adam", torch.optim.AdamW: "adamw"}.get(type(opt))
        if kind != st["kind"]:
            raise ValueError(f"the JAX train state holds {st['kind']}'s state; this trainer "
                             f"runs {self.config.optimizer!r}")
        if kind == "adam" and self.config.weight_decay:
            raise ValueError("Adam with weight decay is the JAX package's adam_l2 chain, "
                             "whose state this train state does not hold")
        if self.config.grad_accum > 1:
            raise ValueError("grad_accum > 1 is optax.MultiSteps in JAX, whose state this "
                             "train state does not hold")
        group = opt.defaults
        want = {"b1": group["betas"][0], "b2": group["betas"][1], "eps": group["eps"],
                "eps_root": 0.0, "weight_decay": group["weight_decay"]}
        for name, value in st["hyperparams"].items():
            if name in want and np.float32(want[name]) != np.float32(value):
                raise ValueError(f"the JAX train state's {name}={value} differs from this "
                                 f"trainer's {want[name]}")
        template = self.params_tree()
        out = {"count": st["count"], "mini_step": 0}
        for name in ("mu", "nu"):
            m = st[name]
            out[name] = (m if isinstance(m, dict)
                         else checkpoints.unravel_like(np.asarray(m, np.float32), template))
        return out

    def load_opt_state_tree(self, tree: dict) -> None:
        """Adopt ``opt_state_tree``'s output, or the optax state of a JAX
        train state (``opt_state_from_jax``), copied into the optimizer's
        state tensors in place where they exist (a captured step reads those
        very tensors), else into new ones on the parameters' devices; the
        step counts of a capturable optimizer on the card, of an eager one on
        the CPU, as torch keeps them."""
        if checkpoints.is_jax_opt_state(tree):
            tree = self.opt_state_from_jax(tree)
        names = self._param_names()
        count = torch.tensor(float(tree["count"]), dtype=torch.float32)
        stepped = isinstance(self.optimizer, (torch.optim.Adam, torch.optim.AdamW))
        on_device = bool(self.optimizer.defaults.get("capturable"))
        for key, jax_name in _OPT_STATE_NAMES.items():
            if jax_name not in tree:
                continue
            sd = state_dict_from_jax(tree[jax_name], self.model)
            for n, p in zip(names, self.params):
                st = self.optimizer.state[p]
                _put(st, key, sd[n].to(p.device))
                if stepped:
                    _put(st, "step", count.to(p.device) if on_device else count)
        self._mini_step = int(tree.get("mini_step", 0))
        if "acc" in tree:
            sd = state_dict_from_jax(tree["acc"], self.model)
            acc = [sd[n].to(p.device) for n, p in zip(names, self.params)]
            if self._acc is None:
                self._acc = acc
            else:
                for a, v in zip(self._acc, acc):
                    a.copy_(v)

    def rng_state(self) -> dict:
        """The dropout generator's state (torch's ``Generator.get_state``: on
        the card its seed and Philox offset, which every replay of a train
        graph registered with it advances, so this is the state a run
        without graphs holds at the same step) and its device type."""
        return {"dropout": self.generator.get_state().numpy().copy(),
                "device": self.device.type}

    def load_rng_state(self, state: dict) -> None:
        """Adopt ``rng_state``'s output. ``Generator.set_state`` writes the
        generator's state object in place, the object every train graph
        registers; ``fit`` restores it before any graph is captured.

        A JAX key (``{"jax_key", "rng_impl"}``, checkpoints.load_train_state)
        cannot drive torch's Philox generator: the generator is seeded from
        the config's seed instead, with a warning that dropout after the
        resume is not the JAX run's stream."""
        if "jax_key" in state:
            warnings.warn(f"resuming a JAX train state: its dropout key "
                          f"({state['rng_impl'] or 'raw key data'}) cannot drive torch's "
                          f"generator, so dropout from here on is torch's stream seeded with "
                          f"{self.config.seed}, not the JAX run's", stacklevel=2)
            self.generator.manual_seed(self.config.seed)
            return
        if state["device"] != self.device.type:
            raise ValueError(f"a dropout generator state saved on {state['device']} cannot "
                             f"resume on {self.device.type}")
        self.generator.set_state(torch.from_numpy(np.array(state["dropout"], np.uint8)))

    # ------------------------------------------------------------ steps
    def _set_mode(self, train: bool) -> None:
        if self.model.training != train:
            self.model.train(train)

    def _loss(self, protein, molecule, target, weight):
        with f32_precision(), compute_dtype(self.dtype):
            pred, _ = self.model(protein, molecule, return_attention=False,
                                 generator=self.generator)
        pred = pred[:, 0].to(torch.float32)
        loss = torch.sum(weight * (pred - target) ** 2) / torch.clamp(weight.sum(), min=1.0)
        return loss, pred

    def loss(self, batch: PairBatch):
        """(masked loss, pred [B] f32) of a batch on the device, with the
        model in its current mode and the trainer's compute dtype."""
        return self._loss(batch.protein, batch.molecule, batch.target, batch.weight)

    def _step(self, protein, molecule, target, weight, lr, div, apply: bool):
        """The train step's work on the device: loss, gradients, optax's
        MultiSteps running mean ``acc + (g - acc) / div`` when accumulating
        (``apply`` on the k-th mini step, which also zeroes the accumulators),
        clip, and the optimizer at learning rate ``lr`` (a number or a device
        tensor) -> (loss, pred [B]). The same calls run eagerly and under CUDA
        graph capture."""
        set_learning_rate(self.optimizer, lr)
        with f32_precision():
            loss, pred = self._loss(protein, molecule, target, weight)
            grads = list(torch.autograd.grad(loss, self.params))
            accumulate = self.config.grad_accum > 1
            if accumulate:
                if self._acc is None:
                    self._acc = [torch.zeros_like(g) for g in grads]
                for a, g in zip(self._acc, grads):
                    a.add_((g - a) / div)
                if not apply:
                    return loss.detach(), pred.detach()
                grads = self._acc
            if self.config.clip_norm is not None:
                grads = clip_by_global_norm(grads, self.config.clip_norm)
            for p, g in zip(self.params, grads):
                p.grad = g
            self.optimizer.step()
            for p in self.params:
                p.grad = None
            if accumulate:
                torch._foreach_zero_(self._acc)
        return loss.detach(), pred.detach()

    def _next_mini_step(self) -> tuple:
        """(divisor, apply) of the next mini step, and advance the count."""
        n = self._mini_step
        self._mini_step = (n + 1) % self.config.grad_accum
        return n + 1, n + 1 == self.config.grad_accum

    def train_step(self, batch, lr: Optional[float] = None):
        """One training step on ``batch`` (a PairBatch or StoreBatch) at
        learning rate ``lr`` (the config's when None) -> (loss, pred [B] f32),
        both left on the device unsynchronised."""
        batch = batch.to(self.device)
        self._set_mode(True)
        lr = float(np.float32(self.config.lr if lr is None else lr))
        div, apply = self._next_mini_step()
        if self.config.grad_accum > 1:
            self._div.fill_(div)
        return self._step(batch.protein, batch.molecule, batch.target, batch.weight, lr,
                          self._div, apply)

    def train_megabatch(self, mega: MegaBatch, lrs) -> tuple:
        """The k = ``mega.n_steps`` training steps of one bucket's megabatch,
        step j at learning rate ``lrs[j]`` -> (losses [k], preds [k, B]) f32
        on the device, unsynchronised.

        The rows, targets, weights, learning rates and divisors go to the
        device in one copy. On the card with ``scan_steps`` the bucket's step
        runs as CUDA graph replays: before the bucket's graphs exist, its
        first steps run eagerly as warm-up (graphs.WARMUP_STEPS, and until the
        optimizer has its state), then the step is captured (with grad_accum >
        1 twice: accumulate only, accumulate and apply) and each later step
        copies its row into the graph's static row and replays. Otherwise
        every step runs eagerly, through the same code."""
        k, b = mega.p_rows.shape
        divs, applies = zip(*(self._next_mini_step() for _ in range(k)))
        packed = upload(graphs.pack_rows(mega.p_rows, mega.m_rows, mega.target, mega.weight,
                                         lr=lrs, div=divs), self.device)
        self._set_mode(True)

        def body(row, apply):
            step = graphs.unpack_row(row, b)
            loss, pred = self._step(take(mega.p_store, step.p_rows),
                                    take(mega.m_store, step.m_rows), step.target, step.weight,
                                    step.lr, step.div, apply)
            return torch.cat([pred, loss.reshape(1)])

        out = self._run_steps(
            "train", mega, packed, torch.empty(k, b + 1, device=self.device), body, applies,
            lambda warm: warm < graphs.WARMUP_STEPS or not self._ready(),
            (False, True) if self.config.grad_accum > 1 else (True,))
        return out[:, b], out[:, :b]

    def _run_steps(self, kind, mega, packed, out, body, variants, warming, captured):
        """``out[j] = body(packed[j], variants[j])`` for each step j. Without
        a graph cache (the CPU, ``scan_steps=False``) eagerly; else eagerly on
        the capture stream while ``warming(steps warmed so far)`` holds and
        the bucket's step is not captured yet, then by replays of its
        ``captured`` variants, captured once -> out."""
        if self._graphs is None:
            for j, variant in enumerate(variants):
                out[j] = body(packed[j], variant)
            return out
        key = self._graph_key(kind, mega)
        warm = 0
        for j, variant in enumerate(variants):
            entry = self._graphs.get(key)
            if entry is None and warming(warm):
                with self._graphs.side_stream():
                    out[j] = body(packed[j], variant)
                warm += 1
                continue
            if entry is None:
                entry = self._graphs.capture(
                    key, (mega.p_store, mega.m_store), packed.shape[1],
                    {v: (lambda row, v=v: body(row, v)) for v in captured},
                    generator=self.generator if kind == "train" else None)
            out[j] = entry.run(packed[j], variant)
        return out

    def captured_step(self, kind: str, mega: MegaBatch) -> Optional[graphs.CapturedStep]:
        """The captured ``kind`` ('train' or 'eval') step of ``mega``'s bucket
        and stores on the model's current path; None before its capture, on
        the CPU and with ``scan_steps=False``."""
        return None if self._graphs is None else self._graphs.get(self._graph_key(kind, mega))

    def _graph_key(self, kind: str, mega: MegaBatch) -> tuple:
        """A captured step reads its bucket's stores and runs the model's
        path as it was at capture: one graph per kind, store and path (the
        fused message and remat switches, each attention module's
        ``use_pallas``: graphs.model_path)."""
        return (kind, mega.bucket, id(mega.p_store), id(mega.m_store),
                graphs.model_path(self.model))

    def _ready(self) -> bool:
        """Whether a capture would find every state it updates: the
        optimizer's state for each parameter and the accumulators."""
        return (all(p in self.optimizer.state for p in self.params)
                and (self.config.grad_accum == 1 or self._acc is not None))

    @torch.no_grad()
    def eval_step(self, batch) -> torch.Tensor:
        """Predictions [B] f32 in eval mode (no dropout), on the device."""
        batch = batch.to(self.device)
        self._set_mode(False)
        return self._eval_body(batch.protein, batch.molecule)

    def _eval_body(self, protein, molecule) -> torch.Tensor:
        with f32_precision(), compute_dtype(self.dtype):
            pred, _ = self.model(protein, molecule, return_attention=False)
        return pred[:, 0].to(torch.float32)

    @torch.no_grad()
    def eval_megabatch(self, mega: MegaBatch) -> torch.Tensor:
        """Eval-mode predictions [k, B] f32 of one bucket's megabatch, on the
        device: on the card with ``scan_steps`` the first batch eagerly, then
        replays of the bucket's captured forward, as ``train_megabatch``."""
        k, b = mega.p_rows.shape
        packed = upload(graphs.pack_rows(mega.p_rows, mega.m_rows, mega.target, mega.weight),
                        self.device)
        self._set_mode(False)

        def body(row, _):
            step = graphs.unpack_row(row, b)
            return self._eval_body(take(mega.p_store, step.p_rows),
                                   take(mega.m_store, step.m_rows))

        return self._run_steps("eval", mega, packed, torch.empty(k, b, device=self.device),
                               body, [True] * k, lambda warm: warm < graphs.EVAL_WARMUP_STEPS,
                               (True,))

    @torch.no_grad()
    def eval_loss(self, batch: PairBatch) -> torch.Tensor:
        """The masked loss of ``batch`` in eval mode, on the device."""
        self._set_mode(False)
        return self.loss(batch.to(self.device))[0]

    # ----------------------------------------------------------- epochs
    @staticmethod
    def _batch_losses(rows, deferred: list, unscale):
        """Per-batch MSE of the real pairs (after ``unscale``), from each
        batch's host predictions ``rows`` (at least B values each)."""
        losses, sizes, out = [], [], []
        for row, (mask, target, pair_idx) in zip(rows, deferred):
            pred_np = row[:len(mask)][mask]
            target_np = target[mask]
            if unscale is not None:
                pred_np, target_np = unscale(pred_np), unscale(target_np)
            losses.append(metrics_mod.mse(pred_np, target_np))
            sizes.append(int(mask.sum()))
            out.append((pred_np, target_np, pair_idx[mask]))
        return losses, sizes, out

    @staticmethod
    def _split(preds: list, deferred: list) -> list:
        """Per-batch predictions on the host, in one device-to-host copy."""
        host = torch.cat(preds).cpu().numpy() if preds else np.zeros(0, np.float32)
        return np.split(host, np.cumsum([len(d[0]) for d in deferred])[:-1]) if deferred else []

    def _use_scan(self, loader) -> bool:
        return self.config.scan_steps and hasattr(loader, "iter_megabatches")

    def _scan_epoch(self, loader, run):
        """``run(mega, edges) -> preds [k, B]`` over the loader's megabatches,
        each written into one [batches, widest B] device buffer that is
        fetched once at the end (the JAX package's ``_acc_block``) -> (host
        rows, (mask, target, pair_idx) of each batch)."""
        buf = torch.zeros(max(len(loader), 1), _max_batch_width(loader), device=self.device)
        k0, deferred = 0, []
        for mega, edges in loader.iter_megabatches():
            preds = run(mega, edges)
            buf[k0:k0 + mega.n_steps, :preds.shape[1]] = preds
            k0 += mega.n_steps
            deferred += [(mega.weight[j] > 0, mega.target[j], mega.pair_idx[j])
                         for j in range(mega.n_steps)]
        return buf.cpu().numpy(), deferred

    def _train_epoch_scan(self, loader, lr, scheduler, epoch, total_train, unscale, meter):
        """One pass bucket by bucket (``train_megabatch``). Each megabatch's
        learning rates are computed on the host before it runs: the batch
        scheduler depends only on the pairs processed."""
        n_processed = n_steps = 0

        def run(mega, edges):
            nonlocal lr, n_processed, n_steps
            lrs, n_mega = [], 0
            for j in range(mega.n_steps):
                lrs.append(lr)
                n_real = int((mega.weight[j] > 0).sum())
                n_processed += n_real
                n_mega += n_real
                if scheduler is not None and total_train:
                    lr = scheduler.step(epoch + n_processed / total_train)
            preds = self.train_megabatch(mega, lrs)[1]
            if meter is not None:
                meter.step(sum(edges), n_mega)
            self._log_progress(epoch, n_steps, n_steps + mega.n_steps, len(loader),
                               n_processed, lr)
            n_steps += mega.n_steps
            return preds

        rows, deferred = self._scan_epoch(loader, run)
        losses, sizes, _ = self._batch_losses(rows, deferred, unscale)
        return float(np.average(losses, weights=sizes)), lr

    def _log_progress(self, epoch: int, before: int, after: int, total: int, n_pairs: int,
                      lr: float) -> None:
        """With ``config.log_every`` = k > 0, one line when the steps done in
        the epoch pass a multiple of k (from the host's counts: no sync)."""
        k = self.config.log_every
        if k > 0 and after // k > before // k:
            print(f"  E {epoch} batch {after}/{total} | pairs {n_pairs} | LR {lr:.2E}",
                  flush=True)

    def train_epoch(self, loader, lr: float, scheduler=None, epoch: int = 0,
                    total_train: int = 0, unscale=None, meter: Optional[ThroughputMeter] = None):
        """One pass over ``loader`` -> (mean unscaled train MSE, lr). A batch
        scheduler steps on the fractional epoch after every batch. A
        device-resident loader with ``scan_steps`` runs bucket by bucket."""
        if self._use_scan(loader):
            return self._train_epoch_scan(loader, lr, scheduler, epoch, total_train, unscale,
                                          meter)
        n_processed = 0
        preds, deferred = [], []
        for i, batch in enumerate(loader):
            _, pred = self.train_step(batch, lr)
            mask = (batch.weight > 0).numpy()
            n_real = int(mask.sum())
            n_processed += n_real
            if meter is not None:
                meter.step(loader.last_batch_edges, n_real)
            preds.append(pred)
            deferred.append((mask, batch.target.numpy(), batch.pair_idx.numpy()))
            if scheduler is not None and total_train:
                lr = scheduler.step(epoch + n_processed / total_train)
            self._log_progress(epoch, i, i + 1, len(loader), n_processed, lr)
        losses, sizes, _ = self._batch_losses(self._split(preds, deferred), deferred, unscale)
        return float(np.average(losses, weights=sizes)), lr

    def eval_epoch(self, loader, unscale=None):
        """-> (mean unscaled MSE, predictions, targets, pair indices) over the
        real pairs of ``loader`` (bucket by bucket with a device-resident
        loader and ``scan_steps``)."""
        if self._use_scan(loader):
            rows, deferred = self._scan_epoch(loader, lambda mega, _: self.eval_megabatch(mega))
        else:
            preds, deferred = [], []
            for batch in loader:
                preds.append(self.eval_step(batch))
                deferred.append(((batch.weight > 0).numpy(), batch.target.numpy(),
                                 batch.pair_idx.numpy()))
            rows = self._split(preds, deferred)
        losses, sizes, out = self._batch_losses(rows, deferred, unscale)
        pred, target, idx = (np.concatenate(x) for x in zip(*out))
        return float(np.average(losses, weights=sizes)), pred, target, idx


def split_dataset(dataset, seed: int, split_probs=(0.7, 0.15, 0.15)):
    """The dataset's own ``split`` labels ('train'/'val'/'test' per pair)
    when it has them, else a seeded random split (the reference's
    train_model.py:172-197; the same permutation as the JAX package)."""
    labels = getattr(dataset, "split", None)
    if labels is not None:
        return tuple([i for i, s in enumerate(labels) if s == name]
                     for name in ("train", "val", "test"))
    perm = np.random.default_rng(seed).permutation(len(dataset))
    n_train = int(round(split_probs[0] * len(dataset)))
    n_val = int(round(split_probs[1] * len(dataset)))
    return (perm[:n_train].tolist(), perm[n_train:n_train + n_val].tolist(),
            perm[n_train + n_val:].tolist())


def split_leakage_report(dataset, train_idx, val_idx, test_idx) -> dict:
    """Per-split protein and molecule counts and their overlap across splits."""
    splits = {"train": train_idx, "val": val_idx, "test": test_idx}
    ents = {name: (set(dataset.pair_indices[i][0] for i in idxs),
                   set(dataset.pair_indices[i][1] for i in idxs))
            for name, idxs in splits.items()}
    report = {name: {"n_pairs": len(splits[name]), "n_proteins": len(p), "n_molecules": len(m)}
              for name, (p, m) in ents.items()}
    report["overlap"] = {
        f"{a}_{b}_{kind}": len(ents[a][k] & ents[b][k])
        for a, b in (("train", "val"), ("train", "test"), ("val", "test"))
        for k, kind in ((0, "proteins"), (1, "molecules"))}
    return report


_LADDER_KEYS = ("protein_node_ladder", "edge_ladder", "molecule_node_ladder",
                "molecule_edge_ladder", "include_nodepair", "coalesce", "coalesce_min_batches",
                "pad_cache_bytes")


def fit(model, dataset, dataset_name: str, output_folder: str, config: TrainConfig,
        max_num: int, max_batch_size: int, n_epochs: Optional[int] = None,
        verbose: bool = True, initial_params: Optional[dict] = None,
        ladder_kwargs: Optional[dict] = None, device: str | torch.device = "cuda") -> dict:
    """A training run with best-train, best-val and final checkpoints (flax
    ``.msgpack`` files that the JAX package reads), early stopping and test
    metrics of the best-val weights (the reference's train_model.py:534-802).

    ``dataset`` holds ``(protein graph, molecule graph, target)`` pairs with
    ``pair_indices`` (data/batching.PairDataset); its ``unscale_target``, when
    present, reports losses in the original units. As in the JAX package,
    each loader becomes a device-resident store (``DeviceResidentLoader.maybe``)
    when ``config.device_data_budget`` is set and its stores fit the budget."""
    os.makedirs(output_folder, exist_ok=True)
    n_epochs = config.n_epochs if n_epochs is None else n_epochs
    ladder_kwargs = {k: v for k, v in (ladder_kwargs or {}).items() if k in _LADDER_KEYS}
    train_idx, val_idx, test_idx = split_dataset(dataset, config.seed)

    device = resolve_device(device)

    def mk_loader(idxs, shuffle, seed):
        dl = BucketedLoader(dataset, idxs, max_num=max_num, max_batch_size=max_batch_size,
                            shuffle=shuffle, seed=seed, **ladder_kwargs)
        if config.device_data_budget is not None:
            dl = DeviceResidentLoader.maybe(dl, config.device_data_budget, device=device)
        return dl

    train_dl = mk_loader(train_idx, True, config.seed)
    val_dl = mk_loader(val_idx, False, config.seed + 1)
    test_dl = mk_loader(test_idx, False, config.seed + 2)

    trainer = Trainer(model, config, device=device)
    if initial_params is not None:
        trainer.set_params(initial_params)
    resume_state = checkpoints.load_train_state(output_folder) if config.resume else None
    if resume_state is not None and checkpoints.is_jax_opt_state(resume_state["opt_state"]):
        # a JAX run's optax state, read (or refused) before anything is written
        resume_state["opt_state"] = trainer.opt_state_from_jax(resume_state["opt_state"])
    leakage = split_leakage_report(dataset, train_idx, val_idx, test_idx)
    with open(os.path.join(output_folder, "model_summary.txt"), "w") as f:
        f.write(checkpoints.param_summary(trainer.params_tree()))
    with open(os.path.join(output_folder, "model_standardprint.txt"), "w") as f:
        f.write(repr(model))
    if verbose:
        print("Split leakage:", leakage, flush=True)

    unscale = (getattr(dataset, "unscale_target", None) if config.print_unscaled_loss
               else None)
    scheduler = make_scheduler(config.scheduler, config.lr)
    batch_sched = (scheduler if config.scheduler in BATCH_SCHEDULERS and config.do_batch_schedule
                   else None)
    meter = ThroughputMeter()

    best = {"train": np.inf, "val": np.inf}
    # keep only the latest best-train and best-val files
    best_paths: dict = {"train": None, "val": None}

    def save_best(kind, loss, epoch):
        path = os.path.join(output_folder,
                            checkpoints.best_checkpoint_name(kind, dataset_name, loss, epoch))
        checkpoints.save_params(trainer.params_tree(), path)
        old = best_paths[kind]
        if old is not None and old != path and os.path.exists(old):
            os.remove(old)
        best_paths[kind] = path

    n_since_best_val = -1
    lr = config.lr
    mean_val = np.inf
    history = []
    start_epoch = 0
    if config.resume:
        st = resume_state
        if st is not None:
            # before any graph is captured: the dropout generator's state
            # object and the optimizer's state tensors, written in place
            trainer.set_params(st["params"])
            trainer.load_opt_state_tree(st["opt_state"])
            trainer.load_rng_state(st["rng"])
            start_epoch = st["epoch"] + 1
            best["train"], best["val"] = st["best_train"], st["best_val"]
            n_since_best_val = st["n_since_best_val"]
            lr = st["lr"]
            history = st["history"]
            if scheduler is not None and st["scheduler"]:
                vars(scheduler).update(st["scheduler"])
            # the epoch-indexed shuffles and bucket orders a straight run
            # would use from this epoch (the val loader runs once an epoch)
            for dl in (train_dl, val_dl):
                getattr(dl, "loader", dl).epoch = start_epoch
            # adopt the interrupted run's best files so retention supersedes
            # them in place rather than keeping a second pile
            for kind in ("train", "val"):
                try:
                    best_paths[kind] = checkpoints.get_best_model(output_folder, kind)
                except FileNotFoundError:
                    pass
            if verbose:
                print(f"Resumed from epoch {st['epoch']} "
                      f"(best {best['train']:.4f}/{best['val']:.4f})", flush=True)

    def save_state(epoch):
        checkpoints.save_train_state(
            output_folder, params=trainer.params_tree(), opt_state=trainer.opt_state_tree(),
            rng=trainer.rng_state(), epoch=epoch, best_train=best["train"],
            best_val=best["val"], n_since_best_val=n_since_best_val, lr=lr, history=history,
            scheduler=scheduler)

    # a resume with n_epochs <= the reached epoch runs no epoch and goes
    # straight to the final checkpoint and the test metrics (finishing a
    # bounded run that timed out)
    epoch = start_epoch - 1
    if history:
        mean_val = history[-1]["val"]
    for epoch in range(start_epoch, n_epochs):
        t0 = time.time()
        mean_train, lr = ((np.inf, lr) if len(train_dl) == 0 else trainer.train_epoch(
            train_dl, lr, scheduler=batch_sched, epoch=epoch, total_train=len(train_idx),
            unscale=unscale, meter=meter))
        mean_val = trainer.eval_epoch(val_dl, unscale=unscale)[0] if len(val_dl) else np.inf
        n_since_best_val += 1
        marker = ""
        if mean_train < best["train"]:
            best["train"] = mean_train
            save_best("train", mean_train, epoch)
            marker += "*"
        if mean_val < best["val"]:
            best["val"] = mean_val
            n_since_best_val = 0
            save_best("val", mean_val, epoch)
            marker += "**"
        history.append({"epoch": epoch, "lr": lr, "train": mean_train, "val": mean_val,
                        "time_s": time.time() - t0, "edges_per_s": meter.edges_per_s})
        if verbose:
            print(f"E {epoch:<5d} | LR {lr:.2E}  T {mean_train:.4f}  V {mean_val:.4f}  "
                  f"best {best['train']:.4f}/{best['val']:.4f} {marker}  "
                  f"({history[-1]['time_s']:.1f}s)", flush=True)
        if n_since_best_val >= config.early_stop_epochs:
            break
        if epoch >= config.warmup_epochs and scheduler is not None:
            if config.scheduler == "plateau":
                lr = scheduler.step(metric=mean_val)
            elif batch_sched is None:
                lr = scheduler.step(epoch - config.warmup_epochs + 1)
        if config.save_state_every and (epoch + 1) % config.save_state_every == 0:
            save_state(epoch)

    # the last resume point: a bounded run resumes even when n_epochs is not
    # a multiple of save_state_every
    if config.save_state_every:
        save_state(epoch)

    checkpoints.save_params(trainer.params_tree(), os.path.join(
        output_folder, checkpoints.best_checkpoint_name("final", dataset_name, mean_val, epoch)))

    # test metrics of the best-val weights (the final ones when no epoch ran)
    try:
        trainer.set_params(checkpoints.load_params(
            checkpoints.get_best_model(output_folder, "val")))
    except FileNotFoundError:
        if verbose:
            print("no best-val checkpoint on disk; test-evaluating with the final params",
                  flush=True)
    if len(test_dl):
        _, pred, target, _ = trainer.eval_epoch(
            test_dl, unscale=getattr(dataset, "unscale_target", None))
        report = metrics_mod.regression_report(pred, target)
    else:
        report = {"note": "test split empty — no test metrics computed"}
    return {"history": history, "test_metrics": report, "best_val": best["val"],
            "best_train": best["train"], "throughput": meter.summary(), "leakage": leakage,
            "params": trainer.params_tree(), "trainer": trainer}
