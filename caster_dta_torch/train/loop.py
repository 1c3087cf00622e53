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

Not ported yet, each refused by ``TrainConfig``: train-state checkpoints and
resume, the device-resident data store and scan-over-steps, data and graph
parallelism. The JAX-only knobs ``prng_impl`` and ``flat_params`` have no
counterpart here.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from caster_dta_torch.data.batching import BucketedLoader, PairBatch
from caster_dta_torch.device import resolve_device
from caster_dta_torch.interop.from_jax import load_jax_params, to_jax_params
from caster_dta_torch.nn.common import compute_dtype, f32_precision
from caster_dta_torch.train import checkpoints, metrics as metrics_mod
from caster_dta_torch.train.optim import (BATCH_SCHEDULERS, make_optimizer, make_scheduler,
                                          set_learning_rate)

_COMPUTE_DTYPES = {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16,
                   "bf16": torch.bfloat16}

# field: (the value that means "off", the ROADMAP item that ports it)
_NOT_PORTED = {
    "save_state_every": (0, "Queue 1 item 4 (train-state checkpoints and resume)"),
    "resume": (False, "Queue 1 item 4 (train-state checkpoints and resume)"),
    "device_data_budget": (None, "Queue 1 item 2 (the device-resident store)"),
    "scan_steps": (False, "Queue 1 item 2 (scan_steps as a CUDA graph of the step)"),
    "n_dp": (None, "Queue 1 item 11 (multi-device)"),
    "gp": (None, "Queue 1 item 11 (multi-device)"),
}


@dataclass
class TrainConfig:
    """The reference's training constants (train_model.py:392-419), as in
    caster_dta_tpu. The fields after ``print_unscaled_loss`` are not ported
    yet: any value but their default raises NotImplementedError."""

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
    save_state_every: int = 0
    resume: bool = False
    device_data_budget: Optional[int] = None
    scan_steps: bool = False
    n_dp: Optional[int] = None
    gp: Optional[int] = None

    def __post_init__(self):
        for name, (off, item) in _NOT_PORTED.items():
            value = getattr(self, name)
            if value != off and not (name in ("n_dp", "gp") and value == 1):
                raise NotImplementedError(f"TrainConfig.{name}={value!r} is not ported yet: "
                                          f"ROADMAP {item}")
        if self.compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(map(str, _COMPUTE_DTYPES))}")
        if self.grad_accum < 1:
            raise ValueError("grad_accum must be >= 1")


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


class Trainer:
    """Trains ``model`` (a JointGNN) in place on ``device``: the card unless
    the caller passes ``device='cpu'``."""

    def __init__(self, model: torch.nn.Module, config: TrainConfig,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.config = config
        self.model = model.to(self.device)
        self.dtype = _COMPUTE_DTYPES[config.compute_dtype]
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = make_optimizer(config.optimizer, self.params, config.lr,
                                        config.weight_decay)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        self._mini_step = 0
        self._acc: Optional[list] = None

    # ----------------------------------------------------------- params
    def params_tree(self) -> dict:
        """The weights as the JAX package's param tree (numpy, f32)."""
        return to_jax_params(self.model)

    def set_params(self, tree: dict) -> None:
        """Adopt a JAX-format param tree (for example a checkpoint)."""
        load_jax_params(self.model, tree)

    # ------------------------------------------------------------ steps
    def loss(self, batch: PairBatch):
        """(masked loss, pred [B] f32) of a batch on the device, with the
        model in its current mode and the trainer's compute dtype."""
        with f32_precision(), compute_dtype(self.dtype):
            pred, _ = self.model(batch.protein, batch.molecule, return_attention=False,
                                 generator=self.generator)
        pred = pred[:, 0].to(torch.float32)
        w = batch.weight
        loss = torch.sum(w * (pred - batch.target) ** 2) / torch.clamp(w.sum(), min=1.0)
        return loss, pred

    def train_step(self, batch: PairBatch, lr: Optional[float] = None):
        """One training step on ``batch`` at learning rate ``lr`` (the
        config's when None) -> (loss, pred [B] f32), both left on the device
        unsynchronised."""
        batch = batch.to(self.device)
        if not self.model.training:
            self.model.train()
        with f32_precision():
            loss, pred = self.loss(batch)
            grads = torch.autograd.grad(loss, self.params)
            self._apply(list(grads), self.config.lr if lr is None else lr)
        return loss.detach(), pred.detach()

    def _apply(self, grads: list, lr: float) -> None:
        k = self.config.grad_accum
        if k > 1:
            # optax.MultiSteps: running mean acc + (g - acc) / (n + 1); the
            # optimizer sees it on the k-th mini step only
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            n = self._mini_step
            for a, g in zip(self._acc, grads):
                a.add_((g - a) / (n + 1))
            self._mini_step += 1
            if self._mini_step < k:
                return
            grads, self._acc, self._mini_step = self._acc, None, 0
        if self.config.clip_norm is not None:
            grads = clip_by_global_norm(grads, self.config.clip_norm)
        for p, g in zip(self.params, grads):
            p.grad = g
        set_learning_rate(self.optimizer, lr)
        self.optimizer.step()
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def eval_step(self, batch: PairBatch) -> torch.Tensor:
        """Predictions [B] f32 in eval mode (no dropout), on the device."""
        batch = batch.to(self.device)
        if self.model.training:
            self.model.eval()
        with f32_precision(), compute_dtype(self.dtype):
            pred, _ = self.model(batch.protein, batch.molecule, return_attention=False)
        return pred[:, 0].to(torch.float32)

    @torch.no_grad()
    def eval_loss(self, batch: PairBatch) -> torch.Tensor:
        """The masked loss of ``batch`` in eval mode, on the device."""
        if self.model.training:
            self.model.eval()
        return self.loss(batch.to(self.device))[0]

    # ----------------------------------------------------------- epochs
    @staticmethod
    def _batch_losses(preds: list, deferred: list, unscale):
        """Per-batch MSE of the real pairs (after ``unscale``), with the
        predictions fetched from the device in one transfer."""
        host = torch.cat(preds).cpu().numpy() if preds else np.zeros(0, np.float32)
        losses, sizes, out = [], [], []
        start = 0
        for mask, target, pair_idx in deferred:
            pred_np = host[start:start + len(mask)][mask]
            start += len(mask)
            target_np = target[mask]
            if unscale is not None:
                pred_np, target_np = unscale(pred_np), unscale(target_np)
            losses.append(metrics_mod.mse(pred_np, target_np))
            sizes.append(int(mask.sum()))
            out.append((pred_np, target_np, pair_idx[mask]))
        return losses, sizes, out

    def train_epoch(self, loader: BucketedLoader, lr: float, scheduler=None, epoch: int = 0,
                    total_train: int = 0, unscale=None, meter: Optional[ThroughputMeter] = None):
        """One pass over ``loader`` -> (mean unscaled train MSE, lr). A batch
        scheduler steps on the fractional epoch after every batch."""
        n_processed = 0
        preds, deferred = [], []
        for batch in loader:
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
        losses, sizes, _ = self._batch_losses(preds, deferred, unscale)
        return float(np.average(losses, weights=sizes)), lr

    def eval_epoch(self, loader: BucketedLoader, unscale=None):
        """-> (mean unscaled MSE, predictions, targets, pair indices) over the
        real pairs of ``loader``."""
        preds, deferred = [], []
        for batch in loader:
            preds.append(self.eval_step(batch))
            deferred.append(((batch.weight > 0).numpy(), batch.target.numpy(),
                             batch.pair_idx.numpy()))
        losses, sizes, out = self._batch_losses(preds, deferred, unscale)
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
    present, reports losses in the original units."""
    os.makedirs(output_folder, exist_ok=True)
    n_epochs = config.n_epochs if n_epochs is None else n_epochs
    ladder_kwargs = {k: v for k, v in (ladder_kwargs or {}).items() if k in _LADDER_KEYS}
    train_idx, val_idx, test_idx = split_dataset(dataset, config.seed)

    def mk_loader(idxs, shuffle, seed):
        return BucketedLoader(dataset, idxs, max_num=max_num, max_batch_size=max_batch_size,
                              shuffle=shuffle, seed=seed, **ladder_kwargs)

    train_dl = mk_loader(train_idx, True, config.seed)
    val_dl = mk_loader(val_idx, False, config.seed + 1)
    test_dl = mk_loader(test_idx, False, config.seed + 2)

    trainer = Trainer(model, config, device=device)
    if initial_params is not None:
        trainer.set_params(initial_params)
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
    epoch = -1
    for epoch in range(n_epochs):
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
