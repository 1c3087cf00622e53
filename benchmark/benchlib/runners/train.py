"""Runner of the training mixes: the body of ``fit``'s epoch loop (a train
pass over the device-resident store, then a val pass; no checkpoint
writes) through the port's ``Trainer``, closed loop.

Set-up: the traffic and the weights from the seed, the loaders and their
device stores, the trainer, and one whole epoch, train and val, which runs
every bucket's warm-up steps and captures its train and eval graphs. The
window then runs whole epochs until ``--seconds`` have passed and counts
the real training pairs whose steps it completed.

Correctness, after the window, against the plain reference in f32:

* the start: the reference follows the program's first two steps (eager on
  every device: the first bucket's warm-up) from the seeded weights, its own
  dropout generator seeded as the trainer's, and compares each step's loss,
  the first gradient's norm by leaf (from Adam's first moment after one
  step) and each leaf's change after the two;
* a replayed step: set-up's first train step that runs as a CUDA graph
  replay (the third step where nothing is captured, as on the CPU) is read
  around, synchronised: the weights, Adam's moments and step count and the
  dropout generator's state before it, the weights and first moment after
  it. The reference takes the same step from that state and compares its
  loss, its gradient (the program's worked out from the two first moments)
  and each leaf's change in that step;
* the window's last val pass, a replay of each bucket's eval graph, on a
  sample of val pairs: the reference's predictions from the program's final
  weights. This judges the eval graphs, not the training that made the
  weights (the reference cannot follow the window's every step).
"""
from __future__ import annotations

import contextlib
import gc
import sys
from collections import defaultdict

import numpy as np
import torch

from benchlib import batches, compare, flops, model as model_mod, probe, traffic as traffic_mod
from benchlib.peaks import PEAKS, peak_key

# steps of the first window epoch that the traced slice profiles (at least)
TRACE_STEPS = 16
# the first steps, followed by the reference from the seed; and the step
# checked from the program's own state where nothing is captured
CHAIN_STEPS = 2
EAGER_CHECKED_STEP = 3


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Recorder:
    """Wraps the trainer's megabatch calls, its optimizer's step and, during
    set-up, the captured steps' replays, to keep what the check and the
    trace need; the program runs unchanged."""

    def __init__(self, ctx, trainer, weights: dict, opbytes):
        from caster_dta_torch.train import graphs

        self.ctx, self.trainer, self.opbytes = ctx, trainer, opbytes
        self.first: list = []          # (bucket, pair rows, weights, loss) of the first steps
        self.grad_norm = self.change = None
        self.checked = None            # the step checked from the program's own state
        self.slice = probe.Slice() if ctx.traced else None
        self.in_window = False
        self.slice_steps: dict = defaultdict(int)
        self.batch_size: dict = {}
        self._calls = self._steps_done = 0
        self._mega = None
        self._names = [n for n, p in trainer.model.named_parameters() if p.requires_grad]
        self._w0 = weights
        self._train, self._eval = trainer.train_megabatch, trainer.eval_megabatch
        trainer.train_megabatch, trainer.eval_megabatch = self.train_megabatch, self.eval_megabatch
        self._hook = trainer.optimizer.register_step_post_hook(self.after_step)
        self._graphs = graphs
        self._run = graphs.CapturedStep.run
        graphs.CapturedStep.run = self._wrap_run(self._run)

    def train_megabatch(self, mega, lrs):
        self.opbytes.key = ("train", mega.bucket)
        s = self.slice
        if s is not None and self.in_window and not s.done and not s.active:
            s.start()
        self._mega = mega
        try:
            with (s.span("train_megabatch") if s is not None else contextlib.nullcontext()):
                losses, preds = self._train(mega, lrs)
        finally:
            self._mega = None
        for j in range(min(EAGER_CHECKED_STEP - len(self.first), mega.n_steps)):
            self.first.append((mega.bucket, mega.pair_idx[j].copy(), mega.weight[j].copy(),
                               losses[j].detach().clone()))
        c = self.checked
        if c is not None and c["loss"] is None:
            if c["replayed"]:
                c["loss"] = float(losses[c["j"]])
            else:
                b, p, w, loss = self.first[EAGER_CHECKED_STEP - 1]
                c.update(bucket=b, pairs=p, weight=w, loss=float(loss))
        self._steps_done += mega.n_steps
        if s is not None and s.active:
            self.slice_steps[mega.bucket] += mega.n_steps
            self.batch_size[mega.bucket] = mega.p_rows.shape[1]
            if sum(self.slice_steps.values()) >= TRACE_STEPS:
                s.stop()
        return losses, preds

    def eval_megabatch(self, mega):
        self.opbytes.key = ("eval", mega.bucket)
        return self._eval(mega)

    def _state(self) -> dict:
        """The trainable weights, Adam's moments and its step count, by name."""
        opt, params = self.trainer.optimizer, self.trainer.params
        st = [opt.state[p] for p in params]
        return {"params": {n: p.detach().clone() for n, p in zip(self._names, params)},
                "m": {n: x["exp_avg"].clone() for n, x in zip(self._names, st)},
                "v": {n: x["exp_avg_sq"].clone() for n, x in zip(self._names, st)},
                "t": int(float(st[0]["step"]))}

    def _wrap_run(self, run):
        """CapturedStep.run, with set-up's first replay of a train step read
        around: synchronised, the state before and after it."""
        rec = self

        def wrapped(entry, row, variant=True):
            mega = rec._mega
            if rec.checked is not None or mega is None:
                return run(entry, row, variant)
            _sync(row.device)
            before, gen = rec._state(), rec.trainer.generator.get_state()
            out = run(entry, row, variant)
            _sync(row.device)
            after = rec._state()
            j = rec._step_of(mega, row)
            rec.checked = {"index": rec._steps_done + j + 1, "j": j, "replayed": True,
                           "bucket": mega.bucket, "pairs": mega.pair_idx[j].copy(),
                           "weight": mega.weight[j].copy(),
                           "lr": float(row[0].view(torch.float32)), "before": before,
                           "generator": gen, "after": after, "loss": None}
            return out
        return wrapped

    def _step_of(self, mega, row) -> int:
        """The step of ``mega`` whose packed inputs ``row`` holds."""
        from caster_dta_torch.data.device_cache import FIELD_ALIGN

        fields = self._graphs.pack_rows(mega.p_rows, mega.m_rows, mega.target,
                                        mega.weight)[:, FIELD_ALIGN:]
        hit = np.flatnonzero((fields == row[FIELD_ALIGN:].cpu().numpy()).all(axis=1))
        if len(hit) != 1:
            raise RuntimeError(f"a replayed row matches {len(hit)} steps of its megabatch")
        return int(hit[0])

    def after_step(self, opt, args, kwargs) -> None:
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            return
        self._calls += 1
        params = self.trainer.params
        if self._calls == 1:
            b1 = opt.defaults["betas"][0]
            self.grad_norm = torch.stack([opt.state[p]["exp_avg"].norm()
                                          for p in params]) / (1 - b1)
        elif self._calls == CHAIN_STEPS:
            self.change = {n: p.detach() - self._w0[n] for n, p in zip(self._names, params)}
        # where nothing is captured, the step checked from the program's state
        # is the third, read around by this hook
        if self.ctx.device.type == "cuda" or self.checked is not None:
            return
        if self._calls == EAGER_CHECKED_STEP - 1:
            self._before = (self._state(), self.trainer.generator.get_state())
        elif self._calls == EAGER_CHECKED_STEP:
            before, gen = self._before
            self.checked = {"index": EAGER_CHECKED_STEP, "replayed": False, "before": before,
                            "generator": gen, "after": self._state(), "loss": None,
                            "lr": float(np.float32(self.trainer.config.lr))}

    def set_up_done(self) -> None:
        """The window starts: no more steps to read."""
        self._hook.remove()
        self._graphs.CapturedStep.run = self._run
        self.in_window = True


def setup(cell, seed: int, device, mark=lambda phase: None) -> dict:
    """The run's traffic, weights, dataset, train config and loaders (with
    their device stores), from the seed; ``mark`` is told each phase's end."""
    from caster_dta_torch.data.batching import BucketedLoader, PairDataset
    from caster_dta_torch.data.device_cache import DeviceResidentLoader
    from caster_dta_torch.train.loop import TrainConfig, split_dataset

    mix, conf = cell.mix, cell.config
    kw = conf["model_kwargs"]
    plain = cell.reference()
    traffic = traffic_mod.generate(mix, seed)
    mark("traffic")
    weights = model_mod.make_weights(plain.param_shapes(kw), seed, device)
    mark("weights (the card's context)")
    dataset = PairDataset(traffic.proteins, traffic.molecules, traffic.pairs, traffic.targets,
                          scale_output=mix["scale_output"])
    tm = mix["train"]
    config = TrainConfig(lr=tm["lr"], optimizer=tm["optimizer"], seed=seed,
                         compute_dtype=conf["train_compute_dtype"],
                         device_data_budget=tm["device_data_budget"], scan_steps=True,
                         save_state_every=0)
    train_idx, val_idx, _ = split_dataset(dataset, config.seed, tuple(mix["split"]))
    budget = mix["budget"]

    def loader(idx, shuffle, s):
        dl = BucketedLoader(dataset, idx, max_num=budget["max_num"],
                            max_batch_size=budget["max_batch_size"], shuffle=shuffle, seed=s)
        dl = DeviceResidentLoader.maybe(dl, config.device_data_budget, device=device)
        if not isinstance(dl, DeviceResidentLoader):
            raise RuntimeError("the mix's stores exceed the device budget")
        return dl

    return dict(plain=plain, kw=kw, traffic=traffic, weights=weights, dataset=dataset,
                config=config, train_idx=train_idx, val_idx=val_idx,
                train_dl=loader(train_idx, True, config.seed),
                val_dl=loader(val_idx, False, config.seed + 1))


def reference_steps(s: dict, first: list, device, precision, half_batch: bool = False) -> dict:
    """The plain reference's steps on the program's first batches ((bucket,
    pair rows, weights) each), from the seeded weights and dropout."""
    t_std = s["dataset"].affinity_data
    steps = [batches.reference_batch(s["traffic"], p, b, device, t_std[p], w)
             for b, p, w in first]
    return s["plain"].train_steps(s["kw"], s["weights"], steps, s["config"].lr, s["config"].seed,
                                  precision, half_batch)


def step_numbers(losses, grad_norm: dict, change: dict, ref: dict) -> dict:
    """The numbers compared for the first steps: each step's loss (relative);
    the first gradient's norm by the median leaf (its worst leaf, which bf16
    reads at a tenth on every seed, is printed, not compared: PERF.md); the
    change after the steps by the worst leaf, over the entries the
    reference's first gradient moves (``change`` is each leaf's change, as
    tensors)."""
    moved = compare.moved_entries(ref["grad"])
    ref_grad = {k: float(g.norm()) for k, g in ref["grad"].items()}
    prog, refc = compare.masked_norms(change, moved), compare.masked_norms(ref["change"][-1], moved)
    return {"loss_rel": compare.rel_gap(losses, ref["loss"]),
            "grad_norm_rel": compare.median_leaf(grad_norm, ref_grad),
            "change_rel": compare.worst_leaf(prog, refc)}


def checked_reference(s: dict, c: dict, device, precision, half_batch: bool = False) -> dict:
    """The reference's one step from the state ``c`` holds before the
    checked step (weights, Adam's moments and step count, the dropout
    generator's state), on the same pairs padded to the same bucket."""
    t_std = s["dataset"].affinity_data
    params = dict(s["weights"])
    params.update(c["before"]["params"])
    batch = batches.reference_batch(s["traffic"], c["pairs"], c["bucket"], device,
                                    t_std[c["pairs"]], c["weight"])
    state = (c["before"]["m"], c["before"]["v"], c["before"]["t"])
    return s["plain"].train_steps(s["kw"], params, [batch], c["lr"], s["config"].seed,
                                  precision, half_batch, state=state,
                                  generator_state=c["generator"])


def checked_numbers(loss: float, grad: dict, change: dict, ref: dict) -> dict:
    """The numbers compared for the step checked from the program's state:
    its loss (relative), its gradient's norm by the median leaf and its
    change by the worst leaf over the entries the reference's gradient of
    that step moves (``grad`` and ``change`` as tensors, by leaf)."""
    ref_grad = {k: g for k, g in ref["grad"].items() if k in grad}
    moved = compare.moved_entries(ref_grad)
    return {"replay_loss_rel": compare.rel_gap([loss], ref["loss"]),
            "replay_grad_rel": compare.median_leaf(
                {k: float(g.norm()) for k, g in grad.items()},
                {k: float(g.norm()) for k, g in ref_grad.items()}),
            "replay_change_rel": compare.worst_leaf(
                compare.masked_norms(change, moved),
                compare.masked_norms({k: ref["change"][0][k] for k in change}, moved))}


def program_step(c: dict, b1: float) -> tuple:
    """The checked step as the program took it: each leaf's gradient, from
    Adam's first moment before and after (m' = b1 m + (1 - b1) g), and its
    change."""
    before, after = c["before"], c["after"]
    grad = {k: (after["m"][k] - b1 * before["m"][k]) / (1 - b1) for k in before["m"]}
    change = {k: after["params"][k] - before["params"][k] for k in before["params"]}
    return grad, change


def leaf_report(label: str, prog: dict, ref: dict) -> None:
    """The four leaves with the widest gaps of a norm, on standard error."""
    floor = max(float(np.median(list(ref.values()))), 1e-30)
    worst = sorted(ref, key=lambda n: -abs(prog[n] - ref[n]) / max(ref[n], floor))[:4]
    print(f"{label} worst leaves (median {floor:.6g}): " + "; ".join(
        f"{n} {prog[n]:.6g} vs {ref[n]:.6g}" for n in worst), file=sys.stderr)


def checked_step_of(train_dl, on_card: bool) -> tuple:
    """(the steps before it, the checked step) of a fresh store loader's first
    epoch, as (bucket, pair rows, weights) each: the first step that the
    trainer replays on the card (a bucket's step after its
    graphs.WARMUP_STEPS eager ones), the third elsewhere."""
    from caster_dta_torch.train import graphs

    steps = []
    for mega, _ in train_dl.iter_megabatches():
        for j in range(mega.n_steps):
            step = (mega.bucket, mega.pair_idx[j].copy(), mega.weight[j].copy())
            if (j == graphs.WARMUP_STEPS) if on_card else (len(steps) == EAGER_CHECKED_STEP - 1):
                return steps, step
            steps.append(step)
    raise RuntimeError("no step of the first epoch is replayed")


def val_sample(seed: int, val_pairs, traffic, n: int) -> list:
    """Positions of the val pairs to check: ``n`` drawn from the seed and the
    pair of the largest protein."""
    rng = np.random.default_rng([seed, 7])
    pos = set(rng.choice(len(val_pairs), min(n, len(val_pairs)), replace=False).tolist())
    pos.add(int(np.argmax([traffic.proteins[traffic.pairs[int(i)][0]]["n_nodes"]
                           for i in val_pairs])))
    return sorted(pos)


def reference_predictions(s: dict, params: dict, pair_ids: list, device, precision) -> np.ndarray:
    """The reference's eval-mode predictions of ``pair_ids`` (16 a batch)."""
    out = []
    for k in range(0, len(pair_ids), 16):
        ids = pair_ids[k:k + 16]
        rb = batches.reference_batch(s["traffic"], ids, batches.fit_bucket(s["traffic"], ids),
                                     device)
        out.append(s["plain"].predict(s["kw"], params, rb["protein"], rb["molecule"],
                                      precision)[0].cpu().numpy())
    return np.concatenate(out)


def run(ctx) -> None:
    from caster_dta_torch.train.loop import Trainer

    cell, device, seed = ctx.cell, ctx.device, int(ctx.args.seed)
    s = setup(cell, seed, device, ctx.mark)
    ctx.mark("loaders, stores")
    plain, kw, config, weights = s["plain"], s["kw"], s["config"], s["weights"]
    model = model_mod.port_model(kw, weights, device)
    train_dl, val_dl = s.pop("train_dl"), s.pop("val_dl")
    trainer = Trainer(model, config, device=device)
    peak = PEAKS[peak_key(trainer.dtype)]
    b1 = trainer.optimizer.defaults["betas"][0]
    opbytes = probe.OpBytes()
    if ctx.traced:
        opbytes.install()
    rec = Recorder(ctx, trainer, weights, opbytes)
    ctx.mark("model, trainer")

    lr = config.lr
    try:
        trainer.train_epoch(train_dl, lr)      # set-up: every bucket warmed and captured
        ctx.mark("set-up train pass")
        trainer.eval_epoch(val_dl)
        _sync(device)
        ctx.mark("set-up val pass")
    finally:
        rec.set_up_done()
    ctx.window_start()
    pairs = epochs = 0
    while True:
        trainer.train_epoch(train_dl, lr)
        _, val_pred, _, val_pairs = trainer.eval_epoch(val_dl)
        pairs += len(s["train_idx"])
        epochs += 1
        if ctx.elapsed() >= ctx.seconds:
            break
    ctx.window_end()
    ctx.measure.update(pairs=pairs, epochs=epochs)
    ctx.attempted = pairs
    if device.type == "cuda":
        ctx.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    opbytes.remove()

    final = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    first = [(b, p, w) for b, p, w, _ in rec.first[:CHAIN_STEPS]]
    losses = [float(x[3]) for x in rec.first[:CHAIN_STEPS]]
    names = rec._names
    grad_norm = dict(zip(names, rec.grad_norm.tolist()))
    change, checked = rec.change, rec.checked
    slice_ = rec.slice
    slice_steps, batch_size = dict(rec.slice_steps), dict(rec.batch_size)
    del trainer, model, train_dl, val_dl, rec
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference follows the first steps from the seed
    f32 = plain.Precision("f32")
    ref = reference_steps(s, first, device, f32)
    nums = step_numbers(losses, grad_norm, change, ref)
    ref_grad = {k: float(g.norm()) for k, g in ref["grad"].items()}
    print(f"grad_norm worst leaf: {compare.worst_leaf(grad_norm, ref_grad)!r}", file=sys.stderr)
    leaf_report("grad", grad_norm, ref_grad)
    moved = compare.moved_entries(ref["grad"])
    prog_c, ref_c = compare.masked_norms(change, moved), compare.masked_norms(ref["change"][-1],
                                                                             moved)
    ctx.measure["unmoved_leaves"] = sorted(set(names) - set(ref_c))
    print(f"change median leaf: {compare.median_leaf(prog_c, ref_c)!r}", file=sys.stderr)
    leaf_report("change", prog_c, ref_c)

    # the replayed step, from the program's own state before it
    if checked is None:
        print("no step was replayed in set-up", file=sys.stderr)
        nums.update(replay_loss_rel=float("inf"), replay_grad_rel=float("inf"),
                    replay_change_rel=float("inf"))
    else:
        rc = checked_reference(s, checked, device, f32)
        grad, step_change = program_step(checked, b1)
        replay = checked_numbers(checked["loss"], grad, step_change, rc)
        nums["loss_rel"] = max(nums["loss_rel"], replay.pop("replay_loss_rel"))
        nums.update(replay)
        moved = compare.moved_entries({k: rc["grad"][k] for k in grad})
        pc = compare.masked_norms(step_change, moved)
        rcc = compare.masked_norms({k: rc["change"][0][k] for k in step_change}, moved)
        print(f"replayed step: global step {checked['index']} (bucket {checked['bucket']}, "
              f"{'replayed' if checked['replayed'] else 'eager: nothing captured'}); "
              f"loss {checked['loss']!r} vs {rc['loss'][0]!r}; change median leaf "
              f"{compare.median_leaf(pc, rcc)!r}", file=sys.stderr)
        leaf_report("replay grad", {k: float(g.norm()) for k, g in grad.items()},
                    {k: float(rc["grad"][k].norm()) for k in grad})
        leaf_report("replay change", pc, rcc)
        del rc, grad, step_change
    for name, value in nums.items():
        ctx.check(name, value)
    del checked

    # the window's last val pass (the eval graphs' replays), on a sample of its pairs
    pos = val_sample(seed, val_pairs, s["traffic"], cell.mix["check"]["val_pairs"])
    ref_pred = reference_predictions(s, final, [int(val_pairs[i]) for i in pos], device, f32)
    ctx.check("val_pred_abs", compare.max_abs([(val_pred[pos], ref_pred)]))

    if slice_ is not None:
        slice_.finish()
    if slice_ is not None and slice_.summary is not None:
        total = sum(slice_steps.values())
        step_flops = {b: flops.train_step(kw, b, batch_size[b]) for b in slice_steps}
        ctx.trace.update(
            slice=slice_.summary, steps=total,
            flops=sum(step_flops[b] * k for b, k in slice_steps.items()),
            peak_flops=peak,
            seg_bytes=sum(opbytes.bytes.get(("train", b), 0) * k
                          for b, k in slice_steps.items()))
