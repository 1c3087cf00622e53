"""Runner of the screening mixes: one caller runs the port's inference entry
(``evaluate_batches``, the loop of ``run_model_on_dataset``) over the
loader's batches, closed loop, with or without the explainer.

Set-up: the traffic and the weights from the seed, the model in eval mode,
a BucketedLoader (no shuffle, as ``run_model_on_dataset`` builds it), and
one batch of every bucket through the entry, which captures the bucket's
forward and, with the explainer, its loops. The window then runs pass after
pass until ``--seconds`` have passed, each pass as ``run_model_on_dataset``
runs: a fresh loader (its pad cache empty) and one ``evaluate_batches`` call
over a generator of its batches, which stops handing batches once the time
is up. So every pass does the same work, and the pairs' order, drawn from
the seed, mixes the buckets in any part of a pass. A batch's time runs from
its hand-over to the entry asking for the next one, when its records are on
the host.

Correctness: batches drawn from the seed in every pass (the batch of the
largest protein bucket always among them) keep their records; after the
window the reference pads the same pairs to the same bucket and computes
affinities, attention maps and, with the explainer, its masks from the same
initial logits, and the records are compared with them. A pair handed over
whose record never came back is a failure.
"""
from __future__ import annotations

import contextlib
import gc
import os
import sys
import time

import numpy as np
import torch

from benchlib import batches, compare, flops, model as model_mod, probe, traffic as traffic_mod
from benchlib.peaks import PEAKS, peak_key
from benchlib.spec import BENCH_DIR, load_module

ATT = ("prot_mol_attention", "mol_prot_attention")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _initial_logits(shape: tuple, which: int, device) -> torch.Tensor:
    jr = load_module(os.path.join(BENCH_DIR, "reference", "jax_random.py"), "bench_jax_random")
    key = jr.split(jr.prng_key(0))[which]
    return torch.from_numpy(np.float32(0.1) * jr.normal(key, shape)).to(device)


def _softmax(x):
    e = np.exp(x - x.max())
    return e / e.sum()


def setup(cell, seed: int, device, mark=lambda phase: None) -> dict:
    """The run's traffic, weights, dataset and a maker of its loaders (one a
    pass, as ``run_model_on_dataset`` builds it), from the seed; ``mark`` is
    told each phase's end."""
    from caster_dta_torch.data.batching import BucketedLoader, PairDataset

    kw = cell.config["model_kwargs"]
    plain = cell.reference()
    traffic = traffic_mod.generate(cell.mix, seed)
    mark("traffic")
    weights = model_mod.make_weights(plain.param_shapes(kw), seed, device)
    mark("weights (the card's context)")
    dataset = PairDataset(traffic.proteins, traffic.molecules, traffic.pairs, traffic.targets)
    budget = cell.mix["budget"]

    def make_loader():
        return BucketedLoader(dataset, max_num=budget["max_num"],
                              max_batch_size=budget["max_batch_size"], shuffle=False)

    return dict(plain=plain, kw=kw, traffic=traffic, weights=weights, dataset=dataset,
                make_loader=make_loader)


def picks(seed: int, pass_no: int, handed: list, per_pass: int) -> set:
    """Positions of a pass's batches whose records are checked: drawn from the
    seed, and in the first pass the batch of the largest protein bucket."""
    if not handed:
        return set()
    rng = np.random.default_rng([seed, 11, pass_no])
    out = set(rng.choice(len(handed), min(per_pass, len(handed)), replace=False).tolist())
    if pass_no == 0:
        out.add(int(np.argmax([b[0][0] for b in handed])))
    return out


def run(ctx) -> None:
    from caster_dta_torch.inference.evaluation import evaluate_batches

    cell, device, seed = ctx.cell, ctx.device, int(ctx.args.seed)
    mix = cell.mix
    s = setup(cell, seed, device, ctx.mark)
    plain, kw, traffic, weights, dataset, make_loader = (
        s[k] for k in ("plain", "kw", "traffic", "weights", "dataset", "make_loader"))
    model = model_mod.port_model(kw, weights, device).eval()
    peak = PEAKS[peak_key(next(model.parameters()).dtype)]
    do_ex, epochs = bool(mix["explainer"]["on"]), int(mix["explainer"]["epochs"])
    opbytes = probe.OpBytes()
    if ctx.traced:
        opbytes.install()
    sl = probe.Slice() if ctx.traced else None
    spans = _Spans(sl) if sl is not None else None
    trace_from, trace_batches = mix["trace"]["from_batch"], mix["trace"]["batches"]

    # set-up: the first batch of every bucket through the entry
    loader = make_loader()
    n_buckets = len(loader.buckets())
    warm = {}
    for batch in loader:
        warm.setdefault(batch.bucket, batch)
        if len(warm) == n_buckets:
            break

    def keyed(items):
        for batch in items:
            opbytes.key = ("batch", batch.bucket)
            yield batch

    ctx.mark("model, loader")
    evaluate_batches(model, dataset, keyed(warm.values()), do_ex, epochs)
    del warm, loader
    _sync(device)
    ctx.mark("a batch of every bucket")

    latencies, loader_s, kept = [], [], []
    handed_total = done = missing = 0
    sizes = {}                               # bucket -> batch size
    traced_batches: list = []
    n_handed = 0
    ctx.window_start()
    pass_no = 0
    while ctx.elapsed() < ctx.seconds:
        handed = []

        def hand():
            nonlocal n_handed
            t0, it = time.perf_counter(), None      # the loader's making counts as its first
            while ctx.elapsed() < ctx.seconds:
                with (sl.span("loader_next") if sl is not None else contextlib.nullcontext()):
                    it = iter(make_loader()) if it is None else it
                    batch = next(it, None)
                loader_s.append(time.perf_counter() - t0)
                if batch is None:
                    return
                if sl is not None and not sl.done and n_handed == trace_from:
                    sl.start()
                handed.append((batch.bucket, batch.pair_idx.numpy().copy(),
                               batch.weight.numpy().copy()))
                sizes[batch.bucket] = batch.weight.shape[0]
                if sl is not None and sl.active:
                    traced_batches.append(batch.bucket)
                t_hand = time.perf_counter()
                yield batch
                latencies.append(time.perf_counter() - t_hand)
                n_handed += 1
                if sl is not None and sl.active and len(traced_batches) >= trace_batches:
                    sl.stop()
                t0 = time.perf_counter()

        records = evaluate_batches(model, dataset, hand(), do_ex, epochs)
        if ctx.elapsed() >= ctx.seconds:
            ctx.window_end()
        got = {int(i): j for j, i in enumerate(records["pair_idx"])}
        done += len(got)
        chosen = picks(seed, pass_no, handed, mix["check"]["batches_per_pass"])
        for j, (bucket, pair_ids, weight) in enumerate(handed):
            real = [int(i) for i, w in zip(pair_ids, weight) if w > 0]
            handed_total += len(real)
            missing += sum(i not in got for i in real)
            if j in chosen:
                kept.append((bucket, pair_ids, weight, {
                    i: {k: records[k][got[i]] for k in records} for i in real if i in got}))
        pass_no += 1
    if ctx.window_t1 is None:
        ctx.window_end()
    ctx.attempted, ctx.failed = handed_total, missing
    ctx.measure.update(pairs=done, batch_s=latencies, loader_s=loader_s, passes=pass_no)
    thirds = [np.median(x) * 1e3 for x in np.array_split(np.asarray(latencies), 3) if len(x)]
    print(f"screen: {len(latencies)} batches in the window, {done} pairs, {pass_no} passes; "
          f"median batch ms by third of the window {[round(t, 2) for t in thirds]}; loader ms "
          f"{np.mean(loader_s) * 1e3:.2f}", file=sys.stderr)
    if device.type == "cuda":
        ctx.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    opbytes.remove()
    if spans is not None:
        spans.remove()
    del model, s
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    check(ctx, plain, kw, weights, traffic, kept, do_ex, epochs)
    if sl is not None:
        sl.finish()
    if sl is not None and sl.summary is not None:
        per = {b: flops.forward(kw, b, sizes[b])
               + (flops.explain(kw, b, sizes[b], epochs) if do_ex else 0)
               for b in set(traced_batches)}
        ctx.trace.update(slice=sl.summary, batches=len(traced_batches),
                         flops=sum(per[b] for b in traced_batches),
                         peak_flops=peak,
                         seg_bytes=sum(opbytes.bytes.get(("batch", b), 0) for b in traced_batches))


def reference_records(plain, kw, weights, traffic, bucket, pair_ids, weight, do_ex: bool,
                      epochs: int, precision, frozen: bool = False) -> dict:
    """The reference's answer for each real pair of one batch, in the
    records' form: pair -> affinity, both attention maps trimmed to the real
    lengths, and with the explainer the node masks softmaxed over the real
    nodes and the edge masks of the real edges."""
    device = next(iter(weights.values())).device
    rb = batches.reference_batch(traffic, [int(i) for i in pair_ids], bucket, device)
    score, w_rd, w_dr = (t.cpu().numpy() for t in plain.predict(kw, weights, rb["protein"],
                                                                 rb["molecule"], precision))
    masks = None
    if do_ex:
        init = {(side, kind): _initial_logits(tuple(rb[side][f"{kind}_mask"].shape), j, device)
                for side in ("protein", "molecule") for j, kind in enumerate(("node", "edge"))}
        masks = {k: v.cpu().numpy() for k, v in plain.explain(
            kw, weights, rb["protein"], rb["molecule"], init, precision, n_epochs=epochs,
            frozen=frozen).items()}
    out = {}
    for k, (i, w) in enumerate(zip(pair_ids, weight)):
        if w == 0:
            continue
        plen = int(rb["protein"]["node_mask"][k].sum())
        mlen = int(rb["molecule"]["node_mask"][k].sum())
        r = {"affinity_score": float(score[k]), "prot_mol_attention": w_dr[k][:mlen, :plen],
             "mol_prot_attention": w_rd[k][:plen, :mlen]}
        if masks is not None:
            for side, n_len in (("protein", plen), ("molecule", mlen)):
                e_len = int(rb[side]["edge_mask"][k].sum())
                r[f"{side}_explanation"] = _softmax(masks[side][k][:n_len])
                r[f"{side}_edge_explanation"] = masks[f"{side}_edges"][k][:e_len]
        out[int(i)] = r
    return out


def record_numbers(recs: dict, refs: dict, do_ex: bool) -> dict:
    """The numbers compared: the largest affinity and attention gaps, the
    explanations' (node: against the pair's largest reference entry), and the
    reference's pairs with no record."""
    aff = att = node = edge = 0.0
    lost = 0
    for i, ref in refs.items():
        r = recs.get(i)
        if r is None:
            lost += 1
            continue
        aff = max(aff, abs(r["affinity_score"] - ref["affinity_score"]))
        att = max(att, compare.max_abs([(r[k], ref[k]) for k in ATT]))
        if do_ex:
            for side in ("protein", "molecule"):
                e = ref[f"{side}_explanation"]
                node = max(node, compare.max_abs([(r[f"{side}_explanation"], e)]) / float(e.max()))
                edge = max(edge, compare.max_abs([(r[f"{side}_edge_explanation"],
                                                   ref[f"{side}_edge_explanation"])]))
    out = {"affinity_abs": aff, "attention_abs": att}
    if do_ex:
        out.update(explain_node_rel=node, explain_edge_abs=edge)
    out["lost_records"] = float(lost)
    return out


def check(ctx, plain, kw, weights, traffic, kept, do_ex, epochs) -> None:
    """The kept batches' records against the reference's answers."""
    recs, refs = {}, {}
    for n, (bucket, pair_ids, weight, got) in enumerate(kept):
        ans = reference_records(plain, kw, weights, traffic, bucket, pair_ids, weight, do_ex,
                                epochs, plain.Precision("f32"))
        refs.update({(n, i): a for i, a in ans.items()})
        recs.update({(n, i): r for i, r in got.items()})
    for name, value in record_numbers(recs, refs, do_ex).items():
        ctx.check(name, value)


class _Spans:
    """Host spans around the entry's layers in the traced slice: the
    replayed forward, the explainer and the record building (the port's
    functions wrapped from here while the run lasts, not edited)."""

    def __init__(self, sl):
        from caster_dta_torch.inference import evaluation, explain, replay

        self._saved = []
        for owner, name, label in ((replay.ReplayedForward, "__call__", "entry.replayed_forward"),
                                   (explain.DTAModelExplainer, "explain_model", "entry.explain"),
                                   (evaluation, "_add_rows", "entry.records")):
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))

            def wrapped(*a, _fn=fn, _label=label, **k):
                with sl.span(_label):
                    return _fn(*a, **k)
            setattr(owner, name, wrapped)

    def remove(self) -> None:
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
