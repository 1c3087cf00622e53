"""Readings that set the limits of ``correct``: the controls and the planted
faults, computed on the card at a cell's own size, seed by seed, with no
window (the program's own readings come from the benchmark's runs, which
print every number compared).

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> [<n> ...]

For a training cell, on the program's first batches of each seed: the
plain reference in f32 against itself with its matrix products in fp8 (the
control: the step below the configuration's bf16), with half of each batch
left out of the loss (a fault) and with its products' operands rounded to
bf16 (a witness of what bf16 alone reads): over the first two steps from
the seeded weights, and over the step that the program replays first, taken
from the f32 reference's own state before it; and the control's predictions
of the val sample from the seeded weights. For a screening cell, on the
batches a run's first pass checks: the reference in f32 against itself with
TF32 on (the control: the step below f32 with TF32 off) and, with the
explainer, its masks left unmoved (a fault: the state unchanged). One JSON
line a seed and variant on standard output.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def train_readings(cell, seed: int, device) -> list:
    from benchlib import compare, spec

    drv = spec.load_module(os.path.join(HERE, "benchlib", "runners", "train.py"))
    s = drv.setup(cell, seed, device)
    plain = s["plain"]
    before, checked = drv.checked_step_of(s["train_dl"], device.type == "cuda")
    first = before[:drv.CHAIN_STEPS]
    f32 = plain.Precision("f32")
    ref = drv.reference_steps(s, first, device, f32)
    # the f32 reference's own state before the step the program replays first
    lead = ref if len(before) == len(first) else drv.reference_steps(s, before, device, f32)
    names = list(s["weights"])
    params, m, v, t = lead["state"]
    bucket, pairs, weight = checked
    c = {"bucket": bucket, "pairs": pairs, "weight": weight, "lr": s["config"].lr,
         "before": {"params": params, "m": m, "v": v, "t": t}, "generator": lead["generator"]}
    del lead
    base = drv.checked_reference(s, c, device, f32)
    val_pairs = s["val_idx"]
    pos = drv.val_sample(seed, val_pairs, s["traffic"], cell.mix["check"]["val_pairs"])
    ids = [int(val_pairs[i]) for i in pos]
    val_ref = drv.reference_predictions(s, s["weights"], ids, device, f32)
    out = []
    for variant, precision, half in (("fp8", "fp8", False), ("half_batch", "f32", True),
                                     ("bf16", "bf16", False)):
        got = drv.reference_steps(s, first, device, plain.Precision(precision), half)
        grad_norm = {k: float(g.norm()) for k, g in got["grad"].items()}
        nums = drv.step_numbers(got["loss"], grad_norm, got["change"][-1], ref)
        ref_grad = {k: float(g.norm()) for k, g in ref["grad"].items()}
        nums["grad_norm_worst_leaf"] = compare.worst_leaf(grad_norm, ref_grad)
        moved = compare.moved_entries(ref["grad"])
        pc = compare.masked_norms(got["change"][-1], moved)
        rc = compare.masked_norms(ref["change"][-1], moved)
        nums["change_median_leaf"] = compare.median_leaf(pc, rc)
        print(f"seed {seed} {variant}:", file=sys.stderr)
        drv.leaf_report("change", pc, rc)
        one = drv.checked_reference(s, c, device, plain.Precision(precision), half)
        replay = drv.checked_numbers(one["loss"][0], {k: one["grad"][k] for k in names},
                                     {k: one["change"][0][k] for k in names}, base)
        nums["loss_rel"] = max(nums["loss_rel"], replay.pop("replay_loss_rel"))
        nums.update(replay)
        if variant == "fp8":
            val = drv.reference_predictions(s, s["weights"], ids, device, plain.Precision("fp8"))
            nums["val_pred_abs"] = compare.max_abs([(val, val_ref)])
        out.append({"variant": variant, "replayed_step": len(before) + 1, **nums})
    return out


def screen_readings(cell, seed: int, device) -> list:
    from benchlib import spec

    drv = spec.load_module(os.path.join(HERE, "benchlib", "runners", "screen.py"))
    s = drv.setup(cell, seed, device)
    mix = cell.mix
    do_ex, epochs = bool(mix["explainer"]["on"]), int(mix["explainer"]["epochs"])
    handed = [(b.bucket, b.pair_idx.numpy().copy(), b.weight.numpy().copy())
              for b in s["make_loader"]()]
    chosen = drv.picks(seed, 0, handed, mix["check"]["batches_per_pass"])
    variants = [("tf32", "tf32", False)] + ([("frozen", "f32", True)] if do_ex else [])
    refs = {v[0]: {} for v in variants}
    base = {}
    for j in sorted(chosen):
        bucket, pair_ids, weight = handed[j]
        args = (s["plain"], s["kw"], s["weights"], s["traffic"], bucket, pair_ids, weight, do_ex,
                epochs)
        base.update({(j, i): a for i, a in drv.reference_records(
            *args, s["plain"].Precision("f32")).items()})
        for name, precision, frozen in variants:
            refs[name].update({(j, i): a for i, a in drv.reference_records(
                *args, s["plain"].Precision(precision), frozen=frozen).items()})
    return [{"variant": name, **drv.record_numbers(refs[name], base, do_ex)}
            for name, _, _ in variants]


def main(argv=None) -> int:
    import torch

    from benchlib import spec

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    device = torch.device(args.device)
    read = train_readings if cell.mix["runner"] == "train" else screen_readings
    for seed in args.seeds:
        for row in read(cell, seed, device):
            print(json.dumps({"workload": args.workload, "seed": seed, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
