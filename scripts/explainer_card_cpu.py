#!/usr/bin/env python3
"""How far the explainer's masks on the card lie from the CPU's, step by step.

    python3 scripts/explainer_card_cpu.py [--batches 2] [--steps 1 2 5 10]
                                          [--analysis [--seeds 19 20 ...]]

Runs caster_dta_torch's DTAModelExplainer with the runs/davis_seed9 weights
on the first batches of chip_smoke.py's evaluate set (seeded synthetic pairs
of Davis-like size, batches of 8), or with ``--analysis`` on those of its
analysis phase's BioLIP pairs (chip_smoke.analysis_inputs made from each of
``--seeds``, batches of 16), on the card and on the CPU, for each number of
Adam steps in ``--steps``, and prints the largest difference of the node and
edge masks of each tower, then the largest of each over every batch at the
last number of steps. For the first step it also prints the gradient of the
loss with respect to the edge logits on both devices: the largest
difference against the largest entry, and the largest relative difference
over the entries, since Adam divides each entry by its own running norm.
Needs the card.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402
from caster_dta_torch.data.batching import BucketedLoader, synthetic_pair_dataset  # noqa: E402
from caster_dta_torch.inference.explain import DTAModelExplainer, _mask_reg  # noqa: E402
from caster_dta_torch.inference.serve import load_run  # noqa: E402
from caster_dta_torch.nn.common import f32_precision  # noqa: E402


def first_step_grad(explainer, protein, molecule, side):
    """d loss / d edge logits at the initial logits (the first Adam step's
    gradient)."""
    graph = protein if side == "protein" else molecule
    with torch.no_grad(), f32_precision():
        full = explainer.model(protein, molecule, return_attention=False)[0][:, 0]
    x = [explainer._initial_logits(tuple(graph.node_mask.shape), 0).clone().requires_grad_(),
         explainer._initial_logits(tuple(graph.edge_mask.shape), 1).clone().requires_grad_()]
    with torch.enable_grad(), f32_precision():
        pred = explainer._masked_pred(protein, molecule, x[0], x[1], side)
        loss = (torch.mean((pred - full) ** 2)
                + _mask_reg(torch.sigmoid(x[0]), graph.node_mask, explainer.coeff_size,
                            explainer.coeff_ent)
                + _mask_reg(torch.sigmoid(x[1]), graph.edge_mask, explainer.coeff_edge_size,
                            explainer.coeff_edge_ent))
        return torch.autograd.grad(loss, x[1])[0].cpu().numpy()


def analysis_datasets(seeds):
    """-> [(seed, the dataset of the analysis phase's BioLIP pairs made from
    that seed)]."""
    import json
    import tempfile

    from caster_dta_torch.analysis.biolip import biolip_pairs
    from caster_dta_torch.inference.checkpoint import create_dataset_with_checkpoint_params
    with open(os.path.join(chip_smoke.RUN_DIR, "model_kwargs.json")) as f:
        kwargs = json.load(f)
    out = []
    for seed in seeds:
        with tempfile.TemporaryDirectory() as tmp:   # featurized before it goes
            inputs = chip_smoke.analysis_inputs(tmp, seed=seed)["biolip"]
            pairs = biolip_pairs(inputs["biolip_file"], inputs["biolip_ligand_file"],
                                 inputs["base_data_dir"], kwargs)
            out.append((seed, create_dataset_with_checkpoint_params(
                pairs, chip_smoke.RUN_DIR, n_workers=0)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--steps", type=int, nargs="+", default=[1, 2, 5, 10])
    ap.add_argument("--analysis", action="store_true",
                    help="the analysis phase's BioLIP batches in place of evaluate's")
    ap.add_argument("--seeds", type=int, nargs="+", default=[19],
                    help="analysis_inputs' seeds (with --analysis)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.analysis:
        datasets, batch_size = analysis_datasets(args.seeds), 16
    else:
        datasets = [("evaluate", synthetic_pair_dataset(chip_smoke.EVAL_PAIRS,
                                                        **chip_smoke.EVAL_DATA))]
        batch_size = chip_smoke.EVAL_BATCH
    card = load_run(chip_smoke.RUN_DIR, device="cuda").model.eval()
    cpu = load_run(chip_smoke.RUN_DIR, device="cpu").model.eval()
    print(chip_smoke.nvidia_smi())
    last = {}   # (side, mask) -> (largest |d| after the last number of steps, where)
    for name, dataset in datasets:
        batches = list(BucketedLoader(dataset, max_num=4_000_000, max_batch_size=batch_size,
                                      shuffle=False))
        for n, batch in enumerate(batches[:args.batches]):
            tag = f"seed {name} batch {n}" if args.analysis else f"batch {n}"
            on_card = batch.to("cuda")
            for side in ("protein", "molecule"):
                g_card = first_step_grad(DTAModelExplainer(card), on_card.protein,
                                         on_card.molecule, side)
                g_cpu = first_step_grad(DTAModelExplainer(cpu), batch.protein, batch.molecule,
                                        side)
                mask = (batch.protein if side == "protein" else batch.molecule).edge_mask.numpy()
                d = np.abs(g_card - g_cpu)[mask]
                rel = d / np.maximum(np.abs(g_cpu[mask]), 1e-30)
                print(f"{tag} {side}: first-step edge-logit gradient, max|d| {d.max():.3e} "
                      f"against max|g| {np.abs(g_cpu[mask]).max():.3e}; largest relative "
                      f"difference {rel.max():.3e} (|g| there "
                      f"{np.abs(g_cpu[mask]).flat[rel.argmax()]:.3e}); entries over 1e-3 "
                      f"relative {int((rel > 1e-3).sum())} of {rel.size}")
                for epochs in args.steps:
                    got = DTAModelExplainer(card, n_epochs=epochs).explain_model(
                        on_card.protein, on_card.molecule, side=side, eager=True)
                    want = DTAModelExplainer(cpu, n_epochs=epochs).explain_model(
                        batch.protein, batch.molecule, side=side)
                    d_node = (got[side].cpu() - want[side]).abs().max().item()
                    d_edge = (got[f"{side}_edges"].cpu() - want[f"{side}_edges"]).abs().max().item()
                    print(f"{tag} {side} after {epochs} steps: max|d node mask| {d_node:.3e}, "
                          f"max|d edge mask| {d_edge:.3e}")
                for mask_kind, d_max in (("node", d_node), ("edge", d_edge)):
                    if d_max >= last.get((side, mask_kind), (-1.0, ""))[0]:
                        last[(side, mask_kind)] = (d_max, tag)
    for (side, mask_kind), (d_max, tag) in last.items():
        print(f"largest after {args.steps[-1]} steps, {side} {mask_kind} masks: {d_max:.3e} "
              f"({tag})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
