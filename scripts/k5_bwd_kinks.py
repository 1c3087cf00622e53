#!/usr/bin/env python3
"""Where K5 bwd in f32 leaves chip_smoke.py's tolerance, and why.

    python3 scripts/k5_bwd_kinks.py [--seeds 8] [--replay]

At the Davis bucket (B=128, E=4096) with the served model's message weights
(``runs/davis_seed9``, f32, activations (relu, none)), K5 bwd on the card is
held against its plain version on the card, as chip_smoke.py's ``kernels``
phase does, for inputs drawn from each seed. For every entry beyond the
phase's tolerance (K5_TOL["f32"] x (1 + the tensor's largest entry)) it
prints the edge, the smallest |pre-activation| of that edge's ReLU units
(from the plain version's forward). A ReLU unit whose pre-activation lies
within f32 rounding of 0 takes the other side of the kink under another sum
order, and its whole term then moves the gradient.

``--replay`` first draws the Davis f32 inputs as chip_smoke.py's ``kernels``
phase drew them in a run where the zoo's kernel cases took their tensors from
the phase's main stream (seed 0) before the K5 cases: those inputs left the
tolerance once (max|d| 1.666e-2 in d both).
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from caster_dta_torch.inference.serve import load_run  # noqa: E402
from caster_dta_torch.ops import cuda_gvp_message as cgm  # noqa: E402


def replay_inputs():
    """The kernels phase's draws up to its Davis f32 K5 case, with the zoo's
    K1/K2/K3 cases drawn from the main stream after flagship #0's."""
    from caster_dta_torch.data.batching import synthetic_pair_batch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flagship = synthetic_pair_batch(**chip_smoke.FLAGSHIP, seed=0)
    davis = synthetic_pair_batch(**chip_smoke.DAVIS, seed=chip_smoke.N_REQUESTS_FLAGSHIP)
    large = synthetic_pair_batch(**chip_smoke.LARGE, seed=chip_smoke.N_REQUESTS_FLAGSHIP + 1)
    chip_smoke.kernel_cases(torch, flagship, gen)
    chip_smoke.zoo_kernel_cases(torch, flagship, gen)
    chip_smoke.kernel_cases(torch, davis, gen)
    chip_smoke.kernel_cases(torch, large, gen)
    for _, msgs, _, _, n in chip_smoke.edge_cases(torch, gen):
        torch.randn(msgs.shape[0], n, msgs.shape[2], generator=gen, device="cuda")
        torch.randint(0, n, (msgs.shape[0], msgs.shape[1] + 3), generator=gen, device="cuda",
                      dtype=torch.int32)
    p = flagship.protein
    for kind in chip_smoke.K5_DTYPES:
        chip_smoke.k5_inputs(torch, gen, p.batch_size, p.e_pad, kind)
    torch.randn(p.batch_size, p.n_pad, 28, generator=gen, device="cuda")
    return chip_smoke.k5_inputs(torch, gen, davis.protein.batch_size, davis.protein.e_pad, "f32")


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", type=int, default=8)
    parser.add_argument("--replay", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("k5_bwd_kinks: needs an NVIDIA card", file=sys.stderr)
        return 1
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {chip_smoke.nvidia_smi()}")
    model = load_run(chip_smoke.RUN_DIR, device="cuda").model
    conv = model.protein_gnn.gnn_model.conv_list[0].conv
    weights = [w.detach() for w in cgm.layer_weights(conv.message_func)]
    spec = cgm.MessageSpec(16, 4, *conv.activations, torch.float32)
    b, e = chip_smoke.DAVIS["b"], chip_smoke.DAVIS["e_p"]
    n_layers = len(weights) // 6
    found = 0
    cases = [(f"seed {seed}", lambda seed=seed: chip_smoke.k5_inputs(
        torch, torch.Generator(device="cuda").manual_seed(seed), b, e, "f32"))
             for seed in range(args.seeds)]
    if args.replay:
        cases.insert(0, ("replay", replay_inputs))
    for what, make in cases:
        both, es, ev, dout = make()
        got = cgm.message_bwd(both, es, ev, weights, dout, spec)[0]
        want = cgm.message_bwd_plain(both, es, ev, weights, dout, spec)[0]
        tol = chip_smoke.K5_TOL["f32"] * (1.0 + want.abs().max().item())
        diff = (got - want).abs()
        bad = (diff > tol).nonzero().tolist()
        print(f"{what}: d both max|d| {diff.max().item():.3e} (tolerance {tol:.3e}); "
              f"{len(bad)} entries beyond it")
        if not bad:
            continue
        found += 1
        _, _, caches = cgm._forward_layers(both, es, ev, weights, spec, keep=True)
        for gb, j, f in bad[:5]:
            edge = gb * e + j % e
            # spre: each layer's scalar pre-activations (the ReLU units but the last layer's)
            nearest = min(caches[k][5][edge].abs().min().item() for k in range(n_layers - 1))
            print(f"  graph {gb} row {j} ({'src' if j < e else 'dst'}) column {f}: card "
                  f"{got[gb, j, f].item():.8g}, plain {want[gb, j, f].item():.8g}; the edge's "
                  f"smallest |ReLU pre-activation| "
                  f"{nearest:.3e}")
    print(f"{found} of {len(cases)} cases had entries beyond the tolerance")
    return 0


if __name__ == "__main__":
    sys.exit(main())
