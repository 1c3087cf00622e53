"""The f32 noise floor of the explainer's masks at the trained model's full
width, on the CPU: the JAX package's DTAModelExplainer jitted (its default)
against the same explainer op by op (``jax.disable_jit``) on one batch, and
the port's masks against both.

The batch is the first of the variation task with runs/davis_seed9 in
tests/test_torch_analysis_trained.py: by default two Davis kinases (403 and
344 residues) and their point variants from analysis_results/
pretrained_bindingdb/pgx against the four drugs of the committed ligand
table, 8 pairs; ``--kinases``, ``--drugs`` and ``--batch-size`` take fewer.
Prints the largest difference of each mask (raw, before the softmax that
run_model_on_dataset takes of the node masks), where it lies, and the
seconds of each run. ``--float64`` also runs the port and the jitted JAX
explainer in float64 (parameters, features and mask logits; the initial
logits the f32 draws of both), to tell a mask entry that rounding decides
from a difference of the two programs.

    python scripts/explainer_jax_floor.py [--kinases 2] [--drugs 4] [--batch-size 8]
                                          [--float64]   (2-3 minutes on 8 CPU cores)

For the readings under the tests' XLA flags (tests/conftest.py), run it with
XLA_FLAGS="--xla_force_host_platform_device_count=8
--xla_backend_optimization_level=0".
"""
import argparse
import hashlib
import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402

from caster_dta_torch.data import tables  # noqa: E402
from caster_dta_torch.data.batching import BucketedLoader  # noqa: E402
from caster_dta_torch.inference.checkpoint import (  # noqa: E402
    create_dataset_with_checkpoint_params, load_model_from_checkpoint)
from caster_dta_torch.inference.explain import DTAModelExplainer  # noqa: E402
from caster_dta_tpu.data.batching import BucketedLoader as JaxLoader  # noqa: E402
from caster_dta_tpu.data.pairs import ProteinMoleculeDataset as JaxDataset  # noqa: E402
from caster_dta_tpu.inference.checkpoint import \
    load_model_from_checkpoint as jax_load  # noqa: E402
from caster_dta_tpu.inference.explain import DTAModelExplainer as JaxExplainer  # noqa: E402
from tests.test_torch_analysis_trained import INPUTS, RUN, kinases, ligands  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kinases", type=int, default=2)
    ap.add_argument("--drugs", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--float64", action="store_true")
    args = ap.parse_args()
    drugs = dict(list(ligands().items())[:args.drugs])
    seqs = {}
    for seq in list(kinases().values())[:args.kinases]:
        mid = len(seq) // 2
        for s in (seq, seq[:mid] + ("W" if seq[mid] != "W" else "F") + seq[mid + 1:]):
            seqs[hashlib.sha256(s.encode()).hexdigest()] = s
    pdb = os.path.join(INPUTS, "pgx", "data", "pdb_files")
    rec = tables.merge({"protein_id": list(seqs), "protein_sequence": list(seqs.values()),
                        "protein_file": [os.path.join(pdb, f"{i}.pdb") for i in seqs]},
                       {"molecule_id": list(drugs), "molecule_smiles": list(drugs.values())},
                       how="cross")
    rec["affinity_score"] = [0.0] * tables.n_rows(rec)
    rec = tables.sort_by(rec, ["protein_id", "molecule_id"])

    model, _, _ = load_model_from_checkpoint(RUN, device="cpu")
    batch = next(iter(BucketedLoader(create_dataset_with_checkpoint_params(rec, RUN),
                                     max_num=4_000_000, max_batch_size=args.batch_size,
                                     shuffle=False)))
    with open(os.path.join(RUN, "dataset_kwargs.json")) as f:
        jds = JaxDataset(pd.DataFrame(rec), **json.load(f))
    jb = next(iter(JaxLoader(jds, max_num=4_000_000, max_batch_size=args.batch_size,
                             shuffle=False)))
    jm, jv, _ = jax_load(RUN)

    def timed(what, fn):
        t0 = time.perf_counter()
        out = {k: np.asarray(v, np.float64) for k, v in fn().items()}
        print(f"{what}: {time.perf_counter() - t0:.1f} s")
        return out

    port = timed("port", lambda: {k: v.numpy() for k, v in DTAModelExplainer(
        model).explain_model(batch.protein, batch.molecule, eager=True).items()})
    jit = timed("JAX jitted (compile included)", lambda: JaxExplainer(jm).explain_model(
        jv, jb.protein, jb.molecule))
    with jax.disable_jit():
        eager = timed("JAX op by op", lambda: JaxExplainer(jm).explain_model(
            jv, jb.protein, jb.molecule))
    print(f"batch: pairs {batch.pair_idx.tolist()}, bucket {batch.bucket}")

    def where(a, b):
        d = np.abs(a - b)
        return f"{d.max():.3e} at {tuple(int(i) for i in np.unravel_index(d.argmax(), d.shape))}"

    for k in port:
        print(f"{k}: JAX jitted vs JAX op by op {where(jit[k], eager[k])}; "
              f"port vs JAX jitted {where(port[k], jit[k])}; "
              f"port vs JAX op by op {where(port[k], eager[k])}")
    if args.float64:
        port64, jit64 = float64_masks(model, batch, jm, jv, jb)
        for k in port:
            print(f"{k}, float64: port vs JAX {where(port64[k], jit64[k])}; port float64 vs "
                  f"float32 {where(port64[k], port[k])}; JAX float64 vs float32 "
                  f"{where(jit64[k], jit[k])}")


def float64_masks(model, batch, jm, jv, jb):
    """The port's and the jitted JAX explainer's masks with parameters,
    features and mask logits in float64, both from the f32 initial draws."""
    import dataclasses

    import jax.numpy as jnp
    import torch

    floats = ("node_s", "node_v", "edge_s", "edge_v")
    explainer = DTAModelExplainer(model.double())
    f32_draw = explainer._initial_logits
    explainer._initial_logits = lambda shape, which: f32_draw(shape, which).double()
    cast = {}
    for side in ("protein", "molecule"):
        g = getattr(batch, side)
        cast[side] = dataclasses.replace(g, **{f: getattr(g, f).to(torch.float64)
                                              for f in floats})
    port = {k: v.numpy() for k, v in explainer.explain_model(
        cast["protein"], cast["molecule"], eager=True).items()}
    model.float()

    jax.config.update("jax_enable_x64", True)
    normal = jax.random.normal
    jax.random.normal = lambda key, shape: normal(key, shape, jnp.float32).astype(jnp.float64)
    try:
        v64 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), jv)
        graphs = [g.replace(**{f: jnp.asarray(getattr(g, f), jnp.float64) for f in floats
                               if getattr(g, f) is not None})
                  for g in (jb.protein, jb.molecule)]
        jit = {k: np.asarray(v) for k, v in JaxExplainer(jm).explain_model(v64, *graphs).items()}
    finally:
        jax.random.normal = normal
        jax.config.update("jax_enable_x64", False)
    assert all(v.dtype == np.float64 for v in (*port.values(), *jit.values()))
    return port, jit


if __name__ == "__main__":
    main()
