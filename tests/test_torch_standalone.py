"""The port runs where only PyTorch is installed.

The machine with the card has no flax and need not have JAX, msgpack,
pandas, networkx, requests, matplotlib or Triton. Each case runs a fresh interpreter from the repo
root with those names hidden behind a ``sys.meta_path`` finder whose loader
refuses them (an import raises ImportError), imports every module of
caster_dta_torch and chip_smoke, serves one tiny batch from runs/davis_seed9
on the CPU, serves it again with the fused message path switched on
(``caster_dta_torch.nn.gvp.fused_message``) and with the blockwise attention
path (``use_pallas`` on both MultiheadAttention modules), builds and serves
chip_smoke.py's zoo-cpd-gatv2 model (the CPD protein tower, the GATv2
molecule tower) and reloads it from the checkpoint it writes, builds and
serves the zoo-lba-gin, -attentivefp, -gps and -pna models (the GIN,
AttentiveFP, GPS and PNA molecule towers), runs
``run_model_on_dataset`` with the explainer on, takes one bf16 training step
from those weights and writes a checkpoint that the port reads back, trains
and evaluates one epoch bucket by bucket over a device-resident store (the
scan path, eager on the CPU), featurizes a Davis structure and a SMILES
(rings without networkx, the native host library built here), runs the
training CLI for one epoch on ``--dataset synthetic`` from its PDB files and
SMILES, again with ``--n-dp 2`` (two local gloo ranks, each a fresh
interpreter with the same names hidden: the finder is installed by a
``sitecustomize`` on ``PYTHONPATH``), imports ``caster_dta_torch.parallel``
and ``caster_dta_torch.utils`` with every other module, runs the BioLIP analysis on chip_smoke.py's synthetic tables and its
t-test statistics (a drawing call raises ImportError naming matplotlib), and
checks that none of the hidden names was loaded. A second case runs
chip_smoke.py without a card: it must fail and print no result, since
nothing falls back to the CPU.
"""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "pandas", "networkx", "triton",
          "requests", "matplotlib", "caster_dta_tpu")

HIDE = """
import importlib.abc, importlib.machinery, sys
HIDDEN = set(%r)

class Refuse(importlib.abc.Loader):
    def create_module(self, spec):
        raise ModuleNotFoundError(spec.name + " is hidden", name=spec.name)

    def exec_module(self, module):
        pass

class Hide(importlib.abc.MetaPathFinder):
    # an import of a hidden name fails; a probe (importlib.util.find_spec, as
    # torch._dynamo makes for optional packages) gets a spec with no origin
    def find_spec(self, name, path=None, target=None):
        if name.partition(".")[0] in HIDDEN:
            return importlib.machinery.ModuleSpec(name, Refuse())
        return None

sys.meta_path.insert(0, Hide())
""" % (HIDDEN,)

SCRIPT = """
import importlib, json, pkgutil, sys
HIDDEN = set(%r)
assert any(type(f).__name__ == "Hide" for f in sys.meta_path)
import torch
import caster_dta_torch
names = [info.name for info in pkgutil.walk_packages(caster_dta_torch.__path__,
                                                     "caster_dta_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("caster_dta_torch.parallel.mesh", "caster_dta_torch.parallel.partition",
             "caster_dta_torch.utils.profiling", "caster_dta_torch.utils.traffic"):
    assert name in names, name
import chip_smoke
from caster_dta_torch.data.batching import synthetic_pair_batch
from caster_dta_torch.inference.serve import load_run, predict

run = load_run("runs/davis_seed9", device="cpu")
aff, (w_rd, w_da) = predict(run, synthetic_pair_batch(2, 24, 96, 8, 16, seed=0))
assert aff.shape == (2,) and bool(torch.isfinite(aff).all()), aff
assert w_rd.shape == (2, 24, 8) and w_da.shape == (2, 8, 24)

from caster_dta_torch.nn import gvp
with gvp.fused_message():
    aff_fused, _ = predict(run, synthetic_pair_batch(2, 24, 96, 8, 16, seed=0))
assert float((aff_fused - aff).abs().max()) < 1e-4, (aff_fused, aff)

from caster_dta_torch.nn.attention import MultiheadAttention
mhas = [m for m in run.model.modules() if isinstance(m, MultiheadAttention)]
for m in mhas:
    m.use_pallas = True
aff_blockwise, attn_blockwise = predict(run, synthetic_pair_batch(2, 24, 96, 8, 16, seed=0))
assert attn_blockwise == (None, None), attn_blockwise
assert float((aff_blockwise - aff).abs().max()) < 1e-4, (aff_blockwise, aff)
for m in mhas:
    m.use_pallas = False

import tempfile
from caster_dta_torch.inference.checkpoint import build_model, load_model_from_checkpoint
from caster_dta_torch.inference.serve import LoadedRun
from caster_dta_torch.interop.from_jax import to_jax_params
from caster_dta_torch.train import checkpoints
zoo_all = chip_smoke.zoo_configs()
for name in ("zoo-lba-gin", "zoo-lba-attentivefp", "zoo-lba-gps", "zoo-lba-pna"):
    kw = zoo_all[name]
    served = LoadedRun(build_model(kw).eval(), kw, run.rescale, "", torch.device("cpu"))
    a, (rd, _) = predict(served, synthetic_pair_batch(2, 24, 96, 8, 16, seed=0))
    assert a.shape == (2,) and bool(torch.isfinite(a).all()) and rd.shape == (2, 24, 8), name
zoo = zoo_all["zoo-cpd-gatv2"]
zoo_run = LoadedRun(build_model(zoo).eval(), zoo, run.rescale, "", torch.device("cpu"))
aff_zoo, (z_rd, _) = predict(zoo_run, synthetic_pair_batch(2, 24, 96, 8, 16, seed=0))
assert aff_zoo.shape == (2,) and bool(torch.isfinite(aff_zoo).all()), aff_zoo
assert z_rd.shape == (2, 24, 8)
with tempfile.TemporaryDirectory() as tmp:
    with open(tmp + "/model_kwargs.json", "w") as f:
        json.dump(zoo, f)
    checkpoints.save_params(to_jax_params(zoo_run.model), tmp + "/bestvalmodel_x.msgpack")
    zoo_back = LoadedRun(load_model_from_checkpoint(tmp, device="cpu")[0], zoo, run.rescale, "",
                         torch.device("cpu"))
assert torch.equal(predict(zoo_back, synthetic_pair_batch(2, 24, 96, 8, 16, seed=0))[0], aff_zoo)

from caster_dta_torch.data.batching import synthetic_pair_dataset
from caster_dta_torch.inference.evaluation import run_model_on_dataset
records = run_model_on_dataset(run.model, synthetic_pair_dataset(3, 2, 2, [(10, 20)], (6, 10),
                                                                 seed=2),
                               max_batch_size=2, explainer_epochs=2)
assert len(records["pair_idx"]) == 3 and records["pair_idx"] == sorted(records["pair_idx"])
assert abs(float(records["protein_explanation"][0].sum()) - 1.0) < 1e-5
assert records["molecule_edge_explanation"][0].ndim == 1

import math, os, tempfile
from caster_dta_torch.train import checkpoints
from caster_dta_torch.train.loop import Trainer, TrainConfig
trainer = Trainer(run.model, TrainConfig(compute_dtype="bfloat16"), device="cpu")
loss, pred = trainer.train_step(synthetic_pair_batch(2, 24, 96, 8, 16, seed=1))
assert bool(torch.isfinite(loss)) and pred.shape == (2,), (loss, pred)
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "bestvalmodel_x.msgpack")
    checkpoints.save_params(trainer.params_tree(), path)
    back = checkpoints.load_params(path)
assert back["output_layer"]["kernel"].shape == (256, 1)

from caster_dta_torch.data.batching import BucketedLoader, synthetic_pair_dataset
from caster_dta_torch.data.device_cache import DeviceResidentLoader
pairs = synthetic_pair_dataset(10, 3, 3, [(10, 20)], (6, 10), seed=0)
store = DeviceResidentLoader(BucketedLoader(pairs, None, max_batch_size=4, seed=0), device="cpu")
assert trainer._use_scan(store)
epoch_loss, _ = trainer.train_epoch(store, 1e-4)
val_loss, val_pred, _, val_idx = trainer.eval_epoch(store)
assert math.isfinite(epoch_loss) and math.isfinite(val_loss), (epoch_loss, val_loss)
assert sorted(val_idx.tolist()) == list(range(10)) and val_pred.shape == (10,)

from caster_dta_torch.data import build
from caster_dta_torch.train import driver
g = build.protein_file_to_graph("data/structures_davis/AAK1.pdb", "angstroms", 4, "dist", True,
                                True, False, False, True)
assert g["node_s"].shape == (g["n_nodes"], 17) and g["edge_v"].shape == (g["n_edges"], 1, 3)
m = build.molecule_smiles_to_graph("c1ccc2c(c1)oc1ccccc12", False, False, True)
assert m["node_s"].shape == (13, 41)
with tempfile.TemporaryDirectory() as tmp:
    res = driver.main(["--dataset", "synthetic", "--data-root", tmp + "/data",
                       "--out-folder", tmp + "/out", "--n-epochs", "1", "--device", "cpu",
                       "--n-workers", "0"])
    assert len(res["history"]) == 1 and math.isfinite(res["history"][0]["train"])
    assert os.path.exists(tmp + "/out/train_state.msgpack")
    ranks = driver.main(["--dataset", "synthetic", "--data-root", tmp + "/data",
                         "--out-folder", tmp + "/dp", "--n-epochs", "1", "--device", "cpu",
                         "--n-workers", "0", "--n-dp", "2"])
    assert abs(ranks["history"][0]["train"] - res["history"][0]["train"]) < 1e-3, ranks
    assert os.path.exists(tmp + "/dp/train_state.msgpack")
from caster_dta_torch.analysis.biolip import run_biolip_binding
from caster_dta_torch.analysis.visualize import visualize_biolip_results
with tempfile.TemporaryDirectory() as tmp:
    ins = chip_smoke.analysis_inputs(tmp + "/in", biolip_proteins=4, residues=(20, 40))
    res = run_biolip_binding("runs/davis_seed9", results_dir=tmp + "/r", device="cpu",
                             max_batch_size=4, **ins["biolip"])
    assert len(res["pair_idx"]) == 4 and os.path.exists(tmp + "/r/biolip_raw_records.pkl")
    stats = visualize_biolip_results(res, tmp + "/fig", draw=False)
    assert all(math.isfinite(stats[k][x]) for k in stats for x in ("t", "p")), stats
    try:
        visualize_biolip_results(res, tmp + "/fig")
        raise AssertionError("drew without matplotlib")
    except ImportError as e:
        assert "matplotlib" in str(e), e
loaded = sorted(n for n in sys.modules if n.partition(".")[0] in HIDDEN)
assert not loaded, loaded
print("standalone ok", aff.tolist())
""" % (HIDDEN,)


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_and_serves_without_jax_flax_msgpack_pandas(tmp_path):
    # one OpenMP thread: beside other test workers, torch's threads wait on
    # each other's cores (194 s beside three workers, 13 s with one thread)
    (tmp_path / "sitecustomize.py").write_text(HIDE)
    env = dict(_env(), OMP_NUM_THREADS="1", PYTHONPATH=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "standalone ok" in r.stdout


def test_chip_smoke_fails_without_a_card():
    env = dict(_env(), CUDA_VISIBLE_DEVICES="")   # no card, on any machine
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    lines = r.stdout.strip().splitlines()
    assert not lines or '"ok": true' not in lines[-1]
    assert "CUDA is not available" in r.stderr
