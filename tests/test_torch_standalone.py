"""The port runs where only PyTorch is installed.

The machine with the card has no flax and need not have JAX, msgpack,
pandas or Triton. Each case runs a fresh interpreter from the repo root with
those names hidden behind a ``sys.meta_path`` finder whose loader refuses
them (an import raises ImportError), imports every module of
caster_dta_torch and chip_smoke, serves one tiny batch from runs/davis_seed9
on the CPU, serves it again with the fused message path switched on
(``caster_dta_torch.nn.gvp.fused_message``) and with the blockwise attention
path (``use_pallas`` on both MultiheadAttention modules), takes one bf16 training step
from those weights and writes a checkpoint that the port reads back, and
checks that none of the hidden names was loaded. A second case runs
chip_smoke.py without a card: it must fail and print no result, since
nothing falls back to the CPU.
"""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "pandas", "triton", "caster_dta_tpu")

SCRIPT = """
import importlib, importlib.abc, importlib.machinery, pkgutil, sys
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
import torch
import caster_dta_torch
for info in pkgutil.walk_packages(caster_dta_torch.__path__, "caster_dta_torch."):
    importlib.import_module(info.name)
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

import os, tempfile
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
loaded = sorted(n for n in sys.modules if n.partition(".")[0] in HIDDEN)
assert not loaded, loaded
print("standalone ok", aff.tolist())
""" % (HIDDEN,)


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_and_serves_without_jax_flax_msgpack_pandas():
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=_env(),
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
