"""The port runs where only PyTorch is installed.

The machine with the card has no flax and need not have JAX, msgpack,
pandas or Triton. Each case runs a fresh interpreter from the repo root with
those names hidden behind a ``sys.meta_path`` finder that raises
ImportError, imports every module of caster_dta_torch and chip_smoke, serves
one tiny batch from runs/davis_seed9 on the CPU, and checks that none of the
hidden names was loaded. A second case runs chip_smoke.py without a card: it
must fail and print no result, since nothing falls back to the CPU.
"""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "pandas", "triton", "caster_dta_tpu")

SCRIPT = """
import importlib, importlib.abc, pkgutil, sys
HIDDEN = set(%r)

class Hide(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.partition(".")[0] in HIDDEN:
            raise ModuleNotFoundError(name + " is hidden", name=name)
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
