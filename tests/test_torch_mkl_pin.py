"""The port's entry points pin MKL's code path before MKL first runs.

MKL picks the code path of its BLAS calls once, at its first GEMM, from
``MKL_CBWR``; left to choose under load it has given a process's first CPU
forward other bits than its later forwards (scripts/first_forward_probe.py).
Each entry point sets ``MKL_CBWR=COMPATIBLE`` unless the caller set it:
``train_model_torch.py``, ``analysis_torch.py``, ``python -m
caster_dta_torch.train.driver``, ``python -m caster_dta_torch.analysis.cli``
and ``chip_smoke.py`` (its main and its ``--multidevice-child`` ranks).

One fresh process runs each entry point as ``__main__`` up to where it stops
without work (``--help``; chip_smoke.py's main without a card; a rank child
without its spec file), and reads the environment after it: pinned when the
caller set nothing, the caller's own value kept when it did. Then it runs its
first GEMM and reads back the code path MKL took: COMPATIBLE, which also
shows that no entry point ran MKL before its pin.
"""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import contextlib, ctypes, io, json, os, runpy, sys, warnings
sys.path.insert(0, REPO)
warnings.simplefilter("ignore")   # runpy: a module run again as __main__
ENTRIES = [("train_model_torch.py", ["--help"]), ("analysis_torch.py", ["--help"]),
           ("-m caster_dta_torch.train.driver", ["--help"]),
           ("-m caster_dta_torch.analysis.cli", ["--help"]),
           ("chip_smoke.py", []), ("chip_smoke.py", ["--multidevice-child", "no-spec.json", "0"])]
seen = []
for preset in ("AVX2", None):   # the caller's own value first: MKL reads the last one
    for entry, argv in ENTRIES:
        os.environ.pop("MKL_CBWR", None)
        if preset:
            os.environ["MKL_CBWR"] = preset
        sys.argv = [entry.split()[-1]] + argv
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
                if entry.startswith("-m "):
                    runpy.run_module(entry[3:], run_name="__main__", alter_sys=True)
                else:
                    runpy.run_path(os.path.join(REPO, entry), run_name="__main__")
            stop = "returned"
        except SystemExit as e:
            stop = f"exit {e.code}"
        except Exception as e:
            stop = type(e).__name__
        seen.append({"entry": " ".join([entry] + argv), "caller": preset, "stop": stop,
                     "MKL_CBWR": os.environ.get("MKL_CBWR")})
import torch
a = torch.ones(64, 64)
a @ a
lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib", "libtorch_cpu.so"))
path = lib.mkl_serv_cbwr_get(1) if hasattr(lib, "mkl_serv_cbwr_get") else None
print(json.dumps({"entries": seen, "mkl_code_path": path}))
"""


def test_entry_points_pin_mkl_before_it_runs():
    env = {k: v for k, v in os.environ.items() if k != "MKL_CBWR"}
    env["CUDA_VISIBLE_DEVICES"] = ""   # chip_smoke.py's main stops at the card check
    r = subprocess.run([sys.executable, "-c", CHILD.replace("REPO", repr(REPO))], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    report = json.loads(r.stdout.strip().splitlines()[-1])
    for entry in report["entries"]:
        want = entry["caller"] or "COMPATIBLE"
        assert entry["MKL_CBWR"] == want, entry
        assert entry["stop"] in ("exit 0", "exit 1", "FileNotFoundError"), entry
    assert len(report["entries"]) == 12
    # MKL's first GEMM ran after the last entry point pinned it
    # (mkl_serv_cbwr_get(MKL_CBWR_BRANCH): 3 is MKL_CBWR_COMPATIBLE)
    if report["mkl_code_path"] is not None:
        assert report["mkl_code_path"] == 3
