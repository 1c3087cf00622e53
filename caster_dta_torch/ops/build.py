"""Build a CUDA source of the port with nvcc and load it with ctypes.

Each source under ``caster_dta_torch/csrc/`` has a plain ``extern "C"``
interface and includes no PyTorch header, so one ``nvcc`` call builds it in
seconds and no ``ninja`` or ``setuptools`` is needed. The shared library goes
to ``caster_dta_torch/_build/`` under a name keyed by a hash of the source and
the flags, so an edited source is rebuilt and an unchanged one is loaded as it
is. Nothing is built when a module is imported: the first kernel call builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")

NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")


@dataclass
class Built:
    """A loaded library, with what its build printed (ptxas register and
    shared-memory lines) and how long the build took (0 when it was cached)."""
    lib: ctypes.CDLL
    path: str
    log: str
    seconds: float


def count_launch(launches: dict, nbytes: dict, name: str, *tensors) -> None:
    """Count one launch of kernel ``name`` in ``launches`` and the bytes it
    moved in ``nbytes``: each of ``tensors`` (the function's inputs and
    outputs, not its scratch) read or written once (utils/traffic.py)."""
    launches[name] += 1
    nbytes[name] += sum(t.numel() * t.element_size() for t in tensors)


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return nvcc


def build(source: str) -> Built:
    """Compile ``csrc/<source>`` for sm_90a (or reuse the cached build) and
    load it. Raises RuntimeError with nvcc's output when the build fails."""
    src_path = os.path.join(CSRC_DIR, source)
    with open(src_path, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    so_path = os.path.join(BUILD_DIR, f"{stem}_{key}.so")
    log_path = so_path[:-3] + ".log"
    seconds = 0.0
    if not os.path.isfile(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src_path]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source}:\n"
                               f"{' '.join(cmd)}\n{log}")
        with open(log_path, "w") as f:
            f.write(log)
        os.replace(tmp, so_path)  # atomic: a concurrent loader sees all or nothing
    with open(log_path) as f:
        log = f.read()
    return Built(ctypes.CDLL(so_path), so_path, log, seconds)
