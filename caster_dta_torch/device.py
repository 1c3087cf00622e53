"""Device choice for the port's entry points: the card unless the caller asks
for the CPU. No entry point moves to the CPU on its own. Also the CPU code
path those entry points pin for MKL."""
from __future__ import annotations

import os

import torch

# MKL picks the code path of its BLAS calls at run time, once, at its first
# GEMM (not at ``import torch``). Left to choose under load, it has given a
# process's first CPU forward other bits than its later forwards; pinned to
# the COMPATIBLE path, no first forward differed (scripts/first_forward_probe.py).
MKL_CBWR = "COMPATIBLE"


def pin_mkl_code_path() -> None:
    """Pin MKL's code path (``MKL_CBWR``) for this process and the processes
    it starts, unless the caller set one. The port's entry points call this
    first: it acts only before the process's first CPU matmul."""
    os.environ.setdefault("MKL_CBWR", MKL_CBWR)


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
