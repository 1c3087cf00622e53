#!/usr/bin/env python3
"""K5's and K6's device times on the card, for one or more versions of
``caster_dta_torch/csrc/gvp_message.cu`` side by side.

    python3 scripts/k5_k6_times.py [--source FILE [--tag NAME]] ... [--sass]

Each ``--source`` (default ``caster_dta_torch/csrc/gvp_message.cu``) is built
with nvcc into ``caster_dta_torch/_build/k5_k6/`` (all builds at once), and
its ptxas lines (registers, stack frame, spills, shared memory) for K5 fwd,
K5 bwd, the weight-gradient sum and K6 are printed. A source from before the
warp-tile K5 bwd (one without ``k5_bwd_kernel``) or the warp-tile K5 fwd
(without ``k5_fwd_kernel``) is called through its own C interface. Then, at
each case, every version is timed as ``chip_smoke.py`` times kernels (20 launches
in a CUDA graph, replays timed with CUDA events, L2 warm), in the order
first, second, ..., second, first:

- K5 bwd (two launches a call, each also timed alone by torch.profiler)
  with the served model's message weights (``runs/davis_seed9``, the first
  protein conv) at the flagship and Davis protein edges, f32 and with the
  bf16 training step's dtypes (both, es f32; ev bf16; bf16 products), beside
  its bound (its inputs and dout read once,
  its gradients written once, at 3.35 TB/s);
- K5 fwd at the same cases, with the kernel each version runs and its
  shared memory a block;
- K6 on the flagship and Davis node tables [B, N, 28], every dtype pair,
  beside ``Tensor.to(dtype, copy=True)`` on the same table, whose kernels
  torch.profiler lists once;
- an empty kernel (one block of 32 threads), the launch floor of a replayed
  graph.

With ``--sass``, each version's warp-tile K5 bwd and K5 fwd kernels (where
it has them) are disassembled with ``cuobjdump`` and their instructions
counted by opcode, each instance apart.
Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (bucket sizes, timing, nvidia-smi)
from caster_dta_torch.inference.serve import load_run  # noqa: E402
from caster_dta_torch.ops import build  # noqa: E402
from caster_dta_torch.ops import cuda_gvp_message as cgm  # noqa: E402

OUT = os.path.join(build.BUILD_DIR, "k5_k6")
EMPTY_SOURCE = """
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int k0_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""
PTXAS_KERNELS = ("message_fwd", "message_bwd", "reduce_rows", "cast_vec", "cast_copy", "copy16")
SASS_KERNELS = ("message_bwd_mma_kernel", "message_bwd_f32_kernel", "message_fwd_mma_kernel",
                "message_fwd_f32_kernel")


def nvcc(source: str, so: str) -> str:
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-o", so, source]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(" ".join(cmd) + "\n" + r.stdout + r.stderr)
    return r.stdout + r.stderr


def ptxas_lines(log: str) -> list:
    """ptxas's lines for the kernels of PTXAS_KERNELS, each after its entry."""
    lines, entry = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            entry = name if any(k in name for k in PTXAS_KERNELS) else None
        elif entry and ("registers" in line or "stack frame" in line):
            lines.append(f"{entry}: {line.strip()}")
    return lines


def sass_histogram(so: str, kernel: str) -> str:
    """The SASS instructions of each instance of the kernel in the library,
    counted by opcode."""
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    counts, current = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            current = name if kernel in name else None
            if current:
                counts[current] = {}
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
        if current and m:
            counts[current][m.group(1)] = counts[current].get(m.group(1), 0) + 1
    if not counts:
        return f"no {kernel} in the library"
    lines = []
    for name, ops in counts.items():
        top = sorted(ops.items(), key=lambda kv: -kv[1])
        lines.append(f"{name}: {sum(ops.values())} SASS instructions; "
                     + ", ".join(f"{op} {n}" for op, n in top))
    return "\n  ".join(lines)


def kernel_name(signature: str) -> str:
    """The kernel's own name in a profiler's demangled signature."""
    m = re.search(r"(\w+)\s*[<(]", signature.replace("(anonymous namespace)::", ""))
    return m.group(1) if m else signature


class Version:
    """One build of gvp_message.cu, called through its own C interface."""

    def __init__(self, tag: str, lib: ctypes.CDLL):
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.tag, self.lib = tag, lib
        self.new_api = hasattr(lib, "k5_bwd_kernel")
        self.fwd_api = hasattr(lib, "k5_fwd_kernel")
        # k5_bwd_blocks takes block_tiles where the source has the f32 warp tiles
        self.block_api = hasattr(lib, "k5_message_bwd_block")
        lib.k5_message_fwd.argtypes = [vp] * 7 + [i] * 14 + [vp]
        lib.k5_message_bwd.argtypes = [vp] * 12 + [i] * 15 + [vp]
        lib.k6_cast_copy.argtypes = [vp, vp, ll, i, i, vp]
        if self.fwd_api:
            lib.k5_fwd_kernel.argtypes = [vp] + [i] * 9
        if self.block_api:
            lib.k5_bwd_blocks.argtypes = [vp, i, i, i, i, i, i, ll, i]
        elif self.new_api:
            lib.k5_bwd_blocks.argtypes = [vp, i, i, i, i, i, i, ll]
        if self.new_api:
            lib.k5_bwd_kernel.argtypes = [vp] + [i] * 9
            lib.k5_smem_bytes.argtypes = [vp, i, i, i, i, i, i, i]
        else:
            lib.k5_bwd_blocks.argtypes = [ll]
            lib.k5_smem_bytes.argtypes = [vp, i, i, i, i, i, i]
        lib.k5_bwd_blocks.restype = ll
        lib.k5_smem_bytes.restype = ll

    def bwd_rows(self, dims_host, n_layers, cdt_bf16, r) -> int:
        if self.block_api:
            return self.lib.k5_bwd_blocks(dims_host, n_layers, 16, 4, 32, 1, cdt_bf16, r, 0)
        if self.new_api:
            return self.lib.k5_bwd_blocks(dims_host, n_layers, 16, 4, 32, 1, cdt_bf16, r)
        return self.lib.k5_bwd_blocks(r)

    def bwd_smem(self, dims_host, n_layers, cdt_bf16) -> int:
        if self.new_api:
            return self.lib.k5_smem_bytes(dims_host, n_layers, 16, 4, 32, 1, 1, cdt_bf16)
        return self.lib.k5_smem_bytes(dims_host, n_layers, 16, 4, 32, 1, 1)

    def fwd_smem(self, dims_host, n_layers, cdt_bf16) -> int:
        if self.new_api:
            return self.lib.k5_smem_bytes(dims_host, n_layers, 16, 4, 32, 1, 0, cdt_bf16)
        return self.lib.k5_smem_bytes(dims_host, n_layers, 16, 4, 32, 1, 0)

    def fwd_kernel(self, dims_host, n_layers, cdt_bf16, acts, dtypes) -> str:
        if not self.fwd_api:
            return "block tiles"
        return cgm.FWD_KERNELS[self.lib.k5_fwd_kernel(dims_host, n_layers, 16, 4, 32, 1,
                                                      cdt_bf16, *acts, dtypes & 7)]

    def bwd_kernel(self, dims_host, n_layers, cdt_bf16, acts, dtypes) -> str:
        if not self.new_api:
            return "block tiles"
        return cgm.BWD_KERNELS[self.lib.k5_bwd_kernel(dims_host, n_layers, 16, 4, 32, 1,
                                                      cdt_bf16, *acts, dtypes)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[])
    ap.add_argument("--tag", action="append", default=[])
    ap.add_argument("--sass", action="store_true",
                    help="count the warp-tile K5 kernels' SASS instructions by opcode")
    args = ap.parse_args()
    sources = args.source or [os.path.join(build.CSRC_DIR, "gvp_message.cu")]
    tags = args.tag + [f"v{k}" for k in range(len(args.tag), len(sources))]
    if not torch.cuda.is_available():
        print("k5_k6_times: needs an NVIDIA card", file=sys.stderr)
        return 1
    print(f"nvidia-smi: {chip_smoke.nvidia_smi()}")
    os.makedirs(OUT, exist_ok=True)
    empty_cu = os.path.join(OUT, "empty.cu")
    with open(empty_cu, "w") as f:
        f.write(EMPTY_SOURCE)
    jobs = [(src, os.path.join(OUT, f"{tag}.so")) for src, tag in zip(sources, tags)]
    jobs.append((empty_cu, os.path.join(OUT, "empty.so")))
    with ThreadPoolExecutor(len(jobs)) as pool:
        logs = list(pool.map(lambda j: nvcc(*j), jobs))
    versions = []
    for (src, so), tag, log in zip(jobs, tags, logs):
        print(f"source {os.path.relpath(os.path.abspath(src), ROOT)} as {tag}")
        for line in ptxas_lines(log):
            print(f"  {tag} {line}")
        versions.append(Version(tag, ctypes.CDLL(so)))
        if args.sass:
            for kernel in SASS_KERNELS:
                print(f"  {tag} {sass_histogram(so, kernel)}")
    empty = ctypes.CDLL(jobs[-1][1])
    empty.k0_empty.argtypes = [ctypes.c_void_p]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    turns = versions + versions[::-1]

    def timed(label, calls: dict, extra=""):
        """calls: tag -> fn; times each in turns and prints one line."""
        got = {v.tag: [] for v in versions}
        for v in turns:
            got[v.tag].append(chip_smoke.graph_time_ms(torch, calls[v.tag]))
        parts = [f"{tag} {' / '.join(f'{t:.4f}' for t in ts)} ms" for tag, ts in got.items()]
        print(f"{label}: " + "; ".join(parts) + (f"; {extra}" if extra else ""))

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    trained = load_run(chip_smoke.RUN_DIR, device="cuda").model
    conv = trained.protein_gnn.gnn_model.conv_list[0].conv
    weights = [w.detach() for w in cgm.layer_weights(conv.message_func)]
    acts = conv.activations
    w = cgm._pack(weights)
    dims = cgm._layer_dims(weights, cgm.MessageSpec(16, 4, acts[0], acts[1], torch.float32), 32, 1)
    flat = [x for d in dims for x in d]
    dims_host = (ctypes.c_int * len(flat))(*flat)
    dims_dev = torch.tensor(flat, dtype=torch.int32, device="cuda")
    codes = (cgm._ACT_CODES[acts[0]], cgm._ACT_CODES[acts[1]])
    isb = cgm._is_bf16

    buckets = (("flagship", chip_smoke.FLAGSHIP), ("davis", chip_smoke.DAVIS))
    for label, size in buckets:
        b, e = size["b"], size["e_p"]
        for kind in chip_smoke.K5_DTYPES:
            both, es, ev, dout = chip_smoke.k5_inputs(torch, gen, b, e, kind)
            cdt = int(chip_smoke.K5_DTYPES[kind][3] == "bfloat16")
            out = torch.empty(b, e, 28, dtype=both.dtype, device="cuda")
            dboth, des, dev = torch.empty_like(both), torch.empty_like(es), torch.empty_like(ev)
            dw = torch.empty(w.numel(), device="cuda")
            partial = {v.tag: torch.empty(v.bwd_rows(dims_host, len(dims), cdt, b * e), w.numel(),
                                          device="cuda") for v in versions}

            def fwd(v):
                def call():
                    err = v.lib.k5_message_fwd(
                        both.data_ptr(), es.data_ptr(), ev.data_ptr(), w.data_ptr(),
                        dims_dev.data_ptr(), dims_host, out.data_ptr(), b, e, 16, 4, 32, 1,
                        len(dims), w.numel(), *codes, isb(both), isb(es), isb(ev), cdt, stream())
                    assert err == 0, err
                return call

            def bwd(v):
                def call():
                    err = v.lib.k5_message_bwd(
                        both.data_ptr(), es.data_ptr(), ev.data_ptr(), w.data_ptr(),
                        dims_dev.data_ptr(), dims_host, dout.data_ptr(), dboth.data_ptr(),
                        des.data_ptr(), dev.data_ptr(), partial[v.tag].data_ptr(), dw.data_ptr(),
                        b, e, 16, 4, 32, 1, len(dims), w.numel(), *codes, isb(both), isb(es),
                        isb(ev), isb(dout), cdt, stream())
                    assert err == 0, err
                return call

            in_bytes = sum(t.numel() * t.element_size() for t in (both, es, ev)) + 4 * w.numel()
            out_bytes = b * e * 28 * both.element_size()
            bound = (2 * in_bytes + out_bytes) / chip_smoke.HBM_BYTES_PER_S * 1e3
            dtypes = sum(isb(t) << k for k, t in enumerate((both, es, ev, dout)))
            kernels = ", ".join(
                f"{v.tag} {v.bwd_kernel(dims_host, len(dims), cdt, codes, dtypes)} "
                f"({v.bwd_smem(dims_host, len(dims), cdt)} bytes of shared memory a block)"
                for v in versions)
            timed(f"K5 bwd {label} {kind} B={b} E={e}", {v.tag: bwd(v) for v in versions},
                  f"bound {bound:.4f} ms (bytes); kernels: {kernels}")
            for v in versions:   # the call's two launches apart
                per_kernel, _ = chip_smoke.profile_forward(torch, bwd(v), n=5)
                print(f"  {v.tag} K5 bwd launches (torch.profiler, ms a call): " + ", ".join(
                    f"{kernel_name(name)} {ms:.4f}" for name, ms in per_kernel.items()))
            bound_f = (in_bytes + out_bytes) / chip_smoke.HBM_BYTES_PER_S * 1e3
            kernels_f = ", ".join(
                f"{v.tag} {v.fwd_kernel(dims_host, len(dims), cdt, codes, dtypes)} "
                f"({v.fwd_smem(dims_host, len(dims), cdt)} bytes of shared memory a block)"
                for v in versions)
            timed(f"K5 fwd {label} {kind} B={b} E={e}", {v.tag: fwd(v) for v in versions},
                  f"bound {bound_f:.4f} ms (bytes); kernels: {kernels_f}")
        table = torch.randn(b, size["n_p"], 28, generator=gen, device="cuda")
        for src, dst in ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                         (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)):
            x = table.to(src)
            y = torch.empty(x.shape, dtype=dst, device="cuda")

            def k6(v):
                def call():
                    err = v.lib.k6_cast_copy(x.data_ptr(), y.data_ptr(), x.numel(), isb(x), isb(y),
                                             stream())
                    assert err == 0, err
                return call

            lib_ms = [chip_smoke.graph_time_ms(torch, lambda: x.to(dst, copy=True))
                      for _ in range(2)]
            nbytes = x.numel() * (x.element_size() + y.element_size())
            timed(f"K6 {label} table {tuple(x.shape)} {str(src)[6:]}->{str(dst)[6:]}",
                  {v.tag: k6(v) for v in versions},
                  f"Tensor.to {lib_ms[0]:.4f} / {lib_ms[1]:.4f} ms, bound "
                  f"{nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3:.4f} ms (bytes)")
            if label == "flagship":
                kinds, _ = chip_smoke.profile_forward(torch, lambda: x.to(dst, copy=True), n=1)
                print(f"  Tensor.to {str(src)[6:]}->{str(dst)[6:]} launches: {sorted(kinds)}")
    floor = [chip_smoke.graph_time_ms(torch, lambda: empty.k0_empty(stream())) for _ in range(4)]
    print(f"empty kernel (launch floor): {' / '.join(f'{t:.4f}' for t in floor)} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
