#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA
H100 and check them.

    python3 chip_smoke.py

Phases, each printed before it starts and after it ends with its wall time:

1. device: needs CUDA; prints the card and ``nvidia-smi``'s name and power limit.
2. build: builds ``caster_dta_torch/csrc/segment.cu`` with nvcc for sm_90a and
   prints ptxas's register and shared-memory lines.
3. kernels: K1 (sorted segment-sum) and K2 (row gather) on the card, at the
   shapes of the served model, against their plain PyTorch versions on the
   same inputs: K2 must be bit-exact, K1 within K1_RTOL/K1_ATOL.
4. serve: loads the trained ``runs/davis_seed9`` model onto the card, answers
   seeded synthetic requests at two buckets, checks that the K1 and K2 launch
   counts rose by the expected launches per forward, that the affinities are
   finite and that they match the port's CPU run, times each request (batch
   copy and forward apart, CUDA events) and profiles the forward's kernels
   (torch.profiler): device time per forward, idle share, time by group.
5. k3: K3 (unsorted scatter-add, the gathers' backward) against its plain
   version on the CPU (same edge order) at the merged src||dst backward of the flagship and Davis buckets
   and the molecule widths, f32 and bf16, and on edge cases (repeated ids,
   all ids on one row, empty rows, E and N off any block, N = 6000), within
   K3_RTOL/K3_ATOL.
6. autograd: gather_nodes and segment_sum (ops/segment.py) at the flagship
   shapes: their gradients on the card against the same Functions on the
   CPU, f32 and bf16, within GRAD_TOL.
7. train: a bf16 Adam Trainer (lr 1e-4) from the runs/davis_seed9 weights at
   the flagship bucket; median step time over TRAIN_STEPS steps (CUDA
   events), protein edges/s, kernel time per step, idle share and kernel
   groups (torch.profiler); K1/K2/K3 launches per step against the counts the
   model's code gives; the eval-mode loss on the batch before and after the
   steps (it must fall); one f32 step's gradients (TF32 off, dropout off)
   card against CPU within STEP_GRAD_RTOL of each gradient's largest entry
   plus STEP_GRAD_ATOL of the largest over all.
8. fit: two epochs of ``fit`` on a seeded synthetic dataset of FIT_PAIRS
   pairs in two buckets near the flagship sizes, checkpoints and run
   artifacts in a temporary directory, then ``load_run`` serves the best-val
   checkpoint on the card.
9. times: each kernel, its plain version and the one PyTorch call that
   computes the same function, replayed from CUDA graphs and timed with CUDA
   events, beside the least time the card could take (bytes over 3.35 TB/s).

Every CPU reference that a card result is held against is computed twice
and taken only when the two runs give the same bits (``cpu_reference``).

Any failure raises and the script exits non-zero. On success the line before
the last is ``{"kernels": [...]}``, whose launch counts are those of the
training phases, and the last is ``{"ok": true, "device": {...}}``. Without
CUDA it exits 1 and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(HERE, "runs", "davis_seed9")
# bench.py's flagship bucket and the Davis bucket of the JAX package's
# segment-kernel measurements; both with drug-size molecules
FLAGSHIP = dict(b=32, n_p=512, e_p=4096, n_m=64, e_m=256)
DAVIS = dict(b=128, n_p=768, e_p=4096, n_m=64, e_m=256)
N_REQUESTS_FLAGSHIP = 4

# H100 SXM data sheet: HBM3 bandwidth, f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# K1 sums in edge order in f32; the plain index_add_ on the card sums the same
# terms in atomic order. A row holds at most a few dozen N(0, 1) terms, so the
# orders differ by a few ulps of the row sum.
K1_RTOL, K1_ATOL = 1e-5, 1e-5
# Card against CPU on the whole served model: cuBLAS and the CPU's BLAS sum
# the f32 matmuls in different orders. Affinities are in pKd units.
AFFINITY_ATOL = 1e-4
ATTENTION_ATOL = 1e-5
F32_OVERRIDES = ("TORCH_ALLOW_TF32_CUBLAS_OVERRIDE", "ONEDNN_DEFAULT_FPMATH_MODE",
                 "DNNL_DEFAULT_FPMATH_MODE")

# K3 sums in edge order in f32, as the plain version (index_add_) does on the
# CPU; on the card index_add_ adds in atomic order, which moves the padding
# rows (N-1 and 0 take ~1,400 terms each at the flagship bucket) by up to
# ~1e-4. So K3 is held against the plain version on the CPU, same inputs.
K3_RTOL, K3_ATOL = 1e-5, 1e-5
# Autograd card vs CPU: f32 gradients are the same sums in another order;
# bf16 gradients are rounded once from such f32 sums, so they may differ by
# one bf16 ulp (2**-8 relative).
GRAD_TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2 ** -7, atol=2 ** -7)}
# One f32 training step of the whole model, card vs CPU: cuBLAS and the CPU's
# BLAS order the f32 sums differently through ~40 layers forward and back.
# Each parameter's gradient is held to STEP_GRAD_RTOL of its own largest entry
# plus STEP_GRAD_ATOL of the largest entry over all parameters: three
# gradients of the trained model (the edge GVP's wv and its gate wsv) are 0 in
# exact arithmetic (1e-17 in f64: the one edge vector channel is divided by
# its own norm, so its scale cancels) and come out as f32 rounding noise of
# ~1e-9 on either device, which no relative bound can hold.
STEP_GRAD_RTOL, STEP_GRAD_ATOL = 1e-4, 1e-8
TRAIN_STEPS = 20
FIT_PAIRS = 320

K1_REPLACES = "caster_dta_tpu/ops/pallas_segment.py:131"   # _segment_kernel_t
K2_REPLACES = "caster_dta_tpu/ops/pallas_segment.py:540"   # _onehot_gather_kernel
K3_REPLACES = "caster_dta_tpu/ops/pallas_segment.py:268"   # _scatter_fullN_kernel
SOURCE = "caster_dta_torch/csrc/segment.cu"


@contextlib.contextmanager
def phase(name: str):
    print(f"== phase {name}: start", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== phase {name}: done in {time.perf_counter() - t0:.2f} s", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def graph_time_ms(torch, fn, launches: int = 20, replays: int = 7) -> float:
    """Median device time of one ``fn()`` call: ``launches`` calls captured in
    one CUDA graph, each replay timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def event_times_ms(torch, fn, reps: int = 20, warmup: int = 3) -> list:
    """Sorted wall times on the card's clock of ``reps`` calls of ``fn``,
    each between two CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)


KERNEL_GROUPS = (("K1 segment-sum", "segment_sum_sorted"), ("K2 gather", "gather_rows"),
                 ("K3 scatter", "scatter_rows"), ("matmul", "gemm"),
                 ("layernorm", "layer_norm"), ("concat", "CatArray"), ("softmax", "softmax"),
                 ("optimizer", "multi_tensor_apply"), ("reduction", "reduce_kernel"),
                 ("copy", "Memcpy"))


def profile_forward(torch, forward, n: int = 5):
    """Device kernels of ``n`` calls of ``forward`` under torch.profiler
    -> ({kernel name: device ms per call}, kernel launches per call)."""
    from torch.profiler import ProfilerActivity, profile

    forward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            forward()
        torch.cuda.synchronize()
    per_kernel, launches = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
            launches += 1
    return per_kernel, launches / n


def kernel_groups(per_kernel: dict) -> dict:
    groups = {}
    for name, ms in per_kernel.items():
        group = next((g for g, key in KERNEL_GROUPS if key in name), "elementwise and other")
        groups[group] = groups.get(group, 0.0) + ms
    return dict(sorted(groups.items(), key=lambda kv: -kv[1]))


def kernel_cases(torch, batch, gen, dev="cuda"):
    """K1/K2 inputs at the served model's shapes, from a request's graphs:
    the merged src||dst gather of the GVP convs ([B, N, 16 + 3*4] rows) and
    the GINE gathers ([B, N, 51] and [B, N, 16]), the segment-sums of both."""
    p, m = batch.protein.to(dev), batch.molecule.to(dev)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    b = p.batch_size
    return {
        "K2": [
            ("protein merged gather", randn(b, p.n_pad, 28), torch.cat([p.edge_src, p.edge_dst], 1)),
            ("molecule gather, layer 1", randn(b, m.n_pad, 51), m.edge_src),
            ("molecule gather, layer 2", randn(b, m.n_pad, 16), m.edge_src),
        ],
        "K1": [
            ("protein aggregation", randn(b, p.e_pad, 28), p.edge_dst, p.edge_mask, p.n_pad),
            ("molecule aggregation, layer 1", randn(b, m.e_pad, 51), m.edge_dst, m.edge_mask, m.n_pad),
            ("molecule aggregation, layer 2", randn(b, m.e_pad, 16), m.edge_dst, m.edge_mask, m.n_pad),
        ],
    }


def edge_cases(torch, gen, dev="cuda"):
    """Empty destination rows, masked padding edges at dst = N-1, N and E not
    multiples of any block, a single graph, and no edges at all."""
    out = []
    for b, n, e_real, e_pad, f in [(3, 77, 500, 1000, 28), (1, 33, 31, 64, 5), (2, 40, 0, 16, 9)]:
        # real edges land on the even rows below n // 2 only: the odd rows and
        # the upper half stay empty
        dst = torch.randint(0, max(n // 4, 1), (b, e_real), generator=gen, device=dev) * 2
        dst = torch.sort(dst, dim=1).values
        pad = torch.full((b, e_pad - e_real), n - 1, device=dev, dtype=dst.dtype)
        dst = torch.cat([dst, pad], 1).to(torch.int32).contiguous()
        mask = torch.zeros(b, e_pad, dtype=torch.bool, device=dev)
        mask[:, :e_real] = True
        msgs = torch.randn(b, e_pad, f, generator=gen, device=dev)
        out.append((f"B{b} N{n} E{e_pad} F{f}, {e_real} real edges", msgs, dst, mask, n))
    return out


def k3_cases(torch, batch, gen, dev="cuda"):
    """K3 inputs at the shapes training gives it: the cotangent of the merged
    src||dst gather of the GVP convs ([B, 2E, 16 + 3*4] rows scattered into N
    protein rows) and of the GINE x_j gathers ([B, E, 51] and [B, E, 16])."""
    p, m = batch.protein.to(dev), batch.molecule.to(dev)
    b = p.batch_size

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    return [
        ("protein merged backward", randn(b, 2 * p.e_pad, 28),
         torch.cat([p.edge_src, p.edge_dst], 1), p.n_pad),
        ("molecule backward, F=51", randn(b, m.e_pad, 51), m.edge_src, m.n_pad),
        ("molecule backward, F=16", randn(b, m.e_pad, 16), m.edge_src, m.n_pad),
    ]


def k3_edge_cases(torch, gen, dev="cuda"):
    """Repeated ids, all ids on one row, empty rows (ids only on the even rows
    below N/2), E and N off any block, N above the JAX package's 4096 split,
    and no edges."""
    def ids(b, e, n, kind):
        if kind == "one row":
            return torch.full((b, e), n // 3, device=dev, dtype=torch.int32)
        if kind == "empty rows":
            return (torch.randint(0, max(n // 4, 1), (b, e), generator=gen, device=dev)
                    * 2).to(torch.int32)
        if kind == "repeated":
            return torch.randint(0, 3, (b, e), generator=gen, device=dev, dtype=torch.int32)
        return torch.randint(0, n, (b, e), generator=gen, device=dev, dtype=torch.int32)

    out = []
    for b, e, n, f, kind in [(4, 2000, 300, 28, "repeated"), (3, 1000, 77, 5, "one row"),
                             (2, 515, 130, 70, "empty rows"), (1, 33, 31, 9, "uniform"),
                             (2, 8192, 6000, 28, "uniform"), (2, 0, 9, 4, "uniform")]:
        out.append((f"B{b} E{e} N{n} F{f} {kind}",
                    torch.randn(b, e, f, generator=gen, device=dev), ids(b, e, n, kind), n))
    return out


def _tensors(x):
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    return [x]


CPU_REFERENCES = {"taken": 0, "third run": 0}


def cpu_reference(torch, fn, what: str):
    """``fn()`` run on the CPU, taken as a reference once two runs give the
    same bits. On the card's machine the first served request has twice in
    some thirty runs been 3.5e-4 pKd from the CPU's answer while two card
    answers to it agreed bit for bit, and no later request or run repeated
    it. A third run breaks a tie; three different answers fail the check."""
    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(_tensors(a), _tensors(b)))

    first, second = fn(), fn()
    CPU_REFERENCES["taken"] += 1
    if same(first, second):
        return first
    third = fn()
    if not (same(third, first) or same(third, second)):
        raise AssertionError(f"{what}: the CPU reference differs on each of three runs")
    CPU_REFERENCES["third run"] += 1
    print(f"{what}: two CPU runs differed; a third agreed with one of them", file=sys.stderr)
    return third


def main() -> int:
    # The card-vs-CPU checks hold IEEE f32 against IEEE f32. These variables
    # let cuBLAS (TF32) or oneDNN (BF16) round the inputs of f32 matmuls, which
    # moves the affinities by ~1e-3 for a reason that is not the port's; they
    # are read once, at the first matmul, so they go before torch is imported.
    overridden = {v: os.environ.pop(v) for v in F32_OVERRIDES if v in os.environ}
    import torch

    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from caster_dta_torch.data.batching import (BucketedLoader, dataset_budgets,
                                                synthetic_pair_batch, synthetic_pair_dataset)
    from caster_dta_torch.inference.serve import load_run, predict
    from caster_dta_torch.models.joint import make_joint_gnn
    from caster_dta_torch.ops import cuda_segment as cs
    from caster_dta_torch.ops import segment
    from caster_dta_torch.train import checkpoints
    from caster_dta_torch.train.loop import Trainer, TrainConfig, fit, split_dataset

    with phase("device"):
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi()
        print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}; "
              f"{torch.cuda.device_count()} visible")
        print(f"nvidia-smi: {smi}")
        print(f"f32 matmuls: precision {torch.get_float32_matmul_precision()}, TF32 in "
              f"cuBLAS {torch.backends.cuda.matmul.allow_tf32}, in cuDNN "
              f"{torch.backends.cudnn.allow_tf32}; removed from the environment: "
              f"{overridden or 'nothing'}; CPU threads {torch.get_num_threads()}")

    with phase("build"):
        built = cs.load_library()
        for line in built.log.splitlines():
            if "ptxas" in line and ("registers" in line or "Compiling entry" in line):
                print(line)
        print(f"built {os.path.relpath(built.path, HERE)} in {built.seconds:.2f} s "
              f"({'cached' if built.seconds == 0 else 'nvcc'})")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    requests = [(f"flagship #{i}", synthetic_pair_batch(**FLAGSHIP, seed=i))
                for i in range(N_REQUESTS_FLAGSHIP)]
    requests.append(("davis", synthetic_pair_batch(**DAVIS, seed=N_REQUESTS_FLAGSHIP)))
    max_err = {"K1": 0.0, "K2": 0.0, "K3": 0.0}

    with phase("kernels"), torch.no_grad():
        for label, batch in (requests[0], requests[-1]):
            cases = kernel_cases(torch, batch, gen)
            for name, table, idx in cases["K2"]:
                for dtype in (torch.float32, torch.bfloat16):
                    t = table.to(dtype)
                    got = cs.gather_rows(t, idx)
                    torch.cuda.synchronize()
                    want = cs.gather_rows_plain(t, idx)
                    if not torch.equal(got, want):
                        raise AssertionError(f"K2 {label} {name} {dtype}: not bit-exact")
                    err = (got.float() - want.float()).abs().max().item()
                    max_err["K2"] = max(max_err["K2"], err)
                print(f"K2 {label} {name}: table {tuple(table.shape)} idx {tuple(idx.shape)} "
                      f"bit-exact (f32, bf16)")
            for name, msgs, dst, mask, n in cases["K1"]:
                for dtype in (torch.float32, torch.bfloat16):
                    m = msgs.to(dtype)
                    got = cs.segment_sum_sorted(m, dst, mask, n)
                    torch.cuda.synchronize()
                    want = cs.segment_sum_sorted_plain(m, dst, mask, n)
                    torch.testing.assert_close(got, want, rtol=K1_RTOL, atol=K1_ATOL)
                    err = (got - want).abs().max().item()
                    max_err["K1"] = max(max_err["K1"], err)
                    print(f"K1 {label} {name} {str(dtype)[6:]}: msgs {tuple(msgs.shape)} -> "
                          f"N={n} max_abs_err {err:.3e}")
        for name, msgs, dst, mask, n in edge_cases(torch, gen):
            for dtype in (torch.float32, torch.bfloat16):
                m = msgs.to(dtype)
                got = cs.segment_sum_sorted(m, dst, mask, n)
                torch.cuda.synchronize()
                want = cs.segment_sum_sorted_plain(m, dst, mask, n)
                torch.testing.assert_close(got, want, rtol=K1_RTOL, atol=K1_ATOL)
                empty = want.abs().sum(-1) == 0
                if not torch.all(got[empty] == 0):
                    raise AssertionError(f"K1 edge case {name}: an empty row is not 0")
                max_err["K1"] = max(max_err["K1"], (got - want).abs().max().item())
            table = torch.randn(msgs.shape[0], n, msgs.shape[2], generator=gen, device="cuda")
            idx = torch.randint(0, n, (msgs.shape[0], msgs.shape[1] + 3), generator=gen,
                                device="cuda", dtype=torch.int32)
            if not torch.equal(cs.gather_rows(table, idx), cs.gather_rows_plain(table, idx)):
                raise AssertionError(f"K2 edge case {name}: not bit-exact")
            torch.cuda.synchronize()
            print(f"edge case {name}: K1 within tolerance, empty rows 0; K2 bit-exact")
        print(f"K1 max_abs_err {max_err['K1']:.3e} (rtol {K1_RTOL}, atol {K1_ATOL}); "
              f"K2 max_abs_err {max_err['K2']:.1e} (bit-exact)")

    with phase("serve"):
        run = load_run(RUN_DIR, device="cuda")
        print(f"loaded {os.path.relpath(run.param_file, HERE)}")
        model = run.model
        n_convs = (len(model.protein_gnn.gnn_model.conv_list)
                   + len(model.molecule_gnn.gnn_model.conv_list))
        # aggr 'sum': one K1 and one K2 per conv; no backward, so no K3
        per_forward = {cs.K1: n_convs, cs.K2: n_convs, cs.K3: 0}
        answers = []
        cs.reset_launches()
        for label, batch in requests:
            answers.append(predict(run, batch))
        torch.cuda.synchronize()
        launches = dict(cs.LAUNCHES)
        want = {k: v * len(requests) for k, v in per_forward.items()}
        print(f"launches over {len(requests)} requests: {launches} (expected {want})")
        if launches != want:
            raise AssertionError(f"launch counts {launches} != expected {want}")

        run_cpu = load_run(RUN_DIR, device="cpu")
        worst = {"affinity": 0.0, "attention": 0.0}
        disagree = []
        for (label, batch), (aff, attn) in zip(requests, answers):
            aff = aff.cpu()
            if aff.shape != (batch.protein.batch_size,) or not torch.isfinite(aff).all():
                raise AssertionError(f"{label}: affinities {tuple(aff.shape)} not finite")
            aff_cpu, attn_cpu = cpu_reference(torch, lambda: predict(run_cpu, batch), label)
            d_aff = (aff - aff_cpu).abs().max().item()
            d_att = max((a.cpu() - c).abs().max().item() for a, c in zip(attn, attn_cpu))
            worst["affinity"] = max(worst["affinity"], d_aff)
            worst["attention"] = max(worst["attention"], d_att)
            print(f"{label} {batch.bucket}: B={len(aff)} affinity range "
                  f"[{aff.min().item():.4f}, {aff.max().item():.4f}] finite; vs CPU "
                  f"max|d affinity| {d_aff:.3e}, max|d attention| {d_att:.3e}")
            if d_aff > AFFINITY_ATOL or d_att > ATTENTION_ATOL:
                # a second card answer to the same request tells a card that
                # disagrees with itself from one that computes something else
                again = predict(run, batch)[0].cpu()
                disagree.append(f"{label}: max|d affinity| {d_aff:.3e}, max|d attention| "
                                f"{d_att:.3e}, card again vs card first "
                                f"{(again - aff).abs().max().item():.3e}")
        if disagree:
            print("card and CPU disagree:\n  " + "\n  ".join(disagree), file=sys.stderr)
            raise AssertionError(f"{len(disagree)} of {len(requests)} requests: card and CPU "
                                 f"disagree beyond {AFFINITY_ATOL} / {ATTENTION_ATOL}")
        print(f"card vs CPU over all requests: max|d affinity| {worst['affinity']:.3e} "
              f"(atol {AFFINITY_ATOL}), max|d attention| {worst['attention']:.3e} "
              f"(atol {ATTENTION_ATOL})")

        for label, batch in (requests[0], requests[-1]):
            on_card = batch.to("cuda")
            request = event_times_ms(torch, lambda: predict(run, batch))
            copy = event_times_ms(torch, lambda: batch.to("cuda"))
            forward = event_times_ms(torch, lambda: predict(run, on_card))
            print(f"request latency {label} {batch.bucket} B={batch.protein.batch_size}: "
                  f"median {statistics.median(request):.3f} ms (min {request[0]:.3f}, max "
                  f"{request[-1]:.3f}) over {len(request)}; of which batch copy to the card "
                  f"median {statistics.median(copy):.3f} ms and forward on a card-resident "
                  f"batch median {statistics.median(forward):.3f} ms (CUDA events)")
            per_kernel, n_kernels = profile_forward(torch, lambda: predict(run, on_card))
            busy = sum(per_kernel.values())
            if busy == 0:
                print(f"device time {label}: not measured (the profiler saw no kernel)")
                continue
            print(f"device time {label}: {busy:.3f} ms in {n_kernels:.0f} kernels per forward, "
                  f"device idle {1 - busy / statistics.median(forward):.1%} of the forward "
                  f"(torch.profiler)")
            print(f"device time by group {label}: " + ", ".join(
                f"{g} {ms:.3f} ms ({ms / busy:.1%})" for g, ms in kernel_groups(per_kernel).items()))

    with phase("k3"), torch.no_grad():
        for label, batch in (requests[0], requests[-1]):
            for name, rows, ids, n in k3_cases(torch, batch, gen):
                for dtype in (torch.float32, torch.bfloat16):
                    r = rows.to(dtype)
                    got = cs.scatter_rows(r, ids, n).cpu()
                    want = cpu_reference(torch, lambda: cs.scatter_rows_plain(
                        r.cpu(), ids.cpu(), n), f"K3 {label} {name}")
                    torch.testing.assert_close(got, want, rtol=K3_RTOL, atol=K3_ATOL)
                    err = (got - want).abs().max().item()
                    max_err["K3"] = max(max_err["K3"], err)
                    print(f"K3 {label} {name} {str(dtype)[6:]}: rows {tuple(rows.shape)} -> "
                          f"N={n} max_abs_err {err:.3e}")
        for name, rows, ids, n in k3_edge_cases(torch, gen):
            for dtype in (torch.float32, torch.bfloat16):
                r = rows.to(dtype)
                got = cs.scatter_rows(r, ids, n).cpu()
                want = cpu_reference(torch, lambda: cs.scatter_rows_plain(
                    r.cpu(), ids.cpu(), n), f"K3 edge case {name}")
                torch.testing.assert_close(got, want, rtol=K3_RTOL, atol=K3_ATOL)
                if not torch.all(got[want.abs().sum(-1) == 0] == 0):
                    raise AssertionError(f"K3 edge case {name}: an empty row is not 0")
                if got.numel():
                    max_err["K3"] = max(max_err["K3"], (got - want).abs().max().item())
            print(f"K3 edge case {name}: within tolerance (f32, bf16), empty rows 0")
        print(f"K3 max_abs_err {max_err['K3']:.3e} against the plain version on the CPU "
              f"(rtol {K3_RTOL}, atol {K3_ATOL})")

    with phase("autograd"):
        cpu_gen = torch.Generator().manual_seed(3)
        p = requests[0][1].protein
        b, n, e = p.batch_size, p.n_pad, p.e_pad
        idx = torch.cat([p.edge_src, p.edge_dst], 1)
        w_g = torch.randn(b, 2 * e, 28, generator=cpu_gen)
        w_s = torch.randn(b, n, 28, generator=cpu_gen)
        for dtype in ("float32", "bfloat16"):
            table = torch.randn(b, n, 28, generator=cpu_gen).to(getattr(torch, dtype))
            msgs = torch.randn(b, e, 28, generator=cpu_gen).to(getattr(torch, dtype))

            def grads(dev):
                t = table.to(dev).requires_grad_()
                m = msgs.to(dev).requires_grad_()
                out_g = segment.gather_nodes(t, idx.to(dev))
                out_s = segment.segment_sum(m, p.edge_dst.to(dev), p.edge_mask.to(dev), n)
                loss = ((out_g.float() * w_g.to(dev)).sum()
                        + (out_s.float() * w_s.to(dev)).sum())
                return [g.cpu().float() for g in torch.autograd.grad(loss, (t, m))]

            card = grads("cuda")
            cpu = cpu_reference(torch, lambda: grads("cpu"), f"autograd {dtype}")
            for what, got, want in zip(("gather_nodes", "segment_sum"), card, cpu):
                torch.testing.assert_close(got, want, **GRAD_TOL[dtype])
                print(f"autograd {what} {dtype}: card vs CPU gradient max|d| "
                      f"{(got - want).abs().max().item():.3e} ({GRAD_TOL[dtype]})")
            if not torch.all(card[1][~p.edge_mask] == 0):
                raise AssertionError("segment_sum backward: a masked edge got a gradient")

    train_launches = {k: 0 for k in cs.LAUNCHES}
    with phase("train"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        label, batch = requests[0]
        on_card = batch.to("cuda")
        model = load_run(RUN_DIR, device="cuda").model
        p_tower, m_tower = model.protein_gnn.gnn_model, model.molecule_gnn.gnn_model
        n_p, n_m = len(p_tower.conv_list), len(m_tower.conv_list)
        # aggr 'sum': forward one K1 and one K2 per conv; backward one K2 per
        # K1 (its VJP) and one K3 per gather whose table needs a gradient:
        # every GVP conv's, and every GINE conv's after the first (the first
        # gathers the input features)
        per_step = {cs.K1: n_p + n_m, cs.K2: 2 * (n_p + n_m), cs.K3: n_p + n_m - 1}
        trainer = Trainer(model, TrainConfig(compute_dtype="bfloat16", optimizer="adam",
                                             lr=1e-4, seed=0), device="cuda")
        loss_before = trainer.eval_loss(on_card).item()
        cs.reset_launches()
        steps = event_times_ms(torch, lambda: trainer.train_step(on_card), reps=TRAIN_STEPS,
                               warmup=0)
        torch.cuda.synchronize()
        launches = dict(cs.LAUNCHES)
        want = {k: v * TRAIN_STEPS for k, v in per_step.items()}
        print(f"launches over {TRAIN_STEPS} training steps: {launches} (expected {want}: "
              f"{per_step} per step)")
        if launches != want:
            raise AssertionError(f"launch counts {launches} != expected {want}")
        loss_after = trainer.eval_loss(on_card).item()
        print(f"eval-mode loss on the batch: {loss_before:.6f} before, {loss_after:.6f} after "
              f"{TRAIN_STEPS} bf16 Adam steps")
        if not loss_after < loss_before:
            raise AssertionError("the eval loss did not fall over the training steps")
        step_ms = statistics.median(steps)
        p_edges = int(batch.protein.edge_mask.sum())
        m_edges = int(batch.molecule.edge_mask.sum())
        print(f"train step {label} {batch.bucket} B={batch.protein.batch_size} bf16 Adam: "
              f"median {step_ms:.3f} ms (min {steps[0]:.3f}, max {steps[-1]:.3f}) over "
              f"{len(steps)} steps (CUDA events); protein edges/s "
              f"{p_edges / step_ms * 1e3:.1f} ({p_edges} real protein edges per batch); "
              f"protein+molecule edges/s as bench.py counts them "
              f"{(p_edges + m_edges) / step_ms * 1e3:.1f}")
        per_kernel, n_kernels = profile_forward(torch, lambda: trainer.train_step(on_card))
        busy = sum(per_kernel.values())
        if busy == 0:
            print("train device time: not measured (the profiler saw no kernel)")
        else:
            print(f"train device time: {busy:.3f} ms in {n_kernels:.0f} kernels per step, "
                  f"device idle {1 - busy / step_ms:.1%} of the median step (torch.profiler)")
            print("train device time by group: " + ", ".join(
                f"{g} {ms:.3f} ms ({ms / busy:.1%})" for g, ms in kernel_groups(per_kernel).items()))
        for k, v in cs.LAUNCHES.items():
            train_launches[k] += v

        # one f32 step's gradients, card vs CPU, same weights and batch,
        # dropout off (the two devices' generators differ)
        def step_grads(dev):
            m = load_run(RUN_DIR, device=dev).model          # eval mode: no dropout
            params = dict(m.named_parameters())
            loss, _ = Trainer(m, TrainConfig(), device=dev).loss(batch.to(dev))
            return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

        grads = {"cuda": step_grads("cuda"),
                 "cpu": cpu_reference(torch, lambda: step_grads("cpu"), "f32 step gradients")}
        top = max(g.abs().max().item() for g in grads["cpu"].values())
        worst, noise = 0.0, []
        for name, g_cpu in grads["cpu"].items():
            d = (grads["cuda"][name].cpu() - g_cpu).abs().max().item()
            scale = g_cpu.abs().max().item()
            if d > STEP_GRAD_RTOL * scale + STEP_GRAD_ATOL * top:
                raise AssertionError(f"f32 gradient of {name}: card vs CPU max|d| {d:.3e} > "
                                     f"{STEP_GRAD_RTOL} x max|g| {scale:.3e} + "
                                     f"{STEP_GRAD_ATOL} x {top:.3e}")
            if d > STEP_GRAD_RTOL * scale:
                noise.append(f"{name} (max|g| {scale:.2e}, max|d| {d:.2e})")
            else:
                worst = max(worst, d / scale if scale else 0.0)
        print(f"f32 step gradients, card vs CPU (TF32 off, dropout off): {len(grads['cpu'])} "
              f"parameters; largest entry {top:.4e}; worst max|d grad| / max|grad| "
              f"{worst:.3e} (limit {STEP_GRAD_RTOL}) over {len(grads['cpu']) - len(noise)}; "
              f"held by the absolute term ({STEP_GRAD_ATOL} x {top:.3e}): {noise or 'none'}")

    with phase("fit"):
        # half the proteins 400-500 residues (the 512-node, 4096-edge bucket),
        # half 200-250 (256 nodes, 2048 edges); molecules of 20-46 atoms
        dataset = synthetic_pair_dataset(FIT_PAIRS, 40, 30, [(400, 500), (200, 250)], (20, 46))
        kw = json.load(open(os.path.join(RUN_DIR, "model_kwargs.json")))
        max_num, _ = dataset_budgets("davis")
        train_idx, _, _ = split_dataset(dataset, 0)
        buckets = BucketedLoader(dataset, train_idx, max_num=max_num,
                                 max_batch_size=FLAGSHIP["b"], coalesce_min_batches=2).buckets()
        print(f"fit train buckets (N_P, E_P, N_M, E_M): pairs "
              f"{ {b: len(i) for b, i in sorted(buckets.items())} }")
        if len(buckets) < 2:
            raise AssertionError("the fit dataset should fill at least two buckets")
        cs.reset_launches()
        with tempfile.TemporaryDirectory() as out:
            checkpoints.save_run_artifacts(out, {"dataset": "synthetic", "n_pairs": FIT_PAIRS},
                                           dataset.rescale_params(), kw["protein_gnn_kwargs"],
                                           kw["molecule_gnn_kwargs"], kw["joint_gnn_kwargs"])
            model = make_joint_gnn(kw["protein_gnn_kwargs"], kw["molecule_gnn_kwargs"],
                                   generator=torch.Generator().manual_seed(0),
                                   **kw["joint_gnn_kwargs"])
            t0 = time.perf_counter()
            res = fit(model, dataset, "synthetic", out,
                      TrainConfig(n_epochs=2, compute_dtype="bfloat16", seed=0),
                      max_num=max_num, max_batch_size=FLAGSHIP["b"], device="cuda",
                      ladder_kwargs={"coalesce_min_batches": 2})
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            print(f"fit: 2 epochs in {fit_s:.2f} s, {res['throughput']['total_steps']} steps, "
                  f"history {[(h['train'], h['val']) for h in res['history']]}, test "
                  f"{res['test_metrics']}")
            for k, v in cs.LAUNCHES.items():
                train_launches[k] += v
            names = sorted(os.listdir(out))
            print(f"fit wrote {names}")
            run = load_run(out, device="cuda")
            aff, _ = predict(run, batch)
            aff = aff.cpu()
            if aff.shape != (batch.protein.batch_size,) or not torch.isfinite(aff).all():
                raise AssertionError(f"served fit checkpoint: affinities {tuple(aff.shape)} "
                                     "not finite")
            print(f"load_run served {os.path.basename(run.param_file)} on the card: "
                  f"affinities [{aff.min().item():.4f}, {aff.max().item():.4f}] finite")
        print(f"launches over the training phases: {train_launches}")

    with phase("times"), torch.no_grad():
        rows = {}
        for label, batch in (requests[0], requests[-1]):
            cases = kernel_cases(torch, batch, gen)
            for name, table, idx in cases["K2"]:
                b, n, f = table.shape
                e = idx.shape[1]
                out = torch.empty(b, e, f, device="cuda")
                flat = table.reshape(b * n, f)
                rows_g = (idx.long() + n * torch.arange(b, device="cuda")[:, None]).reshape(-1)
                ms = graph_time_ms(torch, lambda: cs.gather_rows(table, idx))
                plain = graph_time_ms(torch, lambda: cs.gather_rows_plain(table, idx))
                lib = graph_time_ms(torch, lambda: torch.index_select(flat, 0, rows_g, out=out.view(b * e, f)))
                # the table rows that idx references, each read once
                n_rows = int(torch.unique(rows_g).numel())
                nbytes = idx.numel() * 4 + n_rows * f * 4 + b * e * f * 4
                rows[("K2", label, name)] = (ms, plain, lib, nbytes, 0)
            for name, msgs, dst, mask, n in cases["K1"]:
                b, e, f = msgs.shape
                out = torch.empty(b * n, f, device="cuda")
                flat = torch.where(mask[..., None], msgs, 0.0).reshape(b * e, f)
                rows_s = (dst.long() + n * torch.arange(b, device="cuda")[:, None]).reshape(-1)

                def library():
                    out.zero_()
                    out.index_add_(0, rows_s, flat)

                ms = graph_time_ms(torch, lambda: cs.segment_sum_sorted(msgs, dst, mask, n))
                plain = graph_time_ms(torch, lambda: cs.segment_sum_sorted_plain(msgs, dst, mask, n))
                lib = graph_time_ms(torch, library)
                # only the real edges' message rows are needed (the kernel
                # reads no masked row); dst and mask are read whole
                n_real = int(mask.sum().item())
                nbytes = (n_real * f * msgs.element_size() + dst.numel() * 4
                          + mask.numel() + b * n * f * 4)
                ops = n_real * f
                rows[("K1", label, name)] = (ms, plain, lib, nbytes, ops)
            for name, r32, ids, n in k3_cases(torch, batch, gen):
                b, e, f = r32.shape
                gids = (ids.long() + n * torch.arange(b, device="cuda")[:, None]).reshape(-1)
                out = torch.empty(b * n, f, device="cuda")
                for dtype in (torch.bfloat16, torch.float32):
                    r = r32.to(dtype)

                    def library():   # the f32 sum needs f32 rows: the cast is part of it
                        out.zero_()
                        out.index_add_(0, gids, r.reshape(b * e, f).float())

                    ms = graph_time_ms(torch, lambda: cs.scatter_rows(r, ids, n))
                    plain = graph_time_ms(torch, lambda: cs.scatter_rows_plain(r, ids, n))
                    lib = graph_time_ms(torch, library)
                    # every row counts (no mask) and every output row is written
                    nbytes = r.numel() * r.element_size() + ids.numel() * 4 + b * n * f * 4
                    rows[("K3", label, f"{name} {str(dtype)[6:]}")] = (ms, plain, lib, nbytes,
                                                                       b * e * f)
        for (k, label, name), (ms, plain, lib, nbytes, ops) in rows.items():
            bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
            print(f"time {k} {label} {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                  f"library {lib:.4f} ms, bound {bound:.4f} ms ({nbytes} bytes), "
                  f"{bound / ms:.1%} of bound")

    def entry(k, name, counter, replaces, shape):
        ms, plain, lib, nbytes, ops = rows[(k, "flagship #0", shape)]
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = ops / F32_OPS_PER_S * 1e3
        return {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
                "launches": train_launches[counter], "max_abs_err": max_err[k],
                "ms": ms, "plain_ms": plain, "bound_ms": max(byte_ms, op_ms),
                "bound_by": "bytes" if byte_ms >= op_ms else "operations", "library_ms": lib}

    kernels = [
        entry("K1", "K1 sorted segment-sum", cs.K1, K1_REPLACES, "protein aggregation"),
        entry("K2", "K2 row gather", cs.K2, K2_REPLACES, "protein merged gather"),
        entry("K3", "K3 unsorted scatter-add", cs.K3, K3_REPLACES,
              "protein merged backward bfloat16"),
    ]
    if not all(k["launches"] > 0 for k in kernels):
        raise AssertionError(f"a kernel of the training path never launched: {train_launches}")
    for k in kernels:
        if not all(math.isfinite(k[x]) for x in ("ms", "plain_ms", "bound_ms", "library_ms")):
            raise AssertionError(f"non-finite time in {k}")
    print(f"CPU references: {CPU_REFERENCES['taken']} taken, each from two runs with the "
          f"same bits; {CPU_REFERENCES['third run']} needed a third run")
    print(nvidia_smi())   # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
