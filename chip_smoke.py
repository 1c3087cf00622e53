#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA H100 and check it.

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
5. times: each kernel, its plain version and the one PyTorch call that
   computes the same function, replayed from CUDA graphs and timed with CUDA
   events, beside the least time the card could take (bytes over 3.35 TB/s).

Any failure raises and the script exits non-zero. On success the line before
the last is ``{"kernels": [...]}`` and the last is
``{"ok": true, "device": {...}}``. Without CUDA it exits 1 and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
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

K1_REPLACES = "caster_dta_tpu/ops/pallas_segment.py:131"   # _segment_kernel_t
K2_REPLACES = "caster_dta_tpu/ops/pallas_segment.py:540"   # _onehot_gather_kernel
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
                 ("matmul", "gemm"), ("layernorm", "layer_norm"), ("concat", "CatArray"),
                 ("softmax", "softmax"), ("copy", "Memcpy"))


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from caster_dta_torch.data.batching import synthetic_pair_batch
    from caster_dta_torch.inference.serve import load_run, predict
    from caster_dta_torch.ops import cuda_segment as cs

    with phase("device"):
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi()
        print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}; "
              f"{torch.cuda.device_count()} visible")
        print(f"nvidia-smi: {smi}")

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
    max_err = {"K1": 0.0, "K2": 0.0}

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
        per_forward = {cs.K1: n_convs, cs.K2: n_convs}  # aggr 'sum': one of each per conv
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
        for (label, batch), (aff, attn) in zip(requests, answers):
            aff = aff.cpu()
            if aff.shape != (batch.protein.batch_size,) or not torch.isfinite(aff).all():
                raise AssertionError(f"{label}: affinities {tuple(aff.shape)} not finite")
            aff_cpu, attn_cpu = predict(run_cpu, batch)
            d_aff = (aff - aff_cpu).abs().max().item()
            d_att = max((a.cpu() - c).abs().max().item() for a, c in zip(attn, attn_cpu))
            worst["affinity"] = max(worst["affinity"], d_aff)
            worst["attention"] = max(worst["attention"], d_att)
            print(f"{label} {batch.bucket}: B={len(aff)} affinity range "
                  f"[{aff.min().item():.4f}, {aff.max().item():.4f}] finite; vs CPU "
                  f"max|d affinity| {d_aff:.3e}, max|d attention| {d_att:.3e}")
            if d_aff > AFFINITY_ATOL or d_att > ATTENTION_ATOL:
                raise AssertionError(f"{label}: card and CPU disagree beyond "
                                     f"{AFFINITY_ATOL} / {ATTENTION_ATOL}")
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
                "launches": launches[counter], "max_abs_err": max_err[k],
                "ms": ms, "plain_ms": plain, "bound_ms": max(byte_ms, op_ms),
                "bound_by": "bytes" if byte_ms >= op_ms else "operations", "library_ms": lib}

    kernels = [
        entry("K1", "K1 sorted segment-sum", cs.K1, K1_REPLACES, "protein aggregation"),
        entry("K2", "K2 row gather", cs.K2, K2_REPLACES, "protein merged gather"),
    ]
    for k in kernels:
        if not all(math.isfinite(k[x]) for x in ("ms", "plain_ms", "bound_ms", "library_ms")):
            raise AssertionError(f"non-finite time in {k}")
    print(nvidia_smi())   # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
