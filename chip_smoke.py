#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA
H100 and check them.

    python3 chip_smoke.py

Phases, each printed before it starts and after it ends with its wall time:

1. device: needs CUDA; prints the card and ``nvidia-smi``'s name and power limit.
2. build: builds ``caster_dta_torch/csrc/segment.cu``,
   ``caster_dta_torch/csrc/gvp_message.cu`` and
   ``caster_dta_torch/csrc/attention.cu`` with nvcc for sm_90a, one nvcc per
   source, all at once, and prints ptxas's register and shared-memory lines.
3. kernels: K1 (sorted segment-sum) and K2 (row gather) on the card, at the
   shapes of the served model (K1 also at the large-protein request's
   aggregations), against their plain PyTorch versions on the same inputs:
   K2 must be bit-exact; K1 within K1_RTOL/K1_ATOL of the plain version on
   the card, and bit for bit the plain version's on the CPU (both sum every
   row in edge order), the same bits on a second call. K5 (the fused GVP
   message MLP, forward and backward, with the trained model's message
   weights; K5 fwd on its warp-tile kernels, mma.sync for the bf16 step and
   FFMA for f32, each case printing which; K5 bwd on its warp-tile kernel
   where bf16 is the compute dtype, on its block-tile kernel in f32) and K6
   (copy-cast, every f32/bf16 pair, on the node table and on an odd-length
   slice off 16-byte alignment)
   against theirs at the flagship and Davis shapes, f32 and with the bf16
   step's dtypes, within K5_TOL; K6 bit for bit. Edge cases: E off the
   tiles, one layer, a fused conv whose edges are all masked (its output and
   every gradient exactly 0), and a second run of K5 that must give the
   first run's bits. K4 (blockwise masked attention)
   at the cross-attention shapes of the flagship, Davis and large-protein
   requests, both directions, with their masks, against its plain version
   within K4_TOL and bit for bit on a second run; edge cases: a fully masked
   graph (the mean of v), one key, 130 x 33, hd 8, 5 and 32, no mask, Lq 67
   over 1000 keys (blocks split the keys), bf16 inputs. K7 (windowed
   gather) against K2 and its plain version, exact, at the flagship and
   Davis dst (sorted), src and shuffled indices, f32 and bf16. K8 (row-major segment-sum) against its plain version within
   K8_RTOL/K8_ATOL at the flagship, Davis and large-protein protein
   aggregations, bit for bit the CPU's plain version and K1 on the same
   masked rows, and its refusal of bf16. K7 and K8 lie on no path: their
   launch counts are those of this phase. K1, K2 and K3 (in the k3 phase)
   also at the model zoo's row widths (ZOO_WIDTHS: 1, 2, 21, 2 x 16,
   2 x 64) on the flagship protein graph and (ZOO_MOLECULE_WIDTHS: 1, 59)
   on its molecule graph, bit for bit as above.
4. serve: loads the trained ``runs/davis_seed9`` model onto the card, answers
   seeded synthetic requests at two buckets twice: eagerly
   (``predict(eager=True)``) and as CUDA-graph replays fed from a pinned
   buffer (``predict``, inference/replay.py; each bucket captured first).
   The replayed answers must equal the eager ones bit for bit (affinities
   and attention maps) with equal launches; checks that the K1 and K2 launch
   counts rose by the expected launches per forward, that the affinities are
   finite and that they match the port's CPU run, times each request eager
   and replayed (median, min, max over 20; the batch copy pageable against
   pinned; the forward alone; CUDA events), the card's idle share of each,
   and profiles the forward's kernels (torch.profiler): device time per
   forward, time by group.
   serve-fused: the same with the fused message path on
   (``with caster_dta_torch.nn.gvp.fused_message():``): launches per forward
   (K6 and K5 fwd once per GVP conv), card against the port's CPU run with
   the switch on, and against the unfused card answers within AFFINITY_ATOL;
   the profiler's kernel names must show K5 fwd's served f32 instance.
   serve-blockwise: the same with ``use_pallas`` set on the model's two
   MultiheadAttention modules (the blockwise K4 path), over the same
   requests and one large-protein request (LARGE): launches per forward (K4
   twice, K1 and K2 as unfused), card against the port's CPU run, attention
   (None, None), each answer against the dense card answer within
   AFFINITY_ATOL, latency and device time by group at three buckets; the
   profiler's kernel names must show K4's row kernel in the instance that
   ``cuda_attention.tiling`` takes (K4_SERVED).
5. evaluate: ``run_model_on_dataset`` (inference/evaluation.py) on the card
   with the ``runs/davis_seed9`` weights over EVAL_PAIRS seeded synthetic
   pairs of Davis-like size, batches of up to 8: dense and fused with the
   explainer (each bucket and tower's 10 Adam steps one CUDA graph), the
   blockwise path without it. Each path runs by replays twice (the first
   run captures) and eagerly: the records bit for bit equal, the launches
   equal; the first EVAL_CPU_BATCHES batches' records against the port on
   the CPU (AFFINITY_ATOL, ATTENTION_ATOL, EXPLAIN_ATOL); pairs/s with and
   without the explainer, the explainer's seconds per batch, launches by
   kernel (K3 must launch on the dense path, K5 bwd on the fused one).
6. k3: K3 (unsorted scatter-add, the gathers' backward) against its plain
   version on the CPU (same edge order) at the merged src||dst backward of
   the flagship, Davis and large-protein buckets and the molecule widths, f32
   and bf16, and on edge cases (repeated ids, all ids on one row, empty rows,
   E and N off any block, N = 6000), within K3_RTOL/K3_ATOL and bit for bit;
   a second call must give the first call's bits, and K3's CSR launch alone
   (``scatter_csr``) must give ``scatter_csr_plain``'s row_ptr and perm.
7. autograd: gather_nodes and segment_sum (ops/segment.py) at the flagship
   shapes: their gradients on the card against the same Functions on the
   CPU, f32 and bf16, within GRAD_TOL.
8. train: a bf16 Adam Trainer (lr 1e-4) from the runs/davis_seed9 weights at
   the flagship bucket; median step time over TRAIN_STEPS steps (CUDA
   events), protein edges/s, kernel time per step, idle share and kernel
   groups (torch.profiler); K1/K2/K3 launches per step against the counts the
   model's code gives; the eval-mode loss on the batch before and after the
   steps (it must fall); one f32 step's gradients (TF32 off, dropout off)
   card against CPU within STEP_GRAD_RTOL of each gradient's largest entry
   plus STEP_GRAD_ATOL of the largest over all.
   train-fused: the same with the fused message path on (TRAIN_STEPS_FUSED
   steps; K5 fwd and bwd per GVP conv, K6 twice per GVP conv), its numbers
   printed beside the unfused step's; the profiler's kernel names must show
   K5 fwd's served bf16-step instance (mma.sync).
   train-graph: the scan path's CUDA graphs (train/graphs.py). A
   device-resident store (data/device_cache.py) fills the flagship bucket
   with three full batches and a partial one; from the trained weights, bf16
   Adam, dropout on, both trainers with scan_steps on and so with the
   capturable optimizer, GRAPH_PASSES passes of eager steps (``train_step``,
   one batch at a time) against ``train_megabatch`` (warm-up steps, the capture, replays): losses,
   predictions and parameters bit for bit, launches per step those of the
   train phase (the capture's counts taken back, each replay's added), and
   the eval graph's predictions bit for bit ``eval_step``'s; then the
   replayed step (CUDA events around the row copy and the replay) and the
   eager store step, each with protein edges/s, kernel time, idle share and
   its longest kernels (torch.profiler), and nvidia-smi's SM clock and power
   draw over the timed steps; unfused, then fused (K5 fwd's bf16-step
   instance from the profiler's kernel names).
9. fit: two epochs of ``fit`` on a seeded synthetic dataset of FIT_PAIRS
   pairs in two buckets near the flagship sizes, checkpoints and run
   artifacts in a temporary directory, then ``load_run`` serves the best-val
   checkpoint on the card; once with the default config (the store and the
   graph path) and once with ``scan_steps=False, device_data_budget=None``
   (host batches, eager steps), each with its wall time and steps/s.
10. cli: the training CLI (``caster_dta_torch.train.driver.main``) in this
   process with the default config (store + CUDA graphs, bf16 Adam, dropout
   on), from a fresh data root: ``--dataset synthetic`` writes its PDB files,
   the host layers featurize them and the SMILES (native host library built
   with g++, spawned workers), then (a) CLI_EPOCHS epochs straight, (b)
   CLI_INTERRUPT epochs, the best and final checkpoints deleted, and
   ``--resume`` to CLI_EPOCHS: the histories must be equal and the final
   checkpoints the same bytes; (c) ``--skip-training`` on (a)'s checkpoint.
   Each training run must capture its train and eval graphs, and K1, K2 and
   K3 must launch. Prints the featurization time and graphs/s (in the CLI and
   again in this process without a pool), each run's wall time and epochs/s,
   and the parameters' device.
11. zoo: the model zoo (``zoo_phase``): eight JointGNN configurations of
   runs/davis_seed9 with towers swapped (``zoo_configs``: zoo-cpd-gatv2,
   zoo-pocketminer-heat, zoo-gatv2-gine, zoo-heat-gine, and the run's
   protein tower with the GIN, AttentiveFP, GPS and PNA molecule towers,
   zoo-lba-gin, -attentivefp, -gps, -pna) at a seeded random init and the
   flagship bucket: requests eager and replayed bit for bit with equal
   launches, against the CPU; the request times; the eager forward's
   device time, its scatter_reduce kernels (launches and time) and
   segment_softmax's pieces; bf16 Adam steps eager against graph replays
   from a store, bit for bit, and scatter_reduce's launches per step; the
   replayed step's time; one f32 step's gradients card vs CPU;
   zoo-lba-gps, and zoo-gatv2-gine with batch norm, served only, which the
   Trainer refuses; on zoo-cpd-gatv2 and zoo-lba-pna the explainer
   (replayed and eager bit for bit, the first batch against the CPU); on
   zoo-cpd-gatv2 remat (eager and replayed, bit for bit the steps without
   it, peak memory of each). K1, K2 and K3 must launch, K4, K5 and K6 must
   not.
12. times: each kernel (K3 also at the large protein's merged backward; K1,
   K2 and K3 also at the zoo's row widths on the flagship graph), its
   plain version and the one PyTorch call that
   computes the same function, replayed from CUDA graphs and timed with CUDA
   events, beside the least time the card could take (the larger of bytes
   over 3.35 TB/s and operations over the peak rate of their type). No single
   PyTorch call computes K5; its reference point is the device time of the
   port's unfused message chain (the GVP modules) at the same shapes, summed
   over its kernels by torch.profiler. K4 at each bucket and direction, beside
   its plain version, ``scaled_dot_product_attention`` with an additive -1e9
   mask (the library yardstick, which the port never calls) and the device
   time of the port's dense attention core (einsum, mask, f32 softmax,
   einsum); K7 at the flagship and Davis protein gathers beside K2 on the
   same indices; K8 at the same buckets' protein aggregations; K1 and K8
   also at the large protein's protein aggregation. Each K1 and K8 line
   gives its case's longest dst range (the edges of one row: the padding
   row N-1 at every bucket).

Every CPU reference that a card result is held against is computed twice
and taken only when the two runs give the same bits (``cpu_reference``); when
they differ, both answers go to a file in ``$CHIP_SMOKE_OUT`` (default
``chip_smoke_out/``) and their first tensors to stderr.

Any failure raises and the script exits non-zero. On success the line before
the last is ``{"kernels": [...]}``, whose launch counts are each kernel's over
the phases that run it: evaluate's replayed runs and the training phases
(train, train-fused, train-graph, fit, cli, and zoo's training passes) for
K1-K3, K5 and K6,
serve-blockwise and evaluate for K4, kernels for K7 and K8; and the last
is ``{"ok": true, "device": {...}}``. Without CUDA it exits 1 and prints no
result.
"""
from __future__ import annotations

import contextlib
import json
from concurrent.futures import ThreadPoolExecutor
import math
import os
import re
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
# the top rung of the JAX package's protein ladder (caster_dta_tpu/data/
# batching.py:93-94), the traffic the blockwise attention path serves
LARGE = dict(b=4, n_p=4608, e_p=65536, n_m=128, e_m=1024)
N_REQUESTS_FLAGSHIP = 4

# H100 SXM data sheet: HBM3 bandwidth, f32 rate outside the tensor cores,
# dense bf16 rate of the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

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

# K3 sums every row in edge order in f32, as the plain version (index_add_)
# does on the CPU; on the card index_add_ adds in atomic order, which moves
# the padding rows (0 and N-1 take ~700 ids each at the flagship bucket,
# ~30,000 at the large protein) by up to ~1e-4. So K3 is held against the
# plain version on the CPU, same inputs, within these and bit for bit.
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
TRAIN_STEPS_FUSED = 20
# train-graph: pairs of the flagship bucket from a store (3 full batches of
# 32 and a partial one), passes over them compared eager against replays,
# the steps timed on each path, and the longest kernels printed
GRAPH_PAIRS = 3 * 32 + 10
GRAPH_PASSES = 3
GRAPH_TIMED_STEPS = 20
GRAPH_TIMED_REPLAYS = 100
GRAPH_TOP_KERNELS = 8
FIT_PAIRS = 320
# cli: the synthetic set the training CLI featurizes (data/synthetic.py, seed
# 0): 3,000 draws over 40 proteins of 20-60 residues and 30 molecules, 1,099
# distinct pairs; at the CLI's batch size of 128 the train split fills a
# bucket of 5 batches (its step is captured after 2 warm-up steps, in the
# first epoch of each run) and one of 2, and the val split 2 batches (its
# forward captured after 1). Epochs of the straight run, of the interrupted
# run and of the resumed one.
CLI_SYNTHETIC = ["--synthetic-pairs", "3000", "--synthetic-proteins", "40",
                 "--synthetic-molecules", "30"]
CLI_EPOCHS, CLI_INTERRUPT = 4, 2
# evaluate: run_model_on_dataset over seeded synthetic pairs of Davis-like
# size (proteins of 200-700 residues with 8 edges each, molecules of 20-64
# atoms) in batches of up to 8, the JAX function's default; its first
# EVAL_CPU_BATCHES batches are held against the port on the CPU
EVAL_PAIRS = 64
EVAL_DATA = dict(n_proteins=16, n_molecules=16, protein_nodes=[(200, 700)],
                 molecule_nodes=(20, 64), seed=16)
EVAL_BATCH = 8
EVAL_CPU_BATCHES = 2
# explanations card vs CPU (node masks softmaxed over a graph's real nodes,
# raw edge masks) after 10 Adam steps. The first step's gradients agree as
# the train step's do (2e-7 against a largest entry of 0.1 on the evaluate
# set's protein edges), but Adam divides each entry by its own running norm,
# so an entry whose gradient nearly cancels carries the f32 sum-order
# difference into its step at full size, and the masks drift apart step by
# step: up to 1.9e-6 after 1 step, 1.1e-5 after 2, 4.3e-5 after 5 and 8.6e-5
# after 10 on the evaluate set's first two batches (scripts/
# explainer_card_cpu.py). Twice that. (The CPU tests hold the port to JAX
# within 1e-5 at their smaller sizes.)
EXPLAIN_ATOL = 2e-4
# zoo: the model zoo's towers in runs/davis_seed9's configuration with one or
# both towers swapped (zoo_configs), at the flagship bucket: ZOO_REQUESTS
# requests served eagerly and replayed; ZOO_PASSES passes of bf16 Adam steps
# over a store of ZOO_PAIRS pairs (batches of 32, 32 and 10: 2 warm-up steps,
# the capture and a replay in the first pass, replays after), eager and as
# graph replays; the explainer over ZOO_EXPLAIN_PAIRS pairs on zoo-cpd-gatv2
ZOO_REQUESTS = 2
ZOO_PASSES = 2
ZOO_PAIRS = 2 * 32 + 10
ZOO_EXPLAIN_PAIRS = 16
# synthetic_pair_dataset's arguments for the zoo's store (with
# scalar_protein for a scalar protein tower); PNA's degree histogram is
# taken over its molecules
ZOO_STORE = dict(n_pairs=ZOO_PAIRS, n_proteins=24, n_molecules=16, protein_nodes=[(400, 500)],
                 molecule_nodes=(20, 64), seed=1)
# the kernels' row widths on the zoo's path: 1 (the real in-degree of the
# mean and autoregressive aggregations), 2 (segment_softmax's per-head max
# and denominators, H = 2), 21 (CPD's source-type one-hot; a gather only),
# H x C = 2 x 16 and 2 x 64 (GATv2's per-head rows)
ZOO_WIDTHS = {"K1": (1, 2, 32, 128), "K2": (1, 2, 21, 32, 128), "K3": (1, 2, 32, 128)}
# and on the molecule graph, where the zoo-lba-* towers bring widths the
# trained GINE tower (51 and 16, kernel_cases) does not: 1 (AttentiveFP's
# attention scores and softmax denominators, PNA's in-degree) and 59 (GPS's
# first local GINEConv: 41 features, 10 atom types, the PE's 8)
ZOO_MOLECULE_WIDTHS = {"K1": (1, 59), "K2": (1, 59), "K3": (1,)}
# the scalar protein layout (data/build.py's feature dims with
# vectorize_features=False; tests/test_torch_zoo_models.py holds them
# against a built graph): 17 + 3 x 3 node and 32 + 3 edge channels
SCALAR_PROTEIN_DIMS = dict(in_channels=26, edge_dim=35)
# K5 against its plain version on the card: f32 sums the same products in
# another order (outputs and input gradients within 1e-5 + 1e-5 x the
# tensor's largest entry, weight gradients, sums over every edge, within
# 2e-4 of theirs, as the JAX package's fused-vs-module test); where bf16 is
# the compute dtype or the tensor's own, a sum that lands on another side of
# a rounding boundary moves one bf16 ulp and later layers carry it on, so
# 2e-2 of the tensor's largest entry.
K5_TOL = {"f32": 1e-5, "weight": 2e-4, "bf16": 2e-2}
# K4 against its plain version on the card (rtol and atol): the same f32
# products summed in another order and one exp per key against a dense
# softmax; the JAX package's blockwise-vs-dense tests use the same 2e-5.
K4_TOL = 2e-5
# K8 sums in edge order in f32; the plain index_add_ on the card sums the
# same terms in atomic order, as for K1.
K8_RTOL, K8_ATOL = 1e-5, 1e-5

K1_REPLACES = "caster_dta_tpu/ops/pallas_segment.py:131"   # _segment_kernel_t
K2_REPLACES = "caster_dta_tpu/ops/pallas_segment.py:540"   # _onehot_gather_kernel
K3_REPLACES = "caster_dta_tpu/ops/pallas_segment.py:268"   # _scatter_fullN_kernel
K5F_REPLACES = "caster_dta_tpu/ops/pallas_gvp_message.py:267"   # _fwd_kernel
# K5 fwd's served instances, as torch.profiler names them: f32 serving on the
# f32 kernel, the bf16 step on the mma.sync kernel, each with (relu, none) and
# its dtypes fixed at compile time (template arguments ACT_S, ACT_V, DT)
K5F_SERVED = {"f32": re.compile(r"message_fwd_f32_kernel<.*MmaNet<[^>]*>, 1, 0, 0>"),
              "bf16 step": re.compile(r"message_fwd_mma_kernel<.*MmaNet<[^>]*>, 1, 0, 4>")}
K5B_REPLACES = "caster_dta_tpu/ops/pallas_gvp_message.py:284"   # _bwd_kernel
K6_REPLACES = "caster_dta_tpu/ops/pallas_gvp_message.py:217"    # _cast_kernel
K4_REPLACES = "caster_dta_tpu/ops/pallas_attention.py:41"       # _mha_kernel
# K4's kernel at the served head width (hd = 16), as torch.profiler names it:
# the row kernel, in the instance (R, KS, MINB) of cuda_attention._ROWS
K4_SERVED = "masked_mha_rows_kernel<{}, {}, {}>"
K7_REPLACES = "caster_dta_tpu/ops/pallas_segment.py:639"        # _gather_window_kernel
K8_REPLACES = "caster_dta_tpu/ops/pallas_segment.py:72"         # _segment_kernel
SOURCE = "caster_dta_torch/csrc/segment.cu"
GVP_SOURCE = "caster_dta_torch/csrc/gvp_message.cu"
ATTN_SOURCE = "caster_dta_torch/csrc/attention.cu"


def zoo_degree_hist() -> list:
    """The in-degree histogram of the zoo store's molecules, every atom
    counted (isolated ones at 0), as the reference's model_utils.py:37-58
    computes PNA's over a training set."""
    import numpy as np

    from caster_dta_torch.data.batching import synthetic_pair_dataset

    hist = np.zeros(0, np.int64)
    for m in synthetic_pair_dataset(**ZOO_STORE).molecule_data.values():
        h = np.bincount(np.bincount(m["edge_index"][1], minlength=m["n_nodes"]))
        hist = np.pad(hist, (0, max(len(h) - len(hist), 0)))
        hist[:len(h)] += h
    return hist.tolist()


def zoo_configs() -> dict:
    """The zoo phase's eight JointGNN configurations: runs/davis_seed9's
    model_kwargs.json with one or both towers swapped, each tower at the
    run's widths (2 convs, out 64, hidden 16 or (16, 4), its dropout and
    activation), GATv2 and HEAT with 2 heads, HEAT's edge attributes
    embedded in 8, PocketMiner's initial projections (16, 8) and (32, 4) as
    tests/test_model_zoo.py's; the run's joint kwargs. The zoo-lba-* four
    keep the run's protein tower and swap the molecule tower for GIN,
    AttentiveFP, GPS (pe_dim 8, JAX's default attention dropout) or PNA (4
    towers, JAX's default aggregators and scalers, ``zoo_degree_hist``)."""
    with open(os.path.join(RUN_DIR, "model_kwargs.json")) as f:
        run = json.load(f)
    p, m = run["protein_gnn_kwargs"], run["molecule_gnn_kwargs"]
    shared = {k: p[k] for k in ("num_ntypes", "num_etypes", "ntype_emb_dim", "etype_emb_dim",
                                "num_convs", "out_channels", "dropout_rate", "activation")}
    vector = dict(shared, **{k: p[k] for k in ("in_channels", "edge_dim", "hidden_channels",
                                                "edge_hidden_channels")})
    scalar = dict(shared, **SCALAR_PROTEIN_DIMS, hidden_channels=p["hidden_channels"][0],
                  aggr=p["aggr"], heads=2)
    mol = {k: v for k, v in m.items() if k not in ("base_conv", "gin_trainable_eps")}
    protein = {"cpd": dict(vector, base_conv="cpdmodel"),
               "pocketminer": dict(vector, base_conv="pocketminer",
                                   initial_node_project_channels=[16, 8],
                                   initial_edge_project_channels=[32, 4]),
               "gatv2": dict(scalar, base_conv="gatv2"),
               "heat": dict(scalar, base_conv="heat", eattr_emb_dim=8)}
    molecule = {"gatv2": dict(mol, base_conv="gatv2", heads=2, concat=False),
                "heat": dict(mol, base_conv="heat", eattr_emb_dim=8, heads=2), "gine": m,
                "gin": dict(m, base_conv="gin"), "attentivefp": dict(mol, base_conv="attentivefp"),
                "gps": dict(mol, base_conv="gps", pe_dim=8),
                "pna": dict(mol, base_conv="pna", towers=4, degree_hist=zoo_degree_hist())}
    protein["lba"] = p
    return {f"zoo-{a}-{b}": dict(protein_gnn_kwargs=protein[a], molecule_gnn_kwargs=molecule[b],
                                 joint_gnn_kwargs=dict(run["joint_gnn_kwargs"]))
            for a, b in (("cpd", "gatv2"), ("pocketminer", "heat"), ("gatv2", "gine"),
                         ("heat", "gine"), ("lba", "gin"), ("lba", "attentivefp"),
                         ("lba", "gps"), ("lba", "pna"))}


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


@contextlib.contextmanager
def smi_samples(samples: list):
    """nvidia-smi's SM clock (MHz) and power draw (W), sampled every 50 ms
    while the block runs, appended to ``samples`` as (clock, power)."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                             "--format=csv,noheader,nounits", "-lms", "50"],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        yield
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=60)
        for line in out.splitlines():
            try:
                clock, power = (float(x) for x in line.split(","))
            except ValueError:
                continue
            samples.append((clock, power))


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


KERNEL_GROUPS = (("K4 attention", "masked_mha"),
                 ("K1 segment-sum", "segment_walk"), ("K1 segment-sum", "segment_small"),
                 ("K2 gather", "gather_rows"),
                 ("K3 scatter", "scatter_csr"), ("K3 scatter", "scatter_sum"),
                 ("K3 scatter", "scatter_small"), ("K5 fwd", "message_fwd"),
                 ("K5 bwd", "message_bwd"), ("K5 bwd sum", "reduce_rows"),
                 ("K6 copy-cast", "cast_vec"), ("K6 copy-cast", "cast_copy"), ("matmul", "gemm"),
                 ("layernorm", "layer_norm"), ("concat", "CatArray"), ("softmax", "softmax"),
                 ("optimizer", "multi_tensor_apply"), ("reduction", "reduce_kernel"),
                 ("copy", "Memcpy"))


def profile_forward(torch, forward, n: int = 5, counts: dict | None = None):
    """Device kernels of ``n`` calls of ``forward`` under torch.profiler
    -> ({kernel name: device ms per call}, kernel launches per call); with
    ``counts``, each name's launches per call go there too. A user
    annotation's span on the device (``Optimizer.step#Adam.step``: from its
    first kernel to its last, the gaps included) is not a kernel."""
    from torch.profiler import ProfilerActivity, profile

    forward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            forward()
        torch.cuda.synchronize()
    per_kernel, launches = {}, 0
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
            launches += 1
            if counts is not None:
                counts[e.name] = counts.get(e.name, 0) + 1 / n
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


def longest_range(dst) -> int:
    """The most edges any one row of sorted dst [B, E] holds."""
    if dst.shape[1] == 0:
        return 0
    return max(int(g.unique_consecutive(return_counts=True)[1].max()) for g in dst.cpu())


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


def zoo_kernel_cases(torch, batch, gen, dev="cuda"):
    """K1, K2 and K3 inputs at the zoo's row widths (ZOO_WIDTHS) on a
    request's protein graph and (ZOO_MOLECULE_WIDTHS) on its molecule graph:
    K2 gathers by dst (by src for the type one-hot and GPS's rows), K1 sums
    by dst, K3 scatters the gathers' cotangents by dst."""
    p, m = batch.protein.to(dev), batch.molecule.to(dev)
    b = p.batch_size

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    return {
        "K2": [(f"zoo gather F={f}", randn(b, p.n_pad, f), p.edge_src if f == 21 else p.edge_dst)
               for f in ZOO_WIDTHS["K2"]]
        + [(f"zoo molecule gather F={f}", randn(b, m.n_pad, f),
            m.edge_src if f == 59 else m.edge_dst) for f in ZOO_MOLECULE_WIDTHS["K2"]],
        "K1": [(f"zoo aggregation F={f}", randn(b, p.e_pad, f), p.edge_dst, p.edge_mask, p.n_pad)
               for f in ZOO_WIDTHS["K1"]]
        + [(f"zoo molecule aggregation F={f}", randn(b, m.e_pad, f), m.edge_dst, m.edge_mask,
            m.n_pad) for f in ZOO_MOLECULE_WIDTHS["K1"]],
        "K3": [(f"zoo backward F={f}", randn(b, p.e_pad, f), p.edge_dst, p.n_pad)
               for f in ZOO_WIDTHS["K3"]]
        + [(f"zoo molecule backward F={f}", randn(b, m.e_pad, f), m.edge_dst, m.n_pad)
           for f in ZOO_MOLECULE_WIDTHS["K3"]],
    }


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


def k4_cases(torch, batch, gen, heads: int, hd: int, dev="cuda"):
    """K4 inputs at a request's cross-attention shapes, [B, heads, L, hd]:
    residues->atoms (the atoms are the keys, masked where the molecule pads)
    and atoms->residues (the residues are the keys)."""
    p, m = batch.protein.to(dev), batch.molecule.to(dev)

    def randn(n):
        return torch.randn(p.batch_size, heads, n, hd, generator=gen, device=dev)

    return [("residues->atoms", randn(p.n_pad), randn(m.n_pad), randn(m.n_pad), ~m.node_mask),
            ("atoms->residues", randn(m.n_pad), randn(p.n_pad), randn(p.n_pad), ~p.node_mask)]


def k4_edge_cases(torch, gen, dev="cuda"):
    """A fully masked graph, one key, Lq and Lk off any tile, hd 8, 5 and 32,
    no mask, a grid whose blocks split the keys: (what, q, k, v, mask)."""
    out = []
    for what, (b, h, lq, lk, hd), kind in [
            ("a fully masked graph", (2, 8, 50, 70, 16), "graph 0 masked"),
            ("one key", (2, 8, 7, 1, 16), "padding"), ("130 x 33", (1, 2, 130, 33, 16), None),
            ("hd 8", (2, 4, 60, 90, 8), "padding"), ("hd 5", (3, 2, 200, 150, 5), "padding"),
            ("hd 32", (2, 4, 60, 90, 32), "padding"), ("no mask", (4, 8, 96, 40, 16), None),
            ("blocks split the keys", (2, 8, 67, 1000, 16), "padding")]:
        q, k, v = (torch.randn(b, h, n, hd, generator=gen, device=dev) for n in (lq, lk, lk))
        mask = None
        if kind is not None:
            mask = torch.rand(b, lk, generator=gen, device=dev) < 0.3
            if kind == "graph 0 masked":
                mask[0] = True
        out.append((f"{what} [{b}, {h}, {lq} x {lk}, {hd}]", q, k, v, mask))
    return out


def k4_work(torch, q, mask) -> tuple:
    """(bytes, operations) that K4's function needs on these inputs: q and
    the output whole, k and v only at the keys that count (the real ones, or
    all Lk of a fully masked graph), the mask; 2 operations per multiply-add
    of both products over those keys. The exps are not counted."""
    b, h, lq, hd = q.shape
    lk = mask.shape[1]
    real = (~mask).sum(1)
    keys = int(torch.where(real > 0, real, lk).sum().item())
    nbytes = 2 * q.numel() * 4 + 2 * h * keys * hd * 4 + mask.numel()
    return nbytes, 2 * 2 * h * lq * keys * hd


def set_use_pallas(model, on: bool) -> None:
    """Set ``use_pallas`` on every MultiheadAttention of a model: the
    blockwise K4 path of a loaded run, as the JAX field on the same weights."""
    from caster_dta_torch.nn.attention import MultiheadAttention

    for module in model.modules():
        if isinstance(module, MultiheadAttention):
            module.use_pallas = on


def k5_close(torch, got, want, bf16: bool, weight: bool, what: str) -> float:
    """max |got - want|, raising beyond K5_TOL (see there)."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if got.numel() == 0:
        return 0.0
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    if bf16:
        tol = K5_TOL["bf16"] * scale
    elif weight:
        tol = K5_TOL["weight"] * scale
    else:
        tol = K5_TOL["f32"] * (1.0 + scale)
    if not err <= tol:
        raise AssertionError(f"{what}: max|d| {err:.3e} > {tol:.3e} (max|want| {scale:.3e})")
    return err


# the dtypes of K5's inputs (both, es, ev) and products: f32 serving, and the
# bf16 training step (the conv receives s and es f32, v and ev bf16, and the
# merged node table promotes to f32)
K5_DTYPES = {"f32": ("float32", "float32", "float32", "float32"),
             "bf16 step": ("float32", "float32", "bfloat16", "bfloat16")}


def k5_inputs(torch, gen, b: int, e: int, kind: str, f: int = 28, se: int = 32, ve: int = 1):
    """Random K5 inputs on the card: both [B, 2E, F], es, ev, dout."""
    dt = [getattr(torch, d) for d in K5_DTYPES[kind]]

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    return (randn(b, 2 * e, f).to(dt[0]), randn(b, e, se).to(dt[1]),
            randn(b, e, 3 * ve).to(dt[2]), randn(b, e, f).to(dt[0]))


def k5_check(torch, cgm, what, inputs, weights, spec, max_err):
    """K5 fwd and bwd on the card against their plain versions on the card,
    same inputs; a second run must give the same bits."""
    both, es, ev, dout = inputs
    bf16 = spec.compute_dtype == torch.bfloat16
    runs = []
    for _ in range(2):
        runs.append((cgm.message_fwd(both, es, ev, weights, spec),
                     cgm.message_bwd(both, es, ev, weights, dout, spec)))
    torch.cuda.synchronize()
    (out, grads), (out2, grads2) = runs
    flat, flat2 = [out, *grads[:3], *grads[3]], [out2, *grads2[:3], *grads2[3]]
    if not all(torch.equal(a, b) for a, b in zip(flat, flat2)):
        raise AssertionError(f"K5 {what}: two runs gave different bits")
    want_out = cgm.message_fwd_plain(both, es, ev, weights, spec)
    want = cgm.message_bwd_plain(both, es, ev, weights, dout, spec)
    err_f = k5_close(torch, out, want_out, bf16 or out.dtype == torch.bfloat16, False,
                     f"K5 fwd {what}")
    err_i = max(k5_close(torch, g, w, bf16 or g.dtype == torch.bfloat16, False,
                         f"K5 bwd {what} {name}")
                for name, g, w in zip(("d both", "d es", "d ev"), grads[:3], want[:3]))
    err_w = max(k5_close(torch, g, w, bf16, True, f"K5 bwd {what} weight {i}")
                for i, (g, w) in enumerate(zip(grads[3], want[3])))
    max_err["K5 fwd"] = max(max_err["K5 fwd"], err_f)
    max_err["K5 bwd"] = max(max_err["K5 bwd"], err_i, err_w)
    print(f"K5 {what}: both {tuple(both.shape)} {str(both.dtype)[6:]}, ev {str(ev.dtype)[6:]}, "
          f"compute {str(spec.compute_dtype)[6:]}: fwd max|d| {err_f:.3e}, bwd input grads "
          f"{err_i:.3e}, weight grads {err_w:.3e}; a second run gave the same bits")


def check_k5f_served(tag: str, per_kernel: dict, kind: str) -> None:
    """Print the K5 fwd kernels that the profiler saw; raise unless they are
    all the served instance for ``kind`` (K5F_SERVED)."""
    k5f = {name: ms for name, ms in per_kernel.items() if "message_fwd" in name}
    print(f"{tag}K5 fwd kernels: " + "; ".join(
        f"{name.replace('(anonymous namespace)::', '').split('(')[0]} {ms:.3f} ms"
        for name, ms in k5f.items()))
    if not k5f or not all(K5F_SERVED[kind].search(name.replace("(anonymous namespace)::", ""))
                          for name in k5f):
        raise AssertionError(f"{tag}K5 fwd did not run its served {kind} instance: "
                             f"{sorted(k5f)}")


def check_k4_served(tag: str, per_kernel: dict, rows: tuple) -> None:
    """Print the K4 kernels that the profiler saw; raise unless they are all
    the row kernel's instance ``rows`` (K4_SERVED)."""
    want = K4_SERVED.format(*rows)
    k4 = {name.replace("(anonymous namespace)::", "").split("(")[0]: ms
          for name, ms in per_kernel.items() if "masked_mha" in name}
    print(f"{tag}K4 kernels: " + "; ".join(f"{name} {ms:.3f} ms" for name, ms in k4.items()))
    if not k4 or not all(want in name for name in k4):
        raise AssertionError(f"{tag}K4 did not run {want}: {sorted(k4)}")


def k5_flops(dims, si: int, vi: int) -> int:
    """Operations of K5 fwd per edge: 2 per multiply-add of the products
    (vh, spre, vraw, z) of every layer; the elementwise work is left out."""
    macs = 0
    for h, so, vo in dims:
        macs += 3 * h * vi + so * (si + h) + 3 * vo * h + vo * so
        si, vi = so, vo
    return 2 * macs


def _tensors(x):
    if x is None:
        return []
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    return [x]


def _equal(torch, x, y) -> bool:
    if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
        return isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor) and torch.equal(x, y)
    if hasattr(x, "shape") or hasattr(y, "shape"):
        import numpy as np
        return np.array_equal(x, y)
    return x == y


CPU_REFERENCES = {"taken": 0, "third run": 0}


def cpu_reference(torch, fn, what: str):
    """``fn()`` run on the CPU, taken as a reference once two runs give the
    same bits. On the card's machine the first served request has twice in
    some thirty runs been 3.5e-4 pKd from the CPU's answer while two card
    answers to it agreed bit for bit, and no later request or run repeated
    it. A third run breaks a tie; three different answers fail the check."""
    def same(a, b):
        a, b = _tensors(a), _tensors(b)
        return len(a) == len(b) and all(_equal(torch, x, y) for x, y in zip(a, b))

    first, second = fn(), fn()
    CPU_REFERENCES["taken"] += 1
    if same(first, second):
        return first
    # keep the differing answers beside the run's output, to hold them
    # against another machine's CPU bits for the same input
    out_dir = os.environ.get("CHIP_SMOKE_OUT", os.path.join(HERE, "chip_smoke_out"))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "cpu_reference_" + re.sub(r"[^\w.-]+", "_", what) + ".pt")
    torch.save({"what": what, "first": first, "second": second}, path)
    heads = [getattr(t, "tolist", lambda t=t: t)() for t in
             (_tensors(first)[:1] + _tensors(second)[:1])]
    print(f"{what}: the two CPU answers written to {path}; their first parts: {heads}",
          file=sys.stderr)
    third = fn()
    if not (same(third, first) or same(third, second)):
        raise AssertionError(f"{what}: the CPU reference differs on each of three runs")
    CPU_REFERENCES["third run"] += 1
    print(f"{what}: two CPU runs differed; a third agreed with one of them", file=sys.stderr)
    return third


def cli_phase(torch, train_launches: dict) -> None:
    """The training CLI (caster_dta_torch/train/driver.py ``main``) in this
    process on the card, default config (store + CUDA graphs, dropout on),
    from a fresh data root of synthetic PDB files and SMILES: (a) CLI_EPOCHS
    epochs straight; (b) CLI_INTERRUPT epochs, the best and final checkpoints
    deleted, then ``--resume`` to CLI_EPOCHS: histories equal and the final
    checkpoints the same bytes; (c) ``--skip-training`` on (a)'s checkpoint.
    K1, K2 and K3 must launch, and each run must capture train and eval
    graphs. Adds the phase's launches to ``train_launches``."""
    import pickle

    from caster_dta_torch.data.pairs import ProteinMoleculeDataset
    from caster_dta_torch.native import host
    from caster_dta_torch.ops import cuda_segment as cs
    from caster_dta_torch.ops import launches as launch_counts
    from caster_dta_torch.train import checkpoints, driver

    t0 = time.perf_counter()
    host.load_library()   # the CLI's dataset build would build it; timed apart here
    host_build = time.perf_counter() - t0
    launch_counts.reset()
    with tempfile.TemporaryDirectory() as tmp:
        base = ["--dataset", "synthetic", "--data-root", os.path.join(tmp, "data"),
                "--seed", "9", *CLI_SYNTHETIC]
        out = {k: os.path.join(tmp, k) for k in ("a", "b", "c")}

        def run(argv, what):
            t0 = time.perf_counter()
            res = driver.main(base + argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            trainer = res["trainer"]
            kinds = sorted({key[0] for key in trainer._graphs.keys()}) if trainer._graphs else []
            n_epochs = len(res["history"])
            print(f"cli {what}: {seconds:.2f} s, {n_epochs} epochs in the history; captured "
                  f"{kinds}; parameters on {next(trainer.model.parameters()).device}; "
                  f"test {res['test_metrics']}")
            if kinds != ["eval", "train"]:
                raise AssertionError(f"cli {what}: captured {kinds}, not the train and eval "
                                     "graphs of the default config")
            return res, seconds

        res_a, sec_a = run(["--out-folder", out["a"], "--n-epochs", str(CLI_EPOCHS)], "(a) straight")
        dataset = res_a["dataset"]
        cached = [n for n in os.listdir(os.path.join(tmp, "data", "cache"))
                  if n.startswith(driver.CACHE_PREFIX)]
        print(f"cli dataset: {len(dataset)} pairs, {len(dataset.protein_data)} proteins, "
              f"{len(dataset.molecule_data)} molecules; "
              f"featurized in {dataset.featurize_seconds:.3f} s with the native host "
              f"library (built and loaded in {host_build:.2f} s before) and spawned workers, "
              f"{dataset.n_graphs / dataset.featurize_seconds:.1f} graphs/s; cache {cached}")
        t0 = time.perf_counter()
        again = ProteinMoleculeDataset(dataset.records, n_workers=0,
                                       **driver.DEFAULT_DATASET_KWARGS)
        in_process = time.perf_counter() - t0
        if not all(pickle.dumps(again.protein_data[k]) == pickle.dumps(dataset.protein_data[k])
                   for k in dataset.protein_data):
            raise AssertionError("cli: featurizing in this process gave other protein graphs")
        print(f"cli featurization in this process (no pool): {in_process:.3f} s, "
              f"{again.n_graphs / in_process:.1f} graphs/s")
        _, sec_b1 = run(["--out-folder", out["b"], "--n-epochs", str(CLI_INTERRUPT)],
                        "(b) interrupted")
        removed = [f for f in os.listdir(out["b"]) if f.startswith(("bestval", "besttrain", "final"))]
        for f in removed:
            os.remove(os.path.join(out["b"], f))
        res_b, sec_b2 = run(["--out-folder", out["b"], "--n-epochs", str(CLI_EPOCHS), "--resume"],
                            "(b) resumed")
        for what, seconds, epochs in (("(a)", sec_a, CLI_EPOCHS), ("(b) interrupted", sec_b1,
                                                                    CLI_INTERRUPT),
                                      ("(b) resumed", sec_b2, CLI_EPOCHS - CLI_INTERRUPT)):
            print(f"cli {what}: {seconds:.2f} s wall clock (dataset load, model build, "
                  f"captures, checkpoints and the test evaluation included), "
                  f"{epochs / seconds:.3f} epochs/s")
        hist = [[(h["epoch"], h["lr"], h["train"], h["val"]) for h in r["history"]]
                for r in (res_a, res_b)]
        print(f"cli histories (epoch, lr, train, val): straight {hist[0]}; resumed {hist[1]}")
        if hist[0] != hist[1]:
            raise AssertionError("cli: the resumed run's history differs from the straight run's")
        finals = []
        for d in (out["a"], out["b"]):
            with open(checkpoints.get_best_model(d, "final"), "rb") as f:
                finals.append(f.read())
        if finals[0] != finals[1]:
            raise AssertionError("cli: the resumed run's final checkpoint differs from the "
                                 "straight run's")
        print(f"cli: resumed = straight bit for bit (history and the final checkpoint, "
              f"{len(finals[0])} bytes); deleted before resuming: {sorted(removed)}")
        report = driver.main(base + ["--out-folder", out["c"], "--skip-training",
                                     "--checkpoint", out["a"]])
        print(f"cli (c) --skip-training on (a)'s checkpoint: {report}")
        if not all(math.isfinite(report[k]) for k in ("mse", "rmse", "mae")):
            raise AssertionError(f"cli (c): metrics not finite: {report}")
    counts = launch_counts.snapshot()
    print(f"cli launches: {counts}")
    for k in (cs.K1, cs.K2, cs.K3):
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"cli: {k} never launched in the CLI's runs: {counts}")
    for k, v in counts.items():
        train_launches[k] = train_launches.get(k, 0) + v


def records_equal(a: dict, b: dict) -> bool:
    """Two run_model_on_dataset results with the same bits in every cell."""
    import numpy as np

    def cell(x, y):
        if x is None or y is None:
            return x is None and y is None
        return np.array_equal(x, y) if hasattr(x, "shape") else x == y

    return a.keys() == b.keys() and all(
        len(a[k]) == len(b[k]) and all(cell(x, y) for x, y in zip(a[k], b[k])) for k in a)


def check_records(tag: str, card: dict, cpu: dict, what: str) -> None:
    """run_model_on_dataset records of the card against the CPU's (``cpu``
    may hold a subset of the pairs): affinities within AFFINITY_ATOL,
    attention within ATTENTION_ATOL, explanations within EXPLAIN_ATOL."""
    import numpy as np

    where = {p: i for i, p in enumerate(card["pair_idx"])}
    kinds = {"affinity_score": AFFINITY_ATOL}
    kinds.update({k: ATTENTION_ATOL for k in (
        "protein_attention", "molecule_attention", "max_protein_attention",
        "max_molecule_attention", "prot_mol_attention", "mol_prot_attention")})
    kinds.update({k: EXPLAIN_ATOL for k in (
        "protein_explanation", "molecule_explanation", "protein_edge_explanation",
        "molecule_edge_explanation")})
    worst = {k: (0.0, None) for k in kinds}     # column -> (max |d|, where)
    over = {k: 0 for k in kinds}                 # entries beyond the tolerance
    for j, p in enumerate(cpu["pair_idx"]):
        i = where[p]
        for k, tol in kinds.items():
            got, want = card[k][i], cpu[k][j]
            if (got is None) != (want is None):
                raise AssertionError(f"{tag} pair {p} {k}: None on one device only")
            if got is None:
                continue
            got, want = np.atleast_1d(got), np.atleast_1d(want)
            if got.shape != want.shape:
                raise AssertionError(f"{tag} pair {p} {k}: shape {got.shape} against "
                                     f"{want.shape}")
            d = np.abs(got - want)
            over[k] += int((d > tol).sum())
            if d.size and d.max() > worst[k][0]:
                at = int(d.argmax())
                worst[k] = (float(d.max()), f"pair {p} entry {at}: card {got.flat[at]:.8g}, "
                                            f"CPU {want.flat[at]:.8g}")
    print(f"{tag}: card vs CPU over {what}, max|d| by column (tolerance; entries beyond it; "
          f"where the largest is):")
    for k, tol in kinds.items():
        if worst[k][1] is not None:
            print(f"  {k}: {worst[k][0]:.3e} ({tol}; {over[k]}; {worst[k][1]})")
    beyond = {k: n for k, n in over.items() if n}
    if beyond:
        raise AssertionError(f"{tag}: card vs CPU beyond tolerance in {beyond}")


def check_step_grads(torch, tag: str, make_model, batch, exact: bool = False) -> None:
    """One f32 step's gradients, card vs CPU, same weights and batch, dropout
    off (the two devices' generators differ): ``make_model(device)`` gives
    the model in eval mode. Each gradient is held to STEP_GRAD_RTOL of its
    largest entry plus STEP_GRAD_ATOL of the largest over all. With
    ``exact``, a gradient beyond that is held instead against the same step
    in f64 on the CPU: the card may be no farther from it than the CPU's f32
    gradient is, plus the same bound (a sum that cancels leaves more f32
    rounding than the bound on either device)."""
    import dataclasses

    from caster_dta_torch.data.graphs import GraphBatch
    from caster_dta_torch.train.loop import Trainer, TrainConfig

    def cast(x, dtype):
        if isinstance(x, GraphBatch):
            return GraphBatch(**{f.name: cast(getattr(x, f.name), dtype)
                                 for f in dataclasses.fields(GraphBatch)})
        return x.to(dtype) if x.is_floating_point() else x

    def step_grads(dev, dtype=torch.float32):
        m = make_model(dev).to(dtype)
        params = dict(m.named_parameters())
        b = dataclasses.replace(batch.to(dev), **{k: cast(getattr(batch.to(dev), k), dtype)
                                                  for k in ("protein", "molecule", "target",
                                                            "weight")})
        loss, _ = Trainer(m, TrainConfig(), device=dev).loss(b)
        return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

    grads = {"cuda": step_grads("cuda"),
             "cpu": cpu_reference(torch, lambda: step_grads("cpu"),
                                  f"{tag}f32 step gradients")}
    top = max(g.abs().max().item() for g in grads["cpu"].values())
    worst, noise, over = 0.0, [], {}
    for name, g_cpu in grads["cpu"].items():
        d = (grads["cuda"][name].cpu() - g_cpu).abs().max().item()
        scale = g_cpu.abs().max().item()
        bound = STEP_GRAD_RTOL * scale + STEP_GRAD_ATOL * top
        if d > bound:
            if not exact:
                raise AssertionError(f"{tag}f32 gradient of {name}: card vs CPU max|d| {d:.3e} "
                                     f"> {STEP_GRAD_RTOL} x max|g| {scale:.3e} + "
                                     f"{STEP_GRAD_ATOL} x {top:.3e}")
            over[name] = bound
        elif d > STEP_GRAD_RTOL * scale:
            noise.append(f"{name} (max|g| {scale:.2e}, max|d| {d:.2e})")
        else:
            worst = max(worst, d / scale if scale else 0.0)
    print(f"{tag}f32 step gradients, card vs CPU (TF32 off, dropout off): "
          f"{len(grads['cpu'])} parameters; largest entry {top:.4e}; worst max|d grad| / "
          f"max|grad| {worst:.3e} (limit {STEP_GRAD_RTOL}) over "
          f"{len(grads['cpu']) - len(noise) - len(over)}; held by the absolute term "
          f"({STEP_GRAD_ATOL} x {top:.3e}): {noise or 'none'}")
    if over:
        f64 = cpu_reference(torch, lambda: step_grads("cpu", torch.float64),
                            f"{tag}f64 step gradients")
        for name, bound in over.items():
            card = (grads["cuda"][name].cpu().double() - f64[name]).abs().max().item()
            cpu = (grads["cpu"][name].double() - f64[name]).abs().max().item()
            scale = f64[name].abs().max().item()
            print(f"{tag}f32 gradient of {name} (max|g| {scale:.3e}): card vs CPU beyond "
                  f"{bound:.3e}; against the f64 step on the CPU: card max|d| {card:.3e}, CPU "
                  f"f32 max|d| {cpu:.3e}")
            if card > cpu + bound:
                raise AssertionError(f"{tag}f32 gradient of {name}: the card is {card:.3e} from "
                                     f"the f64 gradient, the CPU's f32 {cpu:.3e} (+ {bound:.3e})")


def zoo_phase(torch, train_launches: dict) -> None:
    """The model zoo on the card: each of zoo_configs()'s eight JointGNNs at
    a seeded random init, at the flagship bucket. Serving: ZOO_REQUESTS
    requests eagerly and as CUDA-graph replays, bit for bit with equal
    launches, each against the port on the CPU (AFFINITY_ATOL,
    ATTENTION_ATOL); the replayed and eager request times; the eager
    forward's device time, its scatter_reduce kernels (segment_max) and
    segment_softmax's pieces timed alone at the same shapes (CUDA graphs).
    Training: ZOO_PASSES passes of bf16 Adam steps (dropout on) over a store
    of ZOO_PAIRS pairs, one eager step at a time against the graph path
    (warm-up, capture, replays): losses, predictions and parameters bit for
    bit, launches per step equal; the replayed step's time; one f32 step's
    gradients card vs CPU. K1, K2 and K3 must launch, K4, K5 and K6 must not.
    zoo-lba-gps is served only (its pe_norm is a MaskedBatchNorm), and
    zoo-gatv2-gine is served again with out_lin_norm_type='batch': the
    Trainer must refuse both. On zoo-cpd-gatv2 and zoo-lba-pna:
    run_model_on_dataset with the explainer over ZOO_EXPLAIN_PAIRS pairs,
    replayed and eager bit for bit, the first batch against the CPU; on
    zoo-cpd-gatv2 the same passes under ``remat_message()``, eager and
    replayed, bit for bit the steps without it, with the peak memory of
    each. Adds the training passes' launches to ``train_launches``."""
    import numpy as np

    from caster_dta_torch.data.batching import (BucketedLoader, dataset_budgets,
                                                synthetic_pair_batch, synthetic_pair_dataset)
    from caster_dta_torch.data.device_cache import DeviceResidentLoader, upload
    from caster_dta_torch.inference.checkpoint import build_model
    from caster_dta_torch.inference.evaluation import evaluate_batches
    from caster_dta_torch.inference.serve import LoadedRun, predict
    from caster_dta_torch.nn import gvp
    from caster_dta_torch.ops import cuda_attention as ca
    from caster_dta_torch.ops import cuda_gvp_message as cgm
    from caster_dta_torch.ops import cuda_segment as cs
    from caster_dta_torch.ops import launches as launch_counts
    from caster_dta_torch.ops import segment
    from caster_dta_torch.train import graphs
    from caster_dta_torch.train.loop import Trainer, TrainConfig

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    with open(os.path.join(RUN_DIR, "dataset_rescale_params.json")) as f:
        rescale = json.load(f)
    must, never = (cs.K1, cs.K2), (cgm.K5F, cgm.K5B, cgm.K6, ca.K4)
    flagship = tuple(FLAGSHIP[x] for x in ("n_p", "n_m"))

    def launched() -> dict:
        return {k: v for k, v in launch_counts.snapshot().items() if v}

    def check_path(tag, counts, need):
        if not all(counts.get(k, 0) > 0 for k in need) or any(counts.get(k, 0) for k in never):
            raise AssertionError(f"{tag}: {need} must launch and {never} must not; launched "
                                 f"{counts}")

    def runs(kw):
        return (LoadedRun(build_model(kw).to(cuda).eval(), kw, rescale, "", cuda),
                LoadedRun(build_model(kw).eval(), kw, rescale, "", cpu))

    def spread(times):
        return f"median {statistics.median(times):.3f} ms (min {times[0]:.3f}, max {times[-1]:.3f})"

    def serve(tag, kw, reqs):
        """Each request eager and replayed, bit for bit with equal launches,
        and against the CPU -> the run on the card."""
        run, run_cpu = runs(kw)
        predict(run, reqs[0])      # the bucket's capture
        torch.cuda.synchronize()
        per_request, worst = None, [0.0, 0.0]
        for i, batch in enumerate(reqs):
            launch_counts.reset()
            aff_e, attn_e = predict(run, batch, eager=True)
            torch.cuda.synchronize()
            eager_l = launched()
            launch_counts.reset()
            aff, attn = predict(run, batch)
            torch.cuda.synchronize()
            replay_l = launched()
            if not (torch.equal(aff, aff_e) and all(torch.equal(a, b)
                                                   for a, b in zip(attn, attn_e))):
                raise AssertionError(f"{tag} request {i}: the replayed answer is not the eager "
                                     "one bit for bit")
            if eager_l != replay_l or per_request not in (None, replay_l):
                raise AssertionError(f"{tag} request {i}: launches eager {eager_l}, replayed "
                                     f"{replay_l}, the first request {per_request}")
            per_request = replay_l
            aff = aff.cpu()
            if aff.shape != (batch.protein.batch_size,) or not torch.isfinite(aff).all():
                raise AssertionError(f"{tag} request {i}: affinities {tuple(aff.shape)} not "
                                     "finite")
            aff_cpu, attn_cpu = cpu_reference(torch, lambda: predict(run_cpu, batch),
                                              f"{tag} request {i}")
            worst[0] = max(worst[0], (aff - aff_cpu).abs().max().item())
            worst[1] = max(worst[1], max((a.cpu() - c).abs().max().item()
                                         for a, c in zip(attn, attn_cpu)))
        check_path(f"{tag} serving", per_request, must)
        print(f"{tag}: {len(reqs)} requests {reqs[0].bucket} B={reqs[0].protein.batch_size}, "
              f"replayed bit for bit the eager answers (affinities and attention maps), "
              f"launches per request {per_request} both ways; card vs CPU max|d affinity| "
              f"{worst[0]:.3e} (atol {AFFINITY_ATOL}), max|d attention| {worst[1]:.3e} (atol "
              f"{ATTENTION_ATOL})")
        if worst[0] > AFFINITY_ATOL or worst[1] > ATTENTION_ATOL:
            raise AssertionError(f"{tag}: card and CPU disagree beyond {AFFINITY_ATOL} / "
                                 f"{ATTENTION_ATOL}")
        replayed = event_times_ms(torch, lambda: predict(run, reqs[0]))
        eager = event_times_ms(torch, lambda: predict(run, reqs[0], eager=True), reps=10)
        print(f"{tag}: request latency (CUDA events): replayed {spread(replayed)}, eager "
              f"{spread(eager)}")
        return run

    def device_shares(tag, run, batch, kw):
        """The eager forward's device time, torch's scatter/gather kernels in
        it (segment_max's scatter_reduce, two a call; HEAT's per-type select
        and random_walk_pe's scatter_add_ and nothing else on these towers),
        and segment_softmax's pieces timed alone at the attention convs'
        shapes."""
        on_card = batch.to(cuda)
        counts = {}
        per_kernel, n_kernels = profile_forward(torch, lambda: predict(run, on_card, eager=True),
                                                counts=counts)
        busy = sum(per_kernel.values())
        if not busy:
            print(f"{tag}: device time not measured (the profiler saw no kernel)")
            return
        scatter = {n: ms for n, ms in per_kernel.items() if "scatter_gather" in n}
        n_scatter = sum(c for n, c in counts.items() if "scatter_gather" in n)
        print(f"{tag}: eager forward {busy:.3f} ms of kernels in {n_kernels:.0f} launches "
              f"(torch.profiler); torch's scatter/gather kernels (segment_max's "
              f"scatter_reduce, HEAT's per-type select, random_walk_pe's scatter_add_) "
              f"{n_scatter:.0f} launches, "
              f"{sum(scatter.values()):.4f} ms ({sum(scatter.values()) / busy:.1%}) in "
              + "; ".join(f"{n.split('(')[0][:80]} {ms:.4f} ms" for n, ms in scatter.items()))
        # segment_softmax's pieces at each attention tower's graph: H = 2 for
        # GATv2 and HEAT, 1 for AttentiveFP's GATE and GAT convs
        pieces_ms, calls = {}, 0
        for side, g in (("protein", on_card.protein), ("molecule", on_card.molecule)):
            base = kw[f"{side}_gnn_kwargs"]["base_conv"]
            if base not in ("gatv2", "heat", "attentivefp"):
                continue
            n_convs = kw[f"{side}_gnn_kwargs"]["num_convs"]
            calls += n_convs
            dst, mask, n = g.edge_dst, g.edge_mask, g.n_pad
            logits = torch.randn(g.batch_size, g.e_pad, 1 if base == "attentivefp" else 2,
                                 device=cuda)
            m = segment.segment_max(logits, dst, mask, n)
            m_e = segment.gather_nodes(m, dst)
            exp = torch.where(mask[..., None], torch.exp(logits - m_e), 0.0)
            denom = segment.segment_sum(exp, dst, mask, n)
            den_e = segment.gather_nodes(denom, dst)
            for piece, fn in (
                    ("segment_max (scatter_reduce)",
                     lambda: segment.segment_max(logits, dst, mask, n)),
                    ("gather max (K2)", lambda: segment.gather_nodes(m, dst)),
                    ("exp and mask", lambda: torch.where(mask[..., None],
                                                         torch.exp(logits - m_e), 0.0)),
                    ("denominators (K1)", lambda: segment.segment_sum(exp, dst, mask, n)),
                    ("gather denominators (K2)", lambda: segment.gather_nodes(denom, dst)),
                    ("divide", lambda: exp / torch.clamp(den_e, min=1e-16))):
                before = launch_counts.snapshot()
                pieces_ms[piece] = pieces_ms.get(piece, 0.0) + n_convs * graph_time_ms(torch, fn)
                launch_counts.add(launch_counts.since(before), -1)   # timing, not the path
        total = sum(pieces_ms.values())
        print(f"{tag}: segment_softmax ({calls} calls a forward) timed alone at the same "
              f"shapes (CUDA graphs): {total:.4f} ms a forward, {total / busy:.1%} of the eager "
              f"forward's kernel time: " + "; ".join(
                  f"{p} {ms:.4f} ms ({ms / busy:.1%})" for p, ms in pieces_ms.items()))

    def store_for(scalar):
        pairs = synthetic_pair_dataset(**ZOO_STORE, scalar_protein=scalar)
        store = DeviceResidentLoader(BucketedLoader(
            pairs, None, max_num=dataset_budgets("davis")[0], max_batch_size=FLAGSHIP["b"],
            seed=0, molecule_node_ladder=(FLAGSHIP["n_m"],)), device="cuda")
        (mega, _), = store.iter_megabatches()
        if (mega.bucket[0], mega.bucket[2]) != flagship or mega.n_steps < 3:
            raise AssertionError(f"the zoo store should fill the flagship bucket with "
                                 f"{ZOO_PAIRS} pairs: {mega.bucket}, {mega.n_steps} batches")
        return mega

    def train(tag, kw, mega, remat: bool = False):
        """ZOO_PASSES passes over ``mega``, eager against the graph path
        (and, with ``remat``, both again under remat_message)."""
        cfg = dict(compute_dtype="bfloat16", optimizer="adam", lr=1e-4, seed=0)
        k = mega.n_steps
        lrs = np.linspace(1e-4, 5e-5, k, dtype=np.float32)
        kinds = (False, True) if remat else (False,)
        trainers = {(r, path): Trainer(build_model(kw), TrainConfig(**cfg), device="cuda")
                    for r in kinds for path in ("eager", "graph")}
        peak = {}
        for n in range(ZOO_PASSES):
            ref = None
            for r in kinds:
                eager, graph = trainers[(r, "eager")], trainers[(r, "graph")]
                with gvp.remat_message(r):
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                    launch_counts.reset()
                    want = [eager.train_step(mega.batch(j), float(lrs[j])) for j in range(k)]
                    torch.cuda.synchronize()
                    peak[r] = (torch.cuda.max_memory_allocated() - base, base)
                    eager_l = launched()
                    launch_counts.reset()
                    losses, preds = graph.train_megabatch(mega, lrs)
                    torch.cuda.synchronize()
                    graph_l = launched()
                w_losses = torch.stack([w[0] for w in want])
                w_preds = torch.stack([w[1] for w in want])
                what = f"{tag}{' under remat' if r else ''} pass {n}"
                if not (torch.equal(losses, w_losses) and torch.equal(preds, w_preds)):
                    raise AssertionError(f"{what}: the graph path's losses or predictions are "
                                         "not the eager steps' bits")
                if graph_l != eager_l:
                    raise AssertionError(f"{what}: launches graph path {graph_l}, eager "
                                         f"{eager_l}")
                if ref is None:
                    ref = (w_losses, w_preds)
                elif not (torch.equal(ref[0], w_losses) and torch.equal(ref[1], w_preds)):
                    raise AssertionError(f"{what}: not the bits of the steps without remat")
                for name, v in graph_l.items():
                    train_launches[name] = train_launches.get(name, 0) + v
                check_path(what, graph_l, must + (cs.K3,))
                print(f"{what}: {k} bf16 Adam steps, losses "
                      f"{[round(x, 6) for x in losses.tolist()]}; the graph path "
                      f"({'warm-up, capture, replays' if n == 0 else 'replays'}) bit for bit "
                      f"the eager steps; launches per step "
                      f"{ {name: v // k for name, v in graph_l.items()} }")
        params = [t.params for t in trainers.values()]
        if not all(all(torch.equal(a, b) for a, b in zip(params[0], p)) for p in params[1:]):
            raise AssertionError(f"{tag}: parameters differ between the eager and graph "
                                 f"trainers{' and under remat' if remat else ''}")
        print(f"{tag}: all {len(params[0])} parameters bit for bit across "
              f"{len(trainers)} trainers after {ZOO_PASSES * k} steps")
        counts = {}
        scratch = Trainer(build_model(kw), TrainConfig(**cfg), device="cuda")
        before = launch_counts.snapshot()
        profile_forward(torch, lambda: scratch.train_step(mega.batch(0), float(lrs[0])), n=1,
                        counts=counts)
        launch_counts.add(launch_counts.since(before), -1)   # a count, not the path
        print(f"{tag}: torch's scatter/gather kernels per eager bf16 step (segment_max's "
              f"scatter_reduce and its backward's): "
              f"{sum(c for n, c in counts.items() if 'scatter_gather' in n):.0f} launches "
              "(torch.profiler)")
        graph = trainers[(False, "graph")]
        captured = graph.captured_step("train", mega)
        packed = upload(graphs.pack_rows(mega.p_rows, mega.m_rows, mega.target, mega.weight,
                                         lr=lrs, div=np.ones(k, np.float32)), cuda)
        turn = iter(range(1 << 30))
        steps = event_times_ms(torch, lambda: captured.run(packed[next(turn) % k]))
        print(f"{tag}: replayed step {mega.bucket} B={mega.p_rows.shape[1]} bf16 Adam "
              f"{spread(steps)} over {len(steps)} steps (CUDA events around the row copy and "
              f"the replay)")
        if remat:
            mib = {r: (p / 2 ** 20, b / 2 ** 20) for r, (p, b) in peak.items()}
            print(f"{tag}: peak memory of the last pass's {k} eager steps "
                  f"(torch.cuda.max_memory_allocated above the {mib[False][1]:.1f} MiB "
                  f"allocated before): without remat {mib[False][0]:.1f} MiB, under "
                  f"remat_message {mib[True][0]:.1f} MiB")

    def refuse_training(tag, kw):
        try:
            Trainer(build_model(kw), TrainConfig(), device="cuda")
        except NotImplementedError as e:
            print(f"{tag}: the Trainer refuses it: {e}")
        else:
            raise AssertionError(f"{tag}: the Trainer took a model with MaskedBatchNorm")

    configs = zoo_configs()
    for name, kw in configs.items():
        t0 = time.perf_counter()
        scalar = isinstance(kw["protein_gnn_kwargs"]["in_channels"], int)
        reqs = [synthetic_pair_batch(**FLAGSHIP, seed=100 + i, scalar_protein=scalar)
                for i in range(ZOO_REQUESTS)]
        run = serve(name, kw, reqs)
        device_shares(name, run, reqs[0], kw)
        if name == "zoo-lba-gps":
            # GPS's pe_norm is a MaskedBatchNorm: served on the init's
            # running statistics, never trained, as in JAX
            refuse_training(name, kw)
            print(f"{name}: {time.perf_counter() - t0:.2f} s")
            continue
        mega = store_for(scalar)
        train(name, kw, mega, remat=name == "zoo-cpd-gatv2")
        check_step_grads(torch, f"{name} ", lambda dev: build_model(kw).to(dev).eval(), reqs[0],
                         exact=True)

        if name in ("zoo-cpd-gatv2", "zoo-lba-pna"):
            # the explainer: each bucket and tower's 10-step loop one CUDA graph
            dataset = synthetic_pair_dataset(ZOO_EXPLAIN_PAIRS, 8, 8, [(100, 300)], (20, 64),
                                             seed=17)
            batches = list(BucketedLoader(dataset, max_num=4_000_000, max_batch_size=EVAL_BATCH,
                                          shuffle=False))
            runs_ = []
            for eager in (False, False, True):
                launch_counts.reset()
                t0 = time.perf_counter()
                records = evaluate_batches(run.model, dataset, batches, do_explainer=True,
                                           eager=eager)
                torch.cuda.synchronize()
                runs_.append((records, time.perf_counter() - t0, launched()))
            (first, s1, l1), (second, s2, l2), (eager_r, s3, l3) = runs_
            if not (records_equal(first, eager_r) and records_equal(second, eager_r)):
                raise AssertionError(f"{name} explainer: replayed records are not the eager "
                                     "ones bit for bit")
            if not l1 == l2 == l3:
                raise AssertionError(f"{name} explainer: launches {l1}, {l2}, {l3}")
            check_path(f"{name} explainer", l2, must + (cs.K3,))
            print(f"{name} explainer: run_model_on_dataset over {ZOO_EXPLAIN_PAIRS} pairs in "
                  f"{len(batches)} batches, replayed bit for bit the eager run; {s1:.3f} s "
                  f"with captures, {s2:.3f} s replayed, {s3:.3f} s eager; launches a run {l2}")
            cpu_run = runs(kw)[1]
            cpu_records = cpu_reference(torch, lambda: evaluate_batches(
                cpu_run.model, dataset, batches[:1], do_explainer=True), f"{name} explainer")
            check_records(f"{name} explainer", first, cpu_records, "the first batch")
        print(f"{name}: {time.perf_counter() - t0:.2f} s")

    # batch norm: served (running statistics of the init, as JAX loads
    # them), never trained
    kw = configs["zoo-gatv2-gine"]
    kw = {**kw, "joint_gnn_kwargs": {**kw["joint_gnn_kwargs"], "out_lin_norm_type": "batch"}}
    reqs = [synthetic_pair_batch(**FLAGSHIP, seed=100 + i, scalar_protein=True)
            for i in range(ZOO_REQUESTS)]
    serve("zoo-gatv2-gine batch norm", kw, reqs)
    refuse_training("zoo-gatv2-gine batch norm", kw)


def evaluate_phase(torch, run, run_cpu, eval_launches: dict) -> None:
    """run_model_on_dataset (caster_dta_torch/inference/evaluation.py) on the
    card with ``run``'s weights over EVAL_PAIRS seeded synthetic pairs, on
    the dense and the fused path with the explainer on and on the blockwise
    path without it. Each path runs three times: by replays (the first run
    captures each bucket's forward and, with the explainer, each bucket and
    tower's 10-step loop; the second only replays) and eagerly; every run
    must give the eager run's records bit for bit and the same launches.
    The first EVAL_CPU_BATCHES batches' records are held against the port on
    the CPU. Prints pairs/s with and without the explainer, the explainer's
    seconds per batch and the launches by kernel; K3 must launch on the
    dense path and K5 bwd on the fused one. Adds the launches of the
    replayed runs to ``eval_launches``."""
    import numpy as np

    from caster_dta_torch.data.batching import BucketedLoader, synthetic_pair_dataset
    from caster_dta_torch.inference.evaluation import evaluate_batches
    from caster_dta_torch.nn import gvp
    from caster_dta_torch.ops import cuda_attention as ca
    from caster_dta_torch.ops import cuda_gvp_message as cgm
    from caster_dta_torch.ops import cuda_segment as cs
    from caster_dta_torch.ops import launches as launch_counts

    dataset = synthetic_pair_dataset(EVAL_PAIRS, **EVAL_DATA)
    batches = list(BucketedLoader(dataset, max_num=4_000_000, max_batch_size=EVAL_BATCH,
                                  shuffle=False))
    print(f"evaluate: {EVAL_PAIRS} pairs in {len(batches)} batches of up to {EVAL_BATCH}, "
          f"buckets (N_P, E_P, N_M, E_M) {sorted({b.bucket for b in batches})}, real protein "
          f"edges {sum(int(b.protein.n_edge.sum()) for b in batches)}")
    n_cpu = sum(int(b.weight.sum()) for b in batches[:EVAL_CPU_BATCHES])

    def evaluate(model, **kw):
        launch_counts.reset()
        t0 = time.perf_counter()
        records = evaluate_batches(model, dataset, batches, **kw)
        torch.cuda.synchronize()
        return records, time.perf_counter() - t0, launch_counts.snapshot()

    for path, switch, pallas, explain in (("dense", contextlib.nullcontext, False, True),
                                          ("fused", gvp.fused_message, False, True),
                                          ("blockwise", contextlib.nullcontext, True, False)):
        for r in (run, run_cpu):
            set_use_pallas(r.model, pallas)
        with switch():
            first, s_first, l_first = evaluate(run.model, do_explainer=explain)
            second, s_second, l_second = evaluate(run.model, do_explainer=explain)
            eager, s_eager, l_eager = evaluate(run.model, do_explainer=explain, eager=True)
            if not (records_equal(first, eager) and records_equal(second, eager)):
                raise AssertionError(f"evaluate {path}: the replayed records are not the eager "
                                     "ones bit for bit")
            if not l_first == l_second == l_eager:
                raise AssertionError(f"evaluate {path}: launches differ: first {l_first}, "
                                     f"replays {l_second}, eager {l_eager}")
            launched = {k: v for k, v in l_second.items() if v}
            for k, v in l_second.items():
                eval_launches[k] = eval_launches.get(k, 0) + l_first[k] + v
            n = len(first["pair_idx"])
            if n != EVAL_PAIRS or first["pair_idx"] != sorted(first["pair_idx"]):
                raise AssertionError(f"evaluate {path}: {n} records, or not sorted")
            if not all(math.isfinite(a) for a in first["affinity_score"]):
                raise AssertionError(f"evaluate {path}: an affinity is not finite")
            what = "with the explainer" if explain else "without the explainer"
            print(f"evaluate {path} {what}: records bit for bit the eager run's (first run "
                  f"with captures, second replays only); launches a run {launched}")
            print(f"evaluate {path} {what}: first run {s_first:.3f} s ({n / s_first:.2f} "
                  f"pairs/s), replays {s_second:.3f} s ({n / s_second:.2f} pairs/s), eager "
                  f"{s_eager:.3f} s ({n / s_eager:.2f} pairs/s)")
            if explain:
                plain, s_plain, _ = evaluate(run.model, do_explainer=False)
                print(f"evaluate {path} without the explainer (replays): {s_plain:.3f} s "
                      f"({n / s_plain:.2f} pairs/s); the explainer's seconds per batch: "
                      f"replayed {(s_second - s_plain) / len(batches):.4f}, eager "
                      f"{(s_eager - s_plain) / len(batches):.4f} (the eager forward included)")
                for k in ("affinity_score", "prot_mol_attention"):
                    if not all(np.array_equal(a, b) for a, b in zip(plain[k], second[k])):
                        raise AssertionError(f"evaluate {path}: {k} moved with the explainer")
            need = {"dense": (cs.K1, cs.K2, cs.K3), "fused": (cgm.K5F, cgm.K5B, cgm.K6, cs.K3),
                    "blockwise": (ca.K4,)}[path]
            if not all(l_second[k] > 0 for k in need):
                raise AssertionError(f"evaluate {path}: {need} must launch, launched {launched}")

            cpu = cpu_reference(torch, lambda: evaluate_batches(
                run_cpu.model, dataset, batches[:EVAL_CPU_BATCHES], do_explainer=explain),
                f"evaluate {path}")
            check_records(f"evaluate {path}", first, cpu,
                          f"the first {EVAL_CPU_BATCHES} batches ({n_cpu} pairs)")
        for r in (run, run_cpu):
            set_use_pallas(r.model, False)


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
    import numpy as np

    from caster_dta_torch.data.batching import (BucketedLoader, dataset_budgets,
                                                synthetic_pair_batch, synthetic_pair_dataset)
    from caster_dta_torch.data.device_cache import DeviceResidentLoader, upload
    from caster_dta_torch.inference.replay import replayed_forward
    from caster_dta_torch.inference.serve import load_run, predict
    from caster_dta_torch.models.joint import make_joint_gnn
    from caster_dta_torch.nn import gvp
    from caster_dta_torch.nn.common import compute_dtype
    from caster_dta_torch.ops import attention as attention_ops
    from caster_dta_torch.ops import cuda_attention as ca
    from caster_dta_torch.ops import cuda_gvp_message as cgm
    from caster_dta_torch.ops import cuda_segment as cs
    from caster_dta_torch.ops import launches as launch_counts
    from caster_dta_torch.ops import segment
    from caster_dta_torch.train import checkpoints, graphs
    from caster_dta_torch.train.loop import Trainer, TrainConfig, fit, split_dataset

    with phase("device"):
        device_name = torch.cuda.get_device_name(0)
        smi = nvidia_smi()
        print(f"torch {torch.__version__} cuda {torch.version.cuda} device {device_name}; "
              f"{torch.cuda.device_count()} visible")
        print(f"nvidia-smi: {smi}")
        print(f"f32 matmuls: precision {torch.get_float32_matmul_precision()}, TF32 in "
              f"cuBLAS {torch.backends.cuda.matmul.allow_tf32}, in cuDNN "
              f"{torch.backends.cudnn.allow_tf32}; removed from the environment: "
              f"{overridden or 'nothing'}; CPU threads {torch.get_num_threads()}")

    with phase("build"):
        # one nvcc per source, all started together
        with ThreadPoolExecutor(3) as pool:
            builds = list(pool.map(lambda module: module.load_library(), (cs, cgm, ca)))
        for built in builds:
            for line in built.log.splitlines():
                if "ptxas" in line and ("registers" in line or "Compiling entry" in line
                                        or "spill" in line):
                    print(line)
            print(f"built {os.path.relpath(built.path, HERE)} in {built.seconds:.2f} s "
                  f"({'cached' if built.seconds == 0 else 'nvcc'})")

    reset_launches, launches_now = launch_counts.reset, launch_counts.snapshot

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    # the zoo's kernel cases draw from their own stream, so every other
    # case's inputs stay as they were before them
    zoo_gen = torch.Generator(device="cuda")
    zoo_gen.manual_seed(17)
    requests = [(f"flagship #{i}", synthetic_pair_batch(**FLAGSHIP, seed=i))
                for i in range(N_REQUESTS_FLAGSHIP)]
    requests.append(("davis", synthetic_pair_batch(**DAVIS, seed=N_REQUESTS_FLAGSHIP)))
    large = ("large protein", synthetic_pair_batch(**LARGE, seed=N_REQUESTS_FLAGSHIP + 1))
    max_err = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K4": 0.0, "K5 fwd": 0.0, "K5 bwd": 0.0,
               "K6": 0.0, "K7": 0.0, "K8": 0.0}
    phase_launches = {}   # K4, K7, K8: launches over the phases that run them

    def check_k1(what, msgs, dst, mask, n):
        """K1 against its plain version on the card (atomic order, within
        K1_RTOL/K1_ATOL) and on the CPU (edge order, bit for bit), and a second
        call's bits -> (max_abs_err against the CPU, against the card's)."""
        got = cs.segment_sum_sorted(msgs, dst, mask, n)
        again = cs.segment_sum_sorted(msgs, dst, mask, n)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"K1 {what} {msgs.dtype}: two calls gave other bits")
        card = cs.segment_sum_sorted_plain(msgs, dst, mask, n)
        torch.testing.assert_close(got, card, rtol=K1_RTOL, atol=K1_ATOL)
        cpu = cpu_reference(torch, lambda: cs.segment_sum_sorted_plain(
            msgs.cpu(), dst.cpu(), mask.cpu(), n), f"K1 {what}")
        got = got.cpu()
        torch.testing.assert_close(got, cpu, rtol=K1_RTOL, atol=K1_ATOL)
        if not torch.equal(got, cpu):
            raise AssertionError(f"K1 {what} {msgs.dtype}: not the CPU plain version's bits")
        err = (got - cpu).abs().max().item() if got.numel() else 0.0
        max_err["K1"] = max(max_err["K1"], err)
        return err, ((got - card.cpu()).abs().max().item() if got.numel() else 0.0)

    def check_k8(label, p):
        """K8 at a request's protein aggregation, on messages zeroed where
        masked: within K8_RTOL/K8_ATOL of its plain version on the card, bit for
        bit the CPU's and K1's on the same masked rows -> the masked messages."""
        n, dst = p.n_pad, p.edge_dst
        msgs = torch.randn(p.batch_size, p.e_pad, 28, generator=gen, device="cuda")
        masked = torch.where(p.edge_mask[..., None], msgs, 0.0).contiguous()
        got = cs.segment_sum_2d(masked, dst, n)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, cs.segment_sum_2d_plain(masked, dst, n), rtol=K8_RTOL,
                                   atol=K8_ATOL)
        card_err = (got - cs.segment_sum_2d_plain(masked, dst, n)).abs().max().item()
        cpu = cpu_reference(torch, lambda: cs.segment_sum_2d_plain(masked.cpu(), dst.cpu(), n),
                            f"K8 {label}")
        if not torch.equal(got.cpu(), cpu):
            raise AssertionError(f"K8 {label}: not the CPU plain version's bits")
        if not torch.equal(got, cs.segment_sum_sorted(msgs, dst, p.edge_mask, n)):
            raise AssertionError(f"K8 {label}: not K1's bits on the same masked rows")
        max_err["K8"] = max(max_err["K8"], (got.cpu() - cpu).abs().max().item())
        print(f"K8 {label} protein aggregation: msgs {tuple(msgs.shape)} -> N={n}, longest dst "
              f"range {longest_range(dst)}: bit for bit the CPU's plain version and K1 on the "
              f"same masked rows; against the plain version on the card max_abs_err "
              f"{card_err:.3e}")
        return masked

    with phase("kernels"), torch.no_grad():
        for label, batch in (requests[0], requests[-1]):
            cases = kernel_cases(torch, batch, gen)
            if batch is requests[0][1]:    # and at the zoo's row widths
                for k, more in zoo_kernel_cases(torch, batch, zoo_gen).items():
                    cases.setdefault(k, []).extend(more)
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
                    _, card_err = check_k1(f"{label} {name}", msgs.to(dtype), dst, mask, n)
                    print(f"K1 {label} {name} {str(dtype)[6:]}: msgs {tuple(msgs.shape)} -> "
                          f"N={n}, longest dst range {longest_range(dst)}: bit for bit the "
                          f"CPU's plain version, the same bits twice; against the plain "
                          f"version on the card max_abs_err {card_err:.3e}")
        # the large-protein request's aggregations: its padding row holds
        # ~30,000 masked edges a graph
        for name, msgs, dst, mask, n in kernel_cases(torch, large[1], gen)["K1"]:
            for dtype in (torch.float32, torch.bfloat16):
                _, card_err = check_k1(f"{large[0]} {name}", msgs.to(dtype), dst, mask, n)
                print(f"K1 {large[0]} {name} {str(dtype)[6:]}: msgs {tuple(msgs.shape)} -> "
                      f"N={n}, longest dst range {longest_range(dst)}: bit for bit the CPU's "
                      f"plain version, the same bits twice; against the plain version on the "
                      f"card max_abs_err {card_err:.3e}")
        for name, msgs, dst, mask, n in edge_cases(torch, gen):
            for dtype in (torch.float32, torch.bfloat16):
                m = msgs.to(dtype)
                check_k1(f"edge case {name}", m, dst, mask, n)
                got = cs.segment_sum_sorted(m, dst, mask, n)
                want = cs.segment_sum_sorted_plain(m, dst, mask, n)
                empty = want.abs().sum(-1) == 0
                if not torch.all(got[empty] == 0):
                    raise AssertionError(f"K1 edge case {name}: an empty row is not 0")
            table = torch.randn(msgs.shape[0], n, msgs.shape[2], generator=gen, device="cuda")
            idx = torch.randint(0, n, (msgs.shape[0], msgs.shape[1] + 3), generator=gen,
                                device="cuda", dtype=torch.int32)
            if not torch.equal(cs.gather_rows(table, idx), cs.gather_rows_plain(table, idx)):
                raise AssertionError(f"K2 edge case {name}: not bit-exact")
            torch.cuda.synchronize()
            print(f"edge case {name}: K1 bit for bit the CPU's, empty rows 0; K2 bit-exact")
        print(f"K1 max_abs_err {max_err['K1']:.3e} against the plain version on the CPU "
              f"(rtol {K1_RTOL}, atol {K1_ATOL}, and bit for bit); K2 max_abs_err "
              f"{max_err['K2']:.1e} (bit-exact)")

        # K5 with the trained model's message weights (both GVP convs have the
        # same widths; the first conv's weights), K6 on the node table
        trained = load_run(RUN_DIR, device="cuda").model
        p_convs = [layer.conv for layer in trained.protein_gnn.gnn_model.conv_list]
        weights = [w.detach() for w in cgm.layer_weights(p_convs[0].message_func)]
        acts = p_convs[0].activations
        for label, batch in (requests[0], requests[-1]):
            b, e = batch.protein.batch_size, batch.protein.e_pad
            for kind in K5_DTYPES:
                spec = cgm.MessageSpec(16, 4, acts[0], acts[1],
                                       getattr(torch, K5_DTYPES[kind][3]))
                inputs = k5_inputs(torch, gen, b, e, kind)
                route = cgm.bwd_kernel(*inputs[:3], weights, inputs[3], spec)
                route_f = cgm.fwd_kernel(*inputs[:3], weights, spec)
                if route_f != "warp tiles, served":
                    raise AssertionError(f"K5 fwd {label} {kind} runs on {route_f}")
                k5_check(torch, cgm, f"{label} {kind} (K5 fwd on {route_f}, K5 bwd on {route})",
                         inputs, weights, spec, max_err)
            table = torch.randn(b, batch.protein.n_pad, 28, generator=gen, device="cuda")
            flat = table.reshape(-1)
            f32, bf16 = torch.float32, torch.bfloat16
            for src, dst in ((f32, f32), (f32, bf16), (bf16, f32), (bf16, bf16)):
                # the table, and an odd-length slice from element 1 (off 16-byte alignment)
                for x in (table.to(src), flat[:-2].to(src)[1:]):
                    if not torch.equal(cgm.cast_copy(x, dst), cgm.cast_copy_plain(x, dst)):
                        raise AssertionError(f"K6 {label} {src} -> {dst} {tuple(x.shape)}: "
                                             f"not bit-exact")
            torch.cuda.synchronize()
            print(f"K6 {label}: table {tuple(table.shape)} and a misaligned odd-length slice, "
                  f"f32->f32, f32->bf16, bf16->f32, bf16->bf16 bit-exact")
        for kind in K5_DTYPES:
            spec = cgm.MessageSpec(16, 4, acts[0], acts[1], getattr(torch, K5_DTYPES[kind][3]))
            k5_check(torch, cgm, f"edge case E=1000 (off the tiles) B=3 {kind}",
                     k5_inputs(torch, gen, 3, 1000, kind), weights, spec, max_err)
            one = gvp.GVPConv((16, 4), (16, 4), (32, 1), n_layers=1, activations=acts,
                              vector_gate=True, generator=torch.Generator().manual_seed(1))
            k5_check(torch, cgm, f"edge case one layer B=2 E=77 {kind}",
                     k5_inputs(torch, gen, 2, 77, kind),
                     [w.detach().cuda() for w in cgm.layer_weights(one.message_func)],
                     spec, max_err)
        # a fused conv whose edges are all masked: K5 still runs on every
        # edge, and K1 drops them all, so the output and every gradient are 0
        p = requests[0][1].protein.to("cuda")
        n, e = p.n_pad, p.e_pad
        x = [torch.randn(p.batch_size, n, 16, generator=gen, device="cuda"),
             torch.randn(p.batch_size, n, 4, 3, generator=gen, device="cuda"),
             torch.randn(p.batch_size, e, 32, generator=gen, device="cuda"),
             torch.randn(p.batch_size, e, 1, 3, generator=gen, device="cuda")]
        x = [t.requires_grad_() for t in x]
        reset_launches()
        with torch.enable_grad(), gvp.fused_message():
            out_s, out_v = p_convs[0]((x[0], x[1]), p.edge_src, p.edge_dst,
                                      torch.zeros_like(p.edge_mask), (x[2], x[3]))
            grads = torch.autograd.grad(out_s.sum() + out_v.sum(),
                                        x + list(p_convs[0].parameters()))
        torch.cuda.synchronize()
        if cgm.LAUNCHES[cgm.K5F] != 1 or cgm.LAUNCHES[cgm.K5B] != 1:
            raise AssertionError(f"all-masked fused conv: launches {launches_now()}")
        if not (torch.all(out_s == 0) and torch.all(out_v == 0)
                and all(torch.all(g == 0) for g in grads)):
            raise AssertionError("all-masked fused conv: an output or a gradient is not 0")
        print(f"edge case all edges masked: fused conv output and {len(grads)} gradients "
              f"exactly 0")
        print(f"K5 fwd max_abs_err {max_err['K5 fwd']:.3e}, K5 bwd max_abs_err "
              f"{max_err['K5 bwd']:.3e} (tolerances {K5_TOL}); K6 bit-exact")

        # K4 at the served model's cross-attention widths, with each
        # request's masks, against its plain version; a second run must give
        # the first run's bits
        mha = trained.cross_attn_module.cross_attn_layers[0].embed1_to_2
        heads, hd = mha.num_heads, mha.embed_dim // mha.num_heads

        def k4_check(what, q, k, v, mask, cast=False):
            run_k4 = attention_ops.masked_mha if cast else ca.masked_mha
            got, again = run_k4(q, k, v, mask), run_k4(q, k, v, mask)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"K4 {what}: two runs gave different bits")
            want = ca.masked_mha_plain(q, k, v, mask)
            torch.testing.assert_close(got, want, rtol=K4_TOL, atol=K4_TOL)
            err = (got - want).abs().max().item()
            max_err["K4"] = max(max_err["K4"], err)
            return got, err

        for label, batch in (requests[0], requests[-1], large):
            for name, q, k, v, mask in k4_cases(torch, batch, gen, heads, hd):
                _, err = k4_check(f"{label} {name}", q, k, v, mask)
                print(f"K4 {label} {name}: q {tuple(q.shape)} k {tuple(k.shape)}, "
                      f"{int(mask.sum())} masked keys: max_abs_err {err:.3e}; a second run gave "
                      f"the same bits")
        for what, q, k, v, mask in k4_edge_cases(torch, gen):
            got, err = k4_check(what, q, k, v, mask)
            note = ""
            if what.startswith("a fully masked graph"):
                mean = v[0].mean(dim=1, keepdim=True).expand_as(got[0])
                torch.testing.assert_close(got[0], mean, rtol=K4_TOL, atol=K4_TOL)
                note = "; the masked graph's rows equal the mean of v"
            print(f"K4 edge case {what}: max_abs_err {err:.3e}{note}")
        q, k, v, mask = k4_cases(torch, requests[0][1], gen, heads, hd)[0][1:]
        _, err = k4_check("bf16 inputs", *(t.to(torch.bfloat16) for t in (q, k, v)), mask,
                          cast=True)
        print(f"K4 bf16 inputs (cast to f32 by ops.attention.masked_mha): max_abs_err {err:.3e}")
        print(f"K4 max_abs_err {max_err['K4']:.3e} (rtol, atol {K4_TOL})")

        # K7 and K8 lie on no path: their launches are counted over this part
        reset_launches()
        for label, batch in (requests[0], requests[-1], large):
            p = batch.protein.to("cuda")
            b, n, e = p.batch_size, p.n_pad, p.e_pad
            if batch is large[1]:   # K8 alone at the large protein
                masked = check_k8(label, p)
                continue
            table = torch.randn(b, n, 28, generator=gen, device="cuda")
            order = torch.argsort(torch.rand(b, e, generator=gen, device="cuda"), dim=1)
            shuffled = torch.gather(p.edge_dst, 1, order).contiguous()
            for name, idx in (("dst (sorted)", p.edge_dst), ("src", p.edge_src),
                              ("shuffled dst", shuffled)):
                for dtype in (torch.float32, torch.bfloat16):
                    t = table.to(dtype)
                    got = cs.gather_windowed(t, idx)
                    torch.cuda.synchronize()
                    if not (torch.equal(got, cs.gather_rows(t, idx))
                            and torch.equal(got, cs.gather_windowed_plain(t, idx))):
                        raise AssertionError(f"K7 {label} {name} {dtype}: not equal to K2 and "
                                             f"its plain version")
                print(f"K7 {label} {name}: table {tuple(table.shape)} idx {tuple(idx.shape)} "
                      f"equals K2 and its plain version bit for bit (f32, bf16)")
            masked = check_k8(label, p)
        try:
            cs.segment_sum_2d(masked.to(torch.bfloat16), p.edge_dst, n)
        except TypeError as refusal:
            print(f"K8 refuses bf16: {refusal}")
        else:
            raise AssertionError("K8 took bf16 messages")
        phase_launches.update({cs.K7: cs.LAUNCHES[cs.K7], cs.K8: cs.LAUNCHES[cs.K8]})
        print(f"K7 bit-exact; K8 max_abs_err {max_err['K8']:.3e} against the plain version "
              f"on the CPU (rtol {K8_RTOL}, atol {K8_ATOL}, and bit for bit); launches in this "
              f"part {phase_launches}")

    def serve_path(tag: str, run, run_cpu, per_forward: dict, reqs=requests,
                   timed=(requests[0], requests[-1]), k5f_kind=None, k4_rows=None) -> tuple:
        """Answer every request of ``reqs`` on the card twice, eagerly
        (``predict(eager=True)``: pageable copy, eager forward) and by a
        CUDA-graph replay fed from a pinned buffer (``predict``), each bucket
        captured first: the replayed answers must equal the eager ones bit
        for bit (affinities and attention maps) with the same launches per
        forward, the launches that the code gives. Hold each answer against
        the port's CPU run, time both ways at the ``timed`` buckets (request
        latency, the batch copy pageable against pinned, the forward alone,
        the card's idle share of each) and profile the eager forward (with
        ``k5f_kind``, check that K5 fwd ran that served instance; with
        ``k4_rows``, that K4 ran that instance of its row kernel) -> (the
        replayed answers, their launches)."""
        replayed = replayed_forward(run.model)
        for label, batch in reqs:
            if replayed.staged(batch.protein, batch.molecule) is None:
                t0 = time.perf_counter()
                predict(run, batch)      # answered eagerly on the capture stream, then captured
                torch.cuda.synchronize()
                print(f"{tag}capture {label} {batch.bucket} B={batch.protein.batch_size}: "
                      f"{time.perf_counter() - t0:.3f} s with its eager first answer")
        reset_launches()
        eager = [predict(run, batch, eager=True) for _, batch in reqs]
        torch.cuda.synchronize()
        eager_launches = launches_now()
        reset_launches()
        replays = replayed.replays
        answers = [predict(run, batch) for _, batch in reqs]
        torch.cuda.synchronize()
        launches = launches_now()
        if replayed.replays - replays != len(reqs):
            raise AssertionError(f"{tag}{replayed.replays - replays} replays for {len(reqs)} "
                                 f"requests")
        want = {k: v * len(reqs) for k, v in per_forward.items()}
        print(f"{tag}launches over {len(reqs)} requests: replayed {launches}, eager "
              f"{eager_launches} (expected {want})")
        if launches != want or eager_launches != want:
            raise AssertionError(f"{tag}launch counts {launches} / {eager_launches} != "
                                 f"expected {want}")
        for (label, _), (aff, attn), (aff_e, attn_e) in zip(reqs, answers, eager):
            same = torch.equal(aff, aff_e) and all(
                (a is None and b is None) or (a is not None and b is not None
                                              and torch.equal(a, b))
                for a, b in zip(attn, attn_e))
            if not same:
                raise AssertionError(f"{tag}{label}: the replayed answer is not the eager "
                                     f"one bit for bit")
        print(f"{tag}replayed answers equal the eager ones bit for bit over {len(reqs)} "
              f"requests (affinities and attention maps)")

        worst = {"affinity": 0.0, "attention": 0.0}
        disagree = []
        for (label, batch), (aff, attn) in zip(reqs, answers):
            aff = aff.cpu()
            if aff.shape != (batch.protein.batch_size,) or not torch.isfinite(aff).all():
                raise AssertionError(f"{label}: affinities {tuple(aff.shape)} not finite")
            aff_cpu, attn_cpu = cpu_reference(torch, lambda: predict(run_cpu, batch),
                                              f"{tag}{label}")
            d_aff = (aff - aff_cpu).abs().max().item()
            no_maps = [all(a is None for a in x) for x in (attn, attn_cpu)]
            if no_maps[0] != no_maps[1]:
                raise AssertionError(f"{tag}{label}: attention maps on one device only")
            d_att = 0.0 if no_maps[0] else max((a.cpu() - c).abs().max().item()
                                               for a, c in zip(attn, attn_cpu))
            worst["affinity"] = max(worst["affinity"], d_aff)
            worst["attention"] = max(worst["attention"], d_att)
            maps = ("attention (None, None) on both devices" if no_maps[0]
                    else f"max|d attention| {d_att:.3e}")
            print(f"{tag}{label} {batch.bucket}: B={len(aff)} affinity range "
                  f"[{aff.min().item():.4f}, {aff.max().item():.4f}] finite; vs CPU "
                  f"max|d affinity| {d_aff:.3e}, {maps}")
            if d_aff > AFFINITY_ATOL or d_att > ATTENTION_ATOL:
                # a second card answer to the same request tells a card that
                # disagrees with itself from one that computes something else
                again = predict(run, batch)[0].cpu()
                disagree.append(f"{label}: max|d affinity| {d_aff:.3e}, max|d attention| "
                                f"{d_att:.3e}, card again vs card first "
                                f"{(again - aff).abs().max().item():.3e}")
        if disagree:
            print("card and CPU disagree:\n  " + "\n  ".join(disagree), file=sys.stderr)
            raise AssertionError(f"{tag}{len(disagree)} of {len(reqs)} requests: card and "
                                 f"CPU disagree beyond {AFFINITY_ATOL} / {ATTENTION_ATOL}")
        print(f"{tag}card vs CPU over all requests: max|d affinity| {worst['affinity']:.3e} "
              f"(atol {AFFINITY_ATOL}), max|d attention| {worst['attention']:.3e} "
              f"(atol {ATTENTION_ATOL})")

        def spread(times):
            return (f"median {statistics.median(times):.3f} ms (min {times[0]:.3f}, max "
                    f"{times[-1]:.3f})")

        def idle(fn, wall_ms):
            busy = sum(profile_forward(torch, fn)[0].values())
            return (f"{1 - busy / wall_ms:.1%} ({busy:.3f} ms of kernels)" if busy
                    else "not measured (the profiler saw no kernel)")

        for label, batch in timed:
            on_card = batch.to("cuda")
            layout, pinned, step = replayed.staged(batch.protein, batch.molecule)
            request_e = event_times_ms(torch, lambda: predict(run, batch, eager=True))
            request_r = event_times_ms(torch, lambda: predict(run, batch))
            copy_e = event_times_ms(torch, lambda: batch.to("cuda"))
            copy_r = event_times_ms(torch, lambda: step.row.copy_(pinned, non_blocking=True))
            pack = []
            for _ in range(20):
                t0 = time.perf_counter()
                layout.pack(pinned, batch.protein, batch.molecule)
                pack.append((time.perf_counter() - t0) * 1e3)
            forward_e = event_times_ms(torch, lambda: predict(run, on_card, eager=True))
            forward_r = event_times_ms(torch, step.replay)
            what = f"{label} {batch.bucket} B={batch.protein.batch_size}"
            print(f"{tag}request latency {what} over {len(request_e)} (CUDA events): eager "
                  f"{spread(request_e)}, replayed {spread(request_r)}")
            print(f"{tag}batch copy {what}: pageable (GraphBatch.to) {spread(copy_e)}, pinned "
                  f"(one row of {layout.width * 4} bytes, non_blocking) {spread(copy_r)}; "
                  f"packing the pinned row on the host median {statistics.median(pack):.3f} ms")
            print(f"{tag}forward {what} on a card-resident batch: eager {spread(forward_e)}, "
                  f"replay {spread(forward_r)}")
            print(f"{tag}device idle {what}: eager request "
                  f"{idle(lambda: predict(run, batch, eager=True), statistics.median(request_e))}"
                  f", replayed request "
                  f"{idle(lambda: predict(run, batch), statistics.median(request_r))}, replay "
                  f"{idle(step.replay, statistics.median(forward_r))} (torch.profiler)")
            per_kernel, n_kernels = profile_forward(torch, lambda: predict(run, on_card,
                                                                           eager=True))
            if k5f_kind is not None:
                check_k5f_served(f"{tag}{label} ", per_kernel, k5f_kind)
            if k4_rows is not None:
                check_k4_served(f"{tag}{label} ", per_kernel, k4_rows)
            busy = sum(per_kernel.values())
            if busy == 0:
                print(f"{tag}device time {label}: not measured (the profiler saw no kernel)")
                continue
            print(f"{tag}device time {label}: {busy:.3f} ms in {n_kernels:.0f} kernels per "
                  f"forward, device idle {1 - busy / statistics.median(forward_e):.1%} of the "
                  f"eager forward (torch.profiler)")
            print(f"{tag}device time by group {label}: " + ", ".join(
                f"{g} {ms:.3f} ms ({ms / busy:.1%})" for g, ms in kernel_groups(per_kernel).items()))
        return answers, launches

    with phase("serve"):
        run = load_run(RUN_DIR, device="cuda")
        print(f"loaded {os.path.relpath(run.param_file, HERE)}")
        model = run.model
        n_p = len(model.protein_gnn.gnn_model.conv_list)
        n_m = len(model.molecule_gnn.gnn_model.conv_list)
        run_cpu = load_run(RUN_DIR, device="cpu")
        # aggr 'sum': one K1 and one K2 per conv; no backward, so no K3; the
        # fused message path is off, so no K5 or K6
        per_forward = {cs.K1: n_p + n_m, cs.K2: n_p + n_m, cs.K3: 0, cs.K7: 0, cs.K8: 0,
                       cgm.K5F: 0, cgm.K5B: 0, cgm.K6: 0, ca.K4: 0}
        answers, _ = serve_path("", run, run_cpu, per_forward)

    with phase("serve-fused"):
        # each GVP conv pins its node table (K6) and runs its message MLP in
        # K5 fwd; the gathers and aggregations stay as they were
        per_forward_fused = {**per_forward, cgm.K5F: n_p, cgm.K6: n_p}
        with gvp.fused_message():
            fused_answers, _ = serve_path("fused ", run, run_cpu, per_forward_fused,
                                          k5f_kind="f32")
        worst = 0.0
        for (label, batch), (aff, _), (aff_fused, _) in zip(requests, answers, fused_answers):
            d = (aff_fused - aff).abs().max().item()
            worst = max(worst, d)
            if d > AFFINITY_ATOL:
                raise AssertionError(f"{label}: fused and unfused card answers differ by "
                                     f"{d:.3e} > {AFFINITY_ATOL} pKd")
        print(f"fused vs unfused on the card (f32) over all requests: max|d affinity| "
              f"{worst:.3e} (atol {AFFINITY_ATOL})")

    with phase("serve-blockwise"):
        # use_pallas on both MultiheadAttention modules: each cross-attention
        # direction is one K4 launch; the towers run as unfused
        n_attn = 2 * len(model.cross_attn_module.cross_attn_layers)
        per_forward_blockwise = {**per_forward, ca.K4: n_attn}
        # the dense card answer to the large request, before the switch
        dense_large, dense_large_attn = predict(run, large[1], eager=True)
        replayed = [predict(run, large[1]) for _ in range(2)]   # the capture, then a replay
        if not all(torch.equal(aff, dense_large) and all(torch.equal(a, b) for a, b in zip(
                attn, dense_large_attn)) for aff, attn in replayed):
            raise AssertionError("large protein, dense: the replayed answer is not the eager "
                                 "one bit for bit")
        print("large protein, dense: the replayed answer equals the eager one bit for bit "
              "(affinities and attention maps)")
        for r in (run, run_cpu):
            set_use_pallas(r.model, True)
        blockwise_answers, launches = serve_path(
            "blockwise ", run, run_cpu, per_forward_blockwise, requests + [large],
            (requests[0], requests[-1], large), k4_rows=ca._ROWS)
        for r in (run, run_cpu):
            set_use_pallas(r.model, False)
        phase_launches[ca.K4] = launches[ca.K4]
        worst = 0.0
        for (label, _), (aff, attn), dense in zip(requests + [large], blockwise_answers,
                                                 [a for a, _ in answers] + [dense_large]):
            if not all(a is None for a in attn):
                raise AssertionError(f"blockwise {label}: attention maps came back")
            d = (aff - dense).abs().max().item()
            worst = max(worst, d)
            if d > AFFINITY_ATOL:
                raise AssertionError(f"{label}: blockwise and dense card answers differ by "
                                     f"{d:.3e} > {AFFINITY_ATOL} pKd")
        print(f"blockwise vs dense on the card (f32) over all requests, the large one "
              f"included: max|d affinity| {worst:.3e} (atol {AFFINITY_ATOL})")

    eval_launches: dict = {}
    with phase("evaluate"):
        evaluate_phase(torch, run, run_cpu, eval_launches)
        phase_launches[ca.K4] += eval_launches[ca.K4]
        print(f"launches over the evaluate phase's replayed runs: {eval_launches}")

    with phase("k3"), torch.no_grad():
        def check_k3(what, rows, ids, n):
            """K3 against the CPU's plain version (tolerance and bits), a second
            call's bits, and the CSR launch alone against scatter_csr_plain."""
            row_ptr, perm = cs.scatter_csr(ids, n)
            want_ptr, want_perm = cs.scatter_csr_plain(ids.cpu(), n)
            if not (torch.equal(row_ptr.cpu(), want_ptr) and torch.equal(perm.cpu(), want_perm)):
                raise AssertionError(f"K3 {what}: the CSR differs from scatter_csr_plain's")
            counts = want_ptr[:, 1:] - want_ptr[:, :-1]
            for dtype in (torch.float32, torch.bfloat16):
                r = rows.to(dtype)
                first = cs.scatter_rows(r, ids, n)
                if not torch.equal(first, cs.scatter_rows(r, ids, n)):
                    raise AssertionError(f"K3 {what} {dtype}: two calls gave other bits")
                got = first.cpu()
                want = cpu_reference(torch, lambda: cs.scatter_rows_plain(
                    r.cpu(), ids.cpu(), n), f"K3 {what}")
                torch.testing.assert_close(got, want, rtol=K3_RTOL, atol=K3_ATOL)
                if not torch.equal(got, want):
                    raise AssertionError(f"K3 {what} {dtype}: not the plain version's bits")
                if not torch.all(got[counts == 0] == 0):
                    raise AssertionError(f"K3 {what}: an empty row is not 0")
                if got.numel():
                    max_err["K3"] = max(max_err["K3"], (got - want).abs().max().item())
            print(f"K3 {what}: rows {tuple(rows.shape)} -> N={n}, largest row "
                  f"{int(counts.max()) if counts.numel() else 0} ids: CSR exact, within "
                  f"tolerance and bit for bit (f32, bf16), the same bits twice, empty rows 0")

        for label, batch in (requests[0], requests[-1], large):
            for name, rows, ids, n in k3_cases(torch, batch, gen):
                check_k3(f"{label} {name}", rows, ids, n)
        for name, rows, ids, n in zoo_kernel_cases(torch, requests[0][1], zoo_gen)["K3"]:
            check_k3(f"{requests[0][0]} {name}", rows, ids, n)
        for name, rows, ids, n in k3_edge_cases(torch, gen):
            check_k3(f"edge case {name}", rows, ids, n)
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

    train_launches = {k: eval_launches.get(k, 0) for k in launches_now()}
    label, batch = requests[0]
    on_card = batch.to("cuda")

    def train_path(tag: str, per_step: dict, n_steps: int, fused: bool = False) -> dict:
        """n_steps bf16 Adam steps (lr 1e-4) from the trained weights on the
        flagship batch: launches per step as the code gives them, the eval
        loss before and after (it must fall), step time, kernel time and
        idle share (fused: K5 fwd on its served bf16-step instance) -> those
        numbers."""
        model = load_run(RUN_DIR, device="cuda").model
        trainer = Trainer(model, TrainConfig(compute_dtype="bfloat16", optimizer="adam",
                                             lr=1e-4, seed=0), device="cuda")
        loss_before = trainer.eval_loss(on_card).item()
        reset_launches()
        steps = event_times_ms(torch, lambda: trainer.train_step(on_card), reps=n_steps,
                               warmup=0)
        torch.cuda.synchronize()
        launches = launches_now()
        want = {k: v * n_steps for k, v in per_step.items()}
        print(f"{tag}launches over {n_steps} training steps: {launches} (expected {want}: "
              f"{per_step} per step)")
        if launches != want:
            raise AssertionError(f"{tag}launch counts {launches} != expected {want}")
        for k, v in launches.items():
            train_launches[k] += v
        loss_after = trainer.eval_loss(on_card).item()
        print(f"{tag}eval-mode loss on the batch: {loss_before:.6f} before, {loss_after:.6f} "
              f"after {n_steps} bf16 Adam steps")
        if not loss_after < loss_before:
            raise AssertionError(f"{tag}the eval loss did not fall over the training steps")
        step_ms = statistics.median(steps)
        p_edges = int(batch.protein.edge_mask.sum())
        m_edges = int(batch.molecule.edge_mask.sum())
        print(f"{tag}train step {label} {batch.bucket} B={batch.protein.batch_size} bf16 Adam: "
              f"median {step_ms:.3f} ms (min {steps[0]:.3f}, max {steps[-1]:.3f}) over "
              f"{len(steps)} steps (CUDA events); protein edges/s "
              f"{p_edges / step_ms * 1e3:.1f} ({p_edges} real protein edges per batch); "
              f"protein+molecule edges/s as bench.py counts them "
              f"{(p_edges + m_edges) / step_ms * 1e3:.1f}")
        out = {"step median ms": step_ms, "kernel ms per step": None,
               "kernels per step": None, "device idle": None}
        per_kernel, n_kernels = profile_forward(torch, lambda: trainer.train_step(on_card))
        if fused:
            check_k5f_served(tag, per_kernel, "bf16 step")
        busy = sum(per_kernel.values())
        if busy == 0:
            print(f"{tag}train device time: not measured (the profiler saw no kernel)")
        else:
            print(f"{tag}train device time: {busy:.3f} ms in {n_kernels:.0f} kernels per step, "
                  f"device idle {1 - busy / step_ms:.1%} of the median step (torch.profiler)")
            k5b = {name: ms for name, ms in per_kernel.items() if "message_bwd" in name}
            if k5b:   # which K5 bwd kernel the step ran (the warp-tile one has two instances)
                print(f"{tag}K5 bwd kernels in the step: " + "; ".join(
                    f"{name.replace('(anonymous namespace)::', '').split('(')[0]} {ms:.3f} ms"
                    for name, ms in k5b.items()))
            print(f"{tag}train device time by group: " + ", ".join(
                f"{g} {ms:.3f} ms ({ms / busy:.1%})" for g, ms in kernel_groups(per_kernel).items()))
            out.update({"kernel ms per step": busy, "kernels per step": n_kernels,
                        "device idle": 1 - busy / step_ms})
        return out

    with phase("train"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # aggr 'sum': forward one K1 and one K2 per conv; backward one K2 per
        # K1 (its VJP) and one K3 per gather whose table needs a gradient:
        # every GVP conv's, and every GINE conv's after the first (the first
        # gathers the input features)
        per_step = {cs.K1: n_p + n_m, cs.K2: 2 * (n_p + n_m), cs.K3: n_p + n_m - 1,
                    cs.K7: 0, cs.K8: 0, cgm.K5F: 0, cgm.K5B: 0, cgm.K6: 0, ca.K4: 0}
        unfused_train = train_path("", per_step, TRAIN_STEPS)
        check_step_grads(torch, "", lambda dev: load_run(RUN_DIR, device=dev).model, batch)

    with phase("train-fused"):
        # each GVP conv: K6 pins the node table and K5 fwd runs the message
        # MLP; backward K5 bwd, and K6 copies the node table's cotangent back
        per_step_fused = {**per_step, cgm.K5F: n_p, cgm.K5B: n_p, cgm.K6: 2 * n_p}
        with gvp.fused_message():
            fused_train = train_path("fused ", per_step_fused, TRAIN_STEPS_FUSED, fused=True)
            check_step_grads(torch, "fused ", lambda dev: load_run(RUN_DIR, device=dev).model,
                             batch)
        print("train step, fused vs unfused message path: " + "; ".join(
            f"{k} {fused_train[k]} vs {unfused_train[k]}" for k in unfused_train))

    def graph_path(tag: str, per_step: dict, mega, lrs, fused: bool = False) -> dict:
        """bf16 Adam from the trained weights, dropout on, both trainers with
        scan_steps on and so the card's capturable optimizer: GRAPH_PASSES
        passes over the flagship megabatch one eager step at a time
        (``train_step``) and as the graph path's ``train_megabatch``
        (warm-up steps, the capture, replays). Losses, predictions and
        parameters must agree bit for bit, the eval
        graph's predictions equal ``eval_step``'s, and launches per step equal
        the eager step's. Then the replayed step and the eager store step are
        timed (CUDA events) and profiled -> their numbers."""
        cfg = dict(compute_dtype="bfloat16", optimizer="adam", lr=1e-4, seed=0)
        eager = Trainer(load_run(RUN_DIR, device="cuda").model, TrainConfig(**cfg),
                        device="cuda")
        graph = Trainer(load_run(RUN_DIR, device="cuda").model, TrainConfig(**cfg),
                        device="cuda")
        k = mega.n_steps
        for n in range(GRAPH_PASSES):
            want = [eager.train_step(mega.batch(j), float(lrs[j])) for j in range(k)]
            reset_launches()
            losses, preds = graph.train_megabatch(mega, lrs)
            torch.cuda.synchronize()
            launches = launches_now()
            expect = {name: v * k for name, v in per_step.items()}
            if launches != expect:
                raise AssertionError(f"{tag}graph path, pass {n}: launch counts {launches} != "
                                     f"expected {expect} ({per_step} per step)")
            for name, v in launches.items():
                train_launches[name] += v
            for what, got, ref in (("losses", losses, torch.stack([w[0] for w in want])),
                                   ("predictions", preds, torch.stack([w[1] for w in want]))):
                if not torch.equal(got, ref):
                    raise AssertionError(
                        f"{tag}graph path, pass {n}: {what} differ from the eager steps' by "
                        f"{((got - ref).abs() / ref.abs().clamp(min=1e-30)).max().item():.3e} "
                        "relative at most")
            print(f"{tag}graph path pass {n} ({'warm-up, capture, replays' if n == 0 else 'replays'}"
                  f"): {k} steps, losses {[round(x, 6) for x in losses.tolist()]} bit for bit "
                  f"the eager steps'; launches {launches} = {k} x the eager step's")
        captured = graph.captured_step("train", mega)
        if captured is None or captured.launches[True] != {
                name: v for name, v in per_step.items() if v}:
            raise AssertionError(f"{tag}the train step was not captured with the step's launches")
        differ = [name for (name, a), b in zip(eager.model.named_parameters(), graph.params)
                  if not torch.equal(a, b)]
        if differ:
            raise AssertionError(f"{tag}graph path: parameters differ from the eager steps': "
                                 f"{differ[:5]} ({len(differ)} of {len(graph.params)})")
        print(f"{tag}graph path: all {len(graph.params)} parameters bit for bit the eager "
              f"steps' after {GRAPH_PASSES * k} steps")
        got = graph.eval_megabatch(mega)
        want = torch.stack([eager.eval_step(mega.batch(j)) for j in range(k)])
        if not torch.equal(got, want):
            raise AssertionError(f"{tag}eval graph: predictions differ from eval_step's by "
                                 f"{(got - want).abs().max().item():.3e}")
        if graph.captured_step("eval", mega) is None:
            raise AssertionError(f"{tag}the eval forward was not captured")
        print(f"{tag}eval graph: {k} x {got.shape[1]} predictions bit for bit eval_step's")

        # the replayed step: copy of the packed row in, replay, output out
        packed = upload(graphs.pack_rows(mega.p_rows, mega.m_rows, mega.target, mega.weight,
                                         lr=lrs, div=np.ones(k, np.float32)),
                        torch.device("cuda"))
        out = torch.empty_like(captured.outs[True])
        turn = iter(range(1 << 30))

        def replay():
            out.copy_(captured.run(packed[next(turn) % k]))

        def eager_step():
            j = next(turn) % k
            eager.train_step(mega.batch(j), float(lrs[j]))

        # real protein edges a step, over the k steps the timing cycles through
        row_edges = mega.p_store.edge_mask.sum(1).cpu().numpy()
        p_edges = float(np.mean([row_edges[mega.p_rows[j]][mega.weight[j] > 0].sum()
                                 for j in range(k)]))
        result = {}
        for path, fn, reps in (("replayed", replay, GRAPH_TIMED_REPLAYS),
                               ("eager", eager_step, GRAPH_TIMED_STEPS)):
            smi = []
            with smi_samples(smi):
                steps = event_times_ms(torch, fn, reps=reps)
            step_ms = statistics.median(steps)
            print(f"{tag}{path} steps: nvidia-smi over the timed steps, " + (
                f"{len(smi)} samples: SM clock median {statistics.median(c for c, _ in smi):.0f} "
                f"MHz (min {min(c for c, _ in smi):.0f}), power draw median "
                f"{statistics.median(w for _, w in smi):.1f} W" if smi else "not measured"))
            counts = {}
            per_kernel, n_kernels = profile_forward(torch, fn, counts=counts)
            busy = sum(per_kernel.values())
            idle = 1 - busy / step_ms if busy else None
            print(f"{tag}{path} step {mega.bucket} B={mega.p_rows.shape[1]} bf16 Adam: median "
                  f"{step_ms:.3f} ms (min {steps[0]:.3f}, max {steps[-1]:.3f}) over {len(steps)} "
                  f"steps (CUDA events{' around the row copy and the replay' if path == 'replayed' else ''}); "
                  f"protein edges/s {p_edges / step_ms * 1e3:.1f} ({p_edges:.1f} real protein "
                  f"edges a step); "
                  + (f"{busy:.3f} ms of kernels in {n_kernels:.0f} kernels per step, device idle "
                     f"{idle:.1%} of the median step (torch.profiler)" if busy else
                     "kernel time not measured (the profiler saw no kernel)"))
            if busy:
                print(f"{tag}{path} step device time by group: " + ", ".join(
                    f"{g} {ms:.3f} ms ({ms / busy:.1%})"
                    for g, ms in kernel_groups(per_kernel).items()))
                top = sorted(per_kernel, key=per_kernel.get, reverse=True)[:GRAPH_TOP_KERNELS]
                print(f"{tag}{path} step, its {GRAPH_TOP_KERNELS} longest kernels (ms per step, "
                      "launches per step): " + "; ".join(
                          f"{name.replace('(anonymous namespace)::', '')[:90]} "
                          f"{per_kernel[name]:.3f} ms x {counts[name]:.0f}" for name in top))
            if fused and path == "replayed" and busy:
                check_k5f_served(f"{tag}replayed ", per_kernel, "bf16 step")
            result[path] = {"step median ms": step_ms, "kernel ms per step": busy or None,
                            "kernels per step": n_kernels, "device idle": idle,
                            "protein edges/s": p_edges / step_ms * 1e3}
        print(f"{tag}replayed vs eager store step: " + "; ".join(
            f"{name} {result['replayed'][name]} vs {result['eager'][name]}"
            for name in result["eager"]))
        return result

    with phase("train-graph"):
        # the flagship bucket filled from a store: proteins of 400-500
        # residues (512 nodes; 8 edges a residue, 4096 edges), molecules of
        # 20-64 atoms on a one-rung ladder of 64 (4 edges an atom: 256 edges);
        # three full batches of 32 and a partial one
        flagship = tuple(FLAGSHIP[x] for x in ("n_p", "e_p", "n_m", "e_m"))
        pairs = synthetic_pair_dataset(GRAPH_PAIRS, 24, 16, [(400, 500)], (20, 64), seed=1)
        store = DeviceResidentLoader(BucketedLoader(
            pairs, None, max_num=dataset_budgets("davis")[0], max_batch_size=FLAGSHIP["b"],
            seed=0, molecule_node_ladder=(FLAGSHIP["n_m"],)), device="cuda")
        (mega, _), = store.iter_megabatches()
        real = mega.weight.sum(axis=1)
        if mega.bucket != flagship or mega.n_steps < 4 or not 0 < real[-1] < FLAGSHIP["b"]:
            raise AssertionError(f"the store should fill the flagship bucket {flagship} with 3 "
                                 f"full batches and a partial one: {mega.bucket}, {real}")
        print(f"train-graph store: bucket {mega.bucket}, {mega.n_steps} batches of "
              f"{mega.p_rows.shape[1]} ({real.astype(int).tolist()} real pairs), "
              f"{mega.p_store.batch_size} proteins and {mega.m_store.batch_size} molecules "
              f"on the card")
        lrs = np.linspace(1e-4, 5e-5, mega.n_steps, dtype=np.float32)
        unfused_graph = graph_path("", per_step, mega, lrs)
        with gvp.fused_message():
            fused_graph = graph_path("fused ", per_step_fused, mega, lrs, fused=True)

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
        n_steps = 2 * len(BucketedLoader(dataset, train_idx, max_num=max_num,
                                         max_batch_size=FLAGSHIP["b"], coalesce_min_batches=2))
        fit_runs = {}
        # the default config (the store and the graph path), then batches
        # assembled on the host and eager steps
        for how, cfg in (("store + graphs (default)", {}),
                         ("per batch (scan_steps=False, device_data_budget=None)",
                          dict(scan_steps=False, device_data_budget=None))):
            reset_launches()
            with tempfile.TemporaryDirectory() as out:
                checkpoints.save_run_artifacts(
                    out, {"dataset": "synthetic", "n_pairs": FIT_PAIRS}, dataset.rescale_params(),
                    kw["protein_gnn_kwargs"], kw["molecule_gnn_kwargs"], kw["joint_gnn_kwargs"])
                model = make_joint_gnn(kw["protein_gnn_kwargs"], kw["molecule_gnn_kwargs"],
                                       generator=torch.Generator().manual_seed(0),
                                       **kw["joint_gnn_kwargs"])
                t0 = time.perf_counter()
                res = fit(model, dataset, "synthetic", out,
                          TrainConfig(n_epochs=2, compute_dtype="bfloat16", seed=0, **cfg),
                          max_num=max_num, max_batch_size=FLAGSHIP["b"], device="cuda",
                          ladder_kwargs={"coalesce_min_batches": 2})
                torch.cuda.synchronize()
                fit_s = time.perf_counter() - t0
                fit_runs[how] = (fit_s, n_steps / fit_s)
                print(f"fit {how}: 2 epochs in {fit_s:.2f} s, {n_steps} steps, "
                      f"{n_steps / fit_s:.2f} steps/s (wall clock, evaluation and checkpoints "
                      f"included), history {[(h['train'], h['val']) for h in res['history']]}, "
                      f"test {res['test_metrics']}")
                if not all(math.isfinite(h["train"]) and math.isfinite(h["val"])
                           for h in res["history"]):
                    raise AssertionError(f"fit {how}: a loss is not finite")
                for k, v in launches_now().items():
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
        print("fit wall time, store + graphs vs per batch: " + " vs ".join(
            f"{s_:.2f} s ({rate:.2f} steps/s)" for s_, rate in fit_runs.values()))
        print(f"launches over the evaluate and training phases: {train_launches}")

    with phase("cli"):
        cli_phase(torch, train_launches)

    with phase("zoo"):
        zoo_phase(torch, train_launches)
        print(f"launches over the evaluate, training and zoo phases: {train_launches}")

    with phase("times"), torch.no_grad():
        rows, module_ms, extra = {}, {}, {}

        def time_k3(label, name, r32, ids, n):
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
                rows[("K3", label, f"{name} {str(dtype)[6:]}")] = (
                    ms, plain, lib, nbytes, b * e * f, F32_OPS_PER_S)
        def time_k1(label, name, msgs, dst, mask, n):
            b, e, f = msgs.shape
            out = torch.empty(b * n, f, device="cuda")
            flat = torch.where(mask[..., None], msgs.float(), 0.0).reshape(b * e, f)
            rows_s = (dst.long() + n * torch.arange(b, device="cuda")[:, None]).reshape(-1)

            def library():
                out.zero_()
                out.index_add_(0, rows_s, flat)

            ms = graph_time_ms(torch, lambda: cs.segment_sum_sorted(msgs, dst, mask, n))
            plain = graph_time_ms(torch, lambda: cs.segment_sum_sorted_plain(msgs, dst, mask, n))
            lib = graph_time_ms(torch, library)
            # only the real edges' message rows are needed (the kernel reads
            # no masked row); dst and mask are read whole
            n_real = int(mask.sum().item())
            nbytes = (n_real * f * msgs.element_size() + dst.numel() * 4
                      + mask.numel() + b * n * f * 4)
            rows[("K1", label, name)] = (ms, plain, lib, nbytes, n_real * f, F32_OPS_PER_S)
            extra[("K1", label, name)] = f"longest dst range {longest_range(dst)}"

        def time_k8(label, p):
            b, n, e = p.batch_size, p.n_pad, p.e_pad
            msgs = torch.randn(b, e, 28, generator=gen, device="cuda")
            masked = torch.where(p.edge_mask[..., None], msgs, 0.0).contiguous()
            rows_s = (p.edge_dst.long() + n * torch.arange(b, device="cuda")[:, None]).reshape(-1)
            out = torch.empty(b * n, 28, device="cuda")

            def library():
                out.zero_()
                out.index_add_(0, rows_s, masked.reshape(b * e, 28))

            # every message row counts (no mask), dst whole, each output row once
            rows[("K8", label, "protein aggregation")] = (
                graph_time_ms(torch, lambda: cs.segment_sum_2d(masked, p.edge_dst, n)),
                graph_time_ms(torch, lambda: cs.segment_sum_2d_plain(masked, p.edge_dst, n)),
                graph_time_ms(torch, library),
                masked.numel() * 4 + b * e * 4 + b * n * 28 * 4, b * e * 28, F32_OPS_PER_S)
            extra[("K8", label, "protein aggregation")] = (
                f"longest dst range {longest_range(p.edge_dst)}")

        for label, batch in (requests[0], requests[-1]):
            cases = kernel_cases(torch, batch, gen)
            if batch is requests[0][1]:    # and at the zoo's row widths
                for k, more in zoo_kernel_cases(torch, batch, zoo_gen).items():
                    cases.setdefault(k, []).extend(more)
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
                rows[("K2", label, name)] = (ms, plain, lib, nbytes, 0, F32_OPS_PER_S)
            for name, msgs, dst, mask, n in cases["K1"]:
                time_k1(label, name, msgs, dst, mask, n)
            for name, r32, ids, n in k3_cases(torch, batch, gen) + cases.get("K3", []):
                time_k3(label, name, r32, ids, n)
            # K5 at the served model's message widths with the trained
            # weights; its reference point is the device time of the port's
            # unfused message chain (the GVP modules) on the same tensors,
            # summed over its kernels by the profiler (its backward uses
            # autograd, which a CUDA graph here does not capture)
            b, e, n = batch.protein.batch_size, batch.protein.e_pad, batch.protein.n_pad
            layers = p_convs[0].message_func
            n_w = sum(w.numel() for w in weights)
            flops = k5_flops([(w.shape[0], s.shape[0], v.shape[0]) for w, s, v in
                              zip(weights[0::6], weights[1::6], weights[3::6])], 2 * 16 + 32,
                             2 * 4 + 1)
            for kind in K5_DTYPES:
                both, es, ev, dout = k5_inputs(torch, gen, b, e, kind)
                cdt = getattr(torch, K5_DTYPES[kind][3])
                spec = cgm.MessageSpec(16, 4, acts[0], acts[1], cdt)
                rate = BF16_OPS_PER_S if cdt == torch.bfloat16 else F32_OPS_PER_S
                in_bytes = sum(t.numel() * t.element_size() for t in (both, es, ev)) + 4 * n_w
                out_bytes = b * e * 28 * both.element_size()
                req = [t.detach().requires_grad_() for t in (both, es, ev)]

                def chain(both, es, ev):
                    s_j, v_j = gvp.split_sv(both[:, :e], 4)
                    s_i, v_i = gvp.split_sv(both[:, e:], 4)
                    msg = gvp.tuple_cat((s_j, v_j), (es, ev.reshape(b, e, 1, 3)), (s_i, v_i))
                    for layer in layers:
                        msg = layer(msg)
                    return gvp.merge_sv(*msg)

                def chain_fwd():
                    with compute_dtype(cdt):
                        return chain(both, es, ev)

                def chain_bwd():
                    with torch.enable_grad(), compute_dtype(cdt):
                        return torch.autograd.grad(chain(*req), req + list(layers.parameters()),
                                                   dout)

                rows[("K5 fwd", label, kind)] = (
                    graph_time_ms(torch, lambda: cgm.message_fwd(both, es, ev, weights, spec)),
                    graph_time_ms(torch, lambda: cgm.message_fwd_plain(both, es, ev, weights,
                                                                       spec)),
                    None, in_bytes + out_bytes, b * e * flops, rate)
                module_ms[("K5 fwd", label, kind)] = ("unfused module chain", sum(
                    profile_forward(torch, chain_fwd)[0].values()))
                # K5 bwd reads both, es, ev, the weights and dout and writes
                # their gradients: 2 in_bytes + out_bytes. Each product of
                # the forward becomes two (input and weight gradient); the
                # forward that the kernel recomputes is its design's cost,
                # not the function's, so it is not in the bound
                rows[("K5 bwd", label, kind)] = (
                    graph_time_ms(torch, lambda: cgm.message_bwd(both, es, ev, weights, dout,
                                                                 spec)),
                    graph_time_ms(torch, lambda: cgm.message_bwd_plain(both, es, ev, weights,
                                                                       dout, spec)),
                    None, 2 * in_bytes + out_bytes, 2 * b * e * flops, rate)
                module_ms[("K5 bwd", label, kind)] = ("unfused module chain", sum(
                    profile_forward(torch, chain_bwd)[0].values()))
            # K6 on the node table, f32 -> f32 as the fused path pins it
            table = torch.randn(b, n, 28, generator=gen, device="cuda")
            rows[("K6", label, "node table f32")] = (
                graph_time_ms(torch, lambda: cgm.cast_copy(table, torch.float32)),
                graph_time_ms(torch, lambda: cgm.cast_copy_plain(table, torch.float32)),
                graph_time_ms(torch, lambda: table.to(torch.float32, copy=True)),
                2 * table.numel() * 4, 0, F32_OPS_PER_S)
            # K7 at the protein gathers, beside K2 on the same indices
            p = batch.protein.to("cuda")
            flat = table.reshape(b * n, 28)
            for name, idx in (("dst (sorted)", p.edge_dst), ("src", p.edge_src)):
                rows_g = (idx.long() + n * torch.arange(b, device="cuda")[:, None]).reshape(-1)
                out = torch.empty(b * e, 28, device="cuda")
                rows[("K7", label, name)] = (
                    graph_time_ms(torch, lambda: cs.gather_windowed(table, idx)),
                    graph_time_ms(torch, lambda: cs.gather_windowed_plain(table, idx)),
                    graph_time_ms(torch, lambda: torch.index_select(flat, 0, rows_g, out=out)),
                    idx.numel() * 4 + int(torch.unique(rows_g).numel()) * 28 * 4 + b * e * 28 * 4,
                    0, F32_OPS_PER_S)
                extra[("K7", label, name)] = (
                    f"K2 on the same indices "
                    f"{graph_time_ms(torch, lambda: cs.gather_rows(table, idx)):.4f} ms")
            # K8 at the protein aggregation, on masked messages
            time_k8(label, p)
        time_k3(large[0], *k3_cases(torch, large[1], gen)[0])   # its protein merged backward
        # K1 (f32 and bf16 messages) and K8 at the large protein's protein
        # aggregation, whose padding row holds ~30,000 edges a graph
        name, msgs, dst, mask, n = kernel_cases(torch, large[1], gen)["K1"][0]
        time_k1(large[0], name, msgs, dst, mask, n)
        time_k1(large[0], f"{name} bfloat16", msgs.to(torch.bfloat16), dst, mask, n)
        time_k8(large[0], large[1].protein.to("cuda"))
        # K4 at every bucket and direction; beside it the library call
        # (scaled_dot_product_attention with an additive -1e9 mask, which the
        # port never calls) and the port's dense attention core, the chain
        # of nn/attention.MultiheadAttention's dense branch with dropout off
        for label, batch in (requests[0], requests[-1], large):
            for name, q, k, v, mask in k4_cases(torch, batch, gen, heads, hd):
                additive = torch.zeros(mask.shape, device="cuda").masked_fill(
                    mask, -1e9)[:, None, None, :]
                root_hd = torch.tensor(math.sqrt(hd), dtype=q.dtype).item()

                def dense_core():
                    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / root_hd
                    logits = logits.masked_fill(mask[:, None, None, :], -1e9)
                    weights = torch.softmax(logits.to(torch.float32), dim=-1).to(v.dtype)
                    return torch.einsum("bhqk,bhkd->bhqd", weights, v)

                key = ("K4", label, name)
                nbytes, ops = k4_work(torch, q, mask)
                rows[key] = (
                    graph_time_ms(torch, lambda: ca.masked_mha(q, k, v, mask)),
                    graph_time_ms(torch, lambda: ca.masked_mha_plain(q, k, v, mask)),
                    graph_time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, attn_mask=additive)),
                    nbytes, ops, F32_OPS_PER_S)
                module_ms[key] = ("dense attention core",
                                  sum(profile_forward(torch, dense_core)[0].values()))
        for key, (ms, plain, lib, nbytes, ops, rate) in rows.items():
            k, label, name = key
            bound = max(nbytes / HBM_BYTES_PER_S, ops / rate) * 1e3
            refs = [f"library {lib:.4f} ms"] if lib is not None else []
            if key in module_ms:
                what, chain_ms = module_ms[key]
                refs.append(f"{what} {chain_ms:.4f} ms of kernels (torch.profiler)" if chain_ms
                            else f"{what} not measured (the profiler saw no kernel)")
            if key in extra:
                refs.append(extra[key])
            ref = ", ".join(refs)
            print(f"time {k} {label} {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms, {ref}, "
                  f"bound {bound:.4f} ms ({nbytes} bytes, {ops} operations), "
                  f"{bound / ms:.1%} of bound")

    # each kernel's launches over the phases that run it
    launches_over_phases = {**train_launches, **phase_launches}

    def entry(k, name, counter, replaces, shape, source=SOURCE):
        ms, plain, lib, nbytes, ops, rate = rows[(k, "flagship #0", shape)]
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = ops / rate * 1e3
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches_over_phases[counter], "max_abs_err": max_err[k],
                "ms": ms, "plain_ms": plain, "bound_ms": max(byte_ms, op_ms),
                "bound_by": "bytes" if byte_ms >= op_ms else "operations", "library_ms": lib}

    kernels = [
        entry("K1", "K1 sorted segment-sum", cs.K1, K1_REPLACES, "protein aggregation"),
        entry("K2", "K2 row gather", cs.K2, K2_REPLACES, "protein merged gather"),
        entry("K3", "K3 unsorted scatter-add", cs.K3, K3_REPLACES,
              "protein merged backward bfloat16"),
        entry("K5 fwd", "K5 fused GVP message MLP, forward", cgm.K5F, K5F_REPLACES, "f32",
              GVP_SOURCE),
        entry("K5 bwd", "K5 fused GVP message MLP, backward", cgm.K5B, K5B_REPLACES,
              "bf16 step", GVP_SOURCE),
        entry("K6", "K6 copy-cast (layout pin)", cgm.K6, K6_REPLACES, "node table f32",
              GVP_SOURCE),
        entry("K4", "K4 blockwise masked attention", ca.K4, K4_REPLACES, "residues->atoms",
              ATTN_SOURCE),
        entry("K7", "K7 windowed row gather", cs.K7, K7_REPLACES, "dst (sorted)"),
        entry("K8", "K8 row-major sorted segment-sum", cs.K8, K8_REPLACES,
              "protein aggregation"),
    ]
    # the kernels line holds K5 fwd's f32 case; the fused step runs its bf16 one
    for label in ("flagship #0", "davis"):
        ms, plain, _, nbytes, ops, rate = rows[("K5 fwd", label, "bf16 step")]
        print(f"K5 fwd {label} bf16 step (the fused training step's forward): {ms:.4f} ms, plain "
              f"{plain:.4f} ms, bound {max(nbytes / HBM_BYTES_PER_S, ops / rate) * 1e3:.4f} ms")
    if not all(k["launches"] > 0 for k in kernels):
        raise AssertionError(f"a kernel never launched over the phases that run it "
                             f"(evaluate and training for K1-K3, K5, K6; serve-blockwise and "
                             f"evaluate for K4; kernels for K7, K8): {launches_over_phases}")
    for k in kernels:
        if not all(math.isfinite(k[x]) for x in ("ms", "plain_ms", "bound_ms")) or not (
                k["library_ms"] is None or math.isfinite(k["library_ms"])):
            raise AssertionError(f"non-finite time in {k}")
    print(f"CPU references: {CPU_REFERENCES['taken']} taken, each from two runs with the "
          f"same bits; {CPU_REFERENCES['third run']} needed a third run")
    print(nvidia_smi())   # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
