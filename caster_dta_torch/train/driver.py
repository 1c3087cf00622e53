"""Training CLI (counterpart of caster_dta_tpu/train/driver.py).

    python -m caster_dta_torch.train.driver --dataset synthetic --out-folder F

Behavioral spec: reference train_model.py (the 829-line script): the same
flags (--dataset --seed --out-folder --checkpoint --use-best
--skip-training), the same artifacts, the same defaults (CASTER-DTA(2,2):
lbamodel+gine, Adam 1e-4, plateau 0.8/50, early stop 200, standardize
targets, 4 Å distance edges with self-loops, bf16 matmuls), from raw PDB files
and SMILES to test metrics. Runs on the card unless ``--device cpu``.

Beside the JAX package's artifacts a run writes ``train_history.json`` (the
per-epoch history) and ``test_metrics.json``; ``main`` returns ``fit``'s
result with the dataset under ``"dataset"``. The port adds ``--device`` and
the synthetic set's sizes (``--synthetic-pairs``, ``--synthetic-proteins``,
``--synthetic-molecules``).

Multi-device training (parallel/), one process per device: ``--n-dp`` splits
every batch over that many ranks, ``--gp`` trains proteins larger than the
bucket ladder edge-partitioned over that many (``n_dp x gp`` ranks in all).
With ``--coordinator`` (``host:port`` or a ``tcp://``/``file://`` URL),
``--n-processes`` and ``--process-id`` this process joins that group as one
rank (the multi-host form). Without them and with more than one rank, the CLI featurizes
once and starts the ranks itself on this host, rank r on ``cuda:(r mod
cards)``; a failing rank fails the run. Rank 0 alone writes the run's files,
the same files a single-process run writes.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

from caster_dta_torch.data.batching import BucketedLoader, dataset_budgets
from caster_dta_torch.data.datasets import load_dataset
from caster_dta_torch.data.pairs import ProteinMoleculeDataset
from caster_dta_torch.device import pin_mkl_code_path
from caster_dta_torch.inference.checkpoint import (build_model, load_model_from_checkpoint,
                                                   content_hash)
from caster_dta_torch.train import checkpoints
from caster_dta_torch.train import metrics as metrics_mod
from caster_dta_torch.train.loop import Trainer, TrainConfig, fit, split_dataset

DEFAULT_DATASET_KWARGS = dict(
    sparse_edges=False,
    protein_dist_units="angstroms",
    protein_edge_thresh=4,
    protein_thresh_type="dist",
    protein_keep_selfloops=True,
    protein_vector_features=True,
    protein_include_esm2=False,
    protein_include_residue_posenc=False,
    protein_include_aa_props=True,
    molecule_full_atomtype=False,
    molecule_onehot_ordinal_feats=False,
    molecule_include_selfloops=True,
    scale_output=["standardize"],
)
# the dataset cache's file prefix: the JAX package's caches are
# 00_datasetobj__*.pkl, and neither package loads the other's
CACHE_PREFIX = "00_datasetobj_torch__"
_GROUP_FLAGS = ("coordinator", "n_processes", "process_id")


def default_model_kwargs(metadata: dict):
    """The trained CASTER-DTA(2,2) config (reference train_model.py:276-331)."""
    protein_gnn_kwargs = dict(
        base_conv="lbamodel",
        in_channels=metadata["protein_node_features"],
        edge_dim=metadata["protein_edge_features"],
        num_ntypes=metadata["protein_node_types"],
        num_etypes=metadata["protein_edge_types"],
        ntype_emb_dim=None, etype_emb_dim=None,
        num_convs=2, hidden_channels=(16, 4), edge_hidden_channels=(32, 1),
        out_channels=64, dropout_rate=0.2, activation="leaky_relu", aggr="sum")
    molecule_gnn_kwargs = dict(
        base_conv="gine",
        in_channels=metadata["molecule_node_features"],
        edge_dim=metadata["molecule_edge_features"],
        num_ntypes=metadata["molecule_node_types"],
        num_etypes=metadata["molecule_edge_types"],
        ntype_emb_dim=None, etype_emb_dim=None,
        num_convs=2, hidden_channels=16, out_channels=64, dropout_rate=0.2,
        activation="leaky_relu", aggr="sum", gin_trainable_eps=True)
    joint_gnn_kwargs = dict(
        residue_lin_depth=1, atom_lin_depth=1, n_attention_heads=8,
        attention_dropout=0.0, protein_lin_depth=1, molecule_lin_depth=1,
        pairwise_embedding_dim=512, out_lin_depth=1, out_lin_factor=0.5,
        out_lin_norm_type=None, activation="leaky_relu", dropout=0.1,
        element_pooling="mean", include_residual_stream=True,
        residual_dim_ff_scale=2, num_cross_attn_layers=1,
        include_post_pool_layernorm=False)
    return protein_gnn_kwargs, molecule_gnn_kwargs, joint_gnn_kwargs


def generate_missing_structures(records: dict, structures_dir: str) -> dict:
    """Write placeholder helix-backbone PDBs for proteins lacking a structure
    file and point protein_file at them.

    Offline stand-in for the acquisition layer (data/acquire.py, not ported):
    geometry is synthetic, but sequences/ligands/affinities are the real
    dataset, so the full pipeline (featurize -> bucket -> train) runs
    end-to-end."""
    from caster_dta_torch.data.synthetic import helix_backbone, write_pdb

    os.makedirs(structures_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    files = {}
    for pid, seq in dict.fromkeys(zip(records["protein_id"], records["protein_sequence"])):
        path = os.path.join(structures_dir, f"{pid}.pdb")
        if not os.path.exists(path):
            write_pdb(path, helix_backbone(len(seq), rng), seq)
        files[pid] = path
    return {**records, "protein_file": [files[p] for p in records["protein_id"]]}


def build_or_load_dataset(records: dict, cache_dir: str, dataset_kwargs: dict,
                          n_workers=None) -> ProteinMoleculeDataset:
    """Dataset build with hash-keyed caching (train_model.py:132-149): the
    pickle is keyed by a sha256 of the records and one of the kwargs."""
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"{CACHE_PREFIX}{content_hash(records)}_"
                                   f"{content_hash(dataset_kwargs)}.pkl")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    ds = ProteinMoleculeDataset(records, n_workers=n_workers, **dataset_kwargs)
    with open(path, "wb") as f:
        pickle.dump(ds, f)
    return ds


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train the joint GNN model on a dataset (PyTorch/CUDA port)")
    p.add_argument("--dataset", type=str, default="davis")
    p.add_argument("--out-folder", type=str, default="output")
    p.add_argument("--seed", type=int, default=9)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--use-best", type=str, default="val",
                   choices=["val", "train", "final"])
    p.add_argument("--skip-training", action="store_true")
    p.add_argument("--data-root", type=str, default="./data")
    p.add_argument("--structures-dir", type=str, default=None,
                   help="directory of pre-downloaded {protein_id}.pdb files")
    p.add_argument("--n-epochs", type=int, default=2000)
    p.add_argument("--protein-convs", type=int, default=2,
                   help="GVPConvLayer count in the protein tower")
    p.add_argument("--molecule-convs", type=int, default=2,
                   help="conv count in the molecule tower")
    p.add_argument("--n-workers", type=int, default=None,
                   help="featurization worker processes (0: none)")
    p.add_argument("--resume", action="store_true",
                   help="resume an interrupted run from the out-folder's "
                        "train_state.msgpack (parameters, optimizer, scheduler, "
                        "dropout generator; bit-identical continuation)")
    p.add_argument("--synthetic-structures", action="store_true",
                   help="generate placeholder helix-backbone PDBs for "
                        "proteins without a structure file")
    p.add_argument("--synthetic-pairs", type=int, default=None,
                   help="--dataset synthetic: pairs drawn (data/synthetic.py; default 24)")
    p.add_argument("--synthetic-proteins", type=int, default=None,
                   help="--dataset synthetic: proteins (default 4)")
    p.add_argument("--synthetic-molecules", type=int, default=None,
                   help="--dataset synthetic: molecules (default 8)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where the model trains: the card unless asked for the CPU")
    p.add_argument("--n-dp", type=int, default=None,
                   help="data parallelism: split every batch over this many ranks, one "
                        "process per device (parameters replicated, gradients all-reduced)")
    p.add_argument("--gp", type=int, default=None,
                   help="graph partitioning: proteins larger than the bucket ladder train "
                        "edge-partitioned over this many ranks with a halo exchange per "
                        "layer (parallel/partition.py) instead of raising. Ranks = n_dp * gp")
    p.add_argument("--coordinator", type=str, default=None,
                   help="join a process group: its address (host:port, or a tcp:// or "
                        "file:// URL); with --n-processes and --process-id. Without the "
                        "three and with more than one rank the CLI starts the ranks itself")
    p.add_argument("--n-processes", type=int, default=None,
                   help="the process group's size (n_dp * gp)")
    p.add_argument("--process-id", type=int, default=None, help="this process's rank")
    return p


def _check_multi_device(args) -> int:
    """The ranks the flags ask for; SystemExit, before any work, on flags
    that do not fit together."""
    for name in ("n_dp", "gp", "n_processes"):
        value = getattr(args, name)
        if value is not None and value < 1:
            raise SystemExit(f"--{name.replace('_', '-')} must be at least 1, not {value}")
    n_ranks = (args.n_dp or 1) * (args.gp or 1)
    given = [k for k in _GROUP_FLAGS if getattr(args, k) is not None]
    if given:
        missing = [f"--{k.replace('_', '-')}" for k in _GROUP_FLAGS if k not in given]
        if missing:
            raise SystemExit(f"joining a process group needs {', '.join(missing)}")
        if args.n_processes != n_ranks:
            raise SystemExit(f"the process group has {args.n_processes} processes; --n-dp x "
                             f"--gp asks for {n_ranks}")
    if (args.gp or 1) > 1:
        # the partitioned tower is lbamodel's; a resumed or fine-tuned run
        # names its own tower in model_kwargs.json
        src = None
        if args.resume:
            src = os.path.join(args.out_folder, "model_kwargs.json")
        elif args.checkpoint is not None:
            d = args.checkpoint if os.path.isdir(args.checkpoint) else os.path.dirname(
                args.checkpoint)
            src = os.path.join(d, "model_kwargs.json")
        if src is not None and os.path.exists(src):
            with open(src) as f:
                bc = json.load(f)["protein_gnn_kwargs"].get("base_conv", "lbamodel")
            if bc != "lbamodel":
                raise SystemExit(f"--gp: the partitioned protein tower supports "
                                 f"base_conv='lbamodel' only (this run's model_kwargs.json "
                                 f"has base_conv={bc!r}); train without --gp or switch the "
                                 f"protein tower")
    return n_ranks


def launch_local_ranks(argv: list, n_ranks: int) -> None:
    """Run this CLI as ``n_ranks`` processes on this host, joined by a
    ``file://`` group in a fresh temporary directory; wait for all of them.
    When one fails the others are stopped and RuntimeError names it."""
    with tempfile.TemporaryDirectory(prefix="caster_dta_group_") as tmp:
        group = f"file://{os.path.join(tmp, 'group')}"
        env = dict(os.environ, LOCAL_WORLD_SIZE=str(n_ranks))
        # the ranks share this host's cores
        env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // n_ranks)))
        procs = [subprocess.Popen([sys.executable, "-m", "caster_dta_torch.train.driver", *argv,
                                   "--coordinator", group, "--n-processes", str(n_ranks),
                                   "--process-id", str(r)], env=env)
                 for r in range(n_ranks)]
        try:
            while True:
                codes = [p.poll() for p in procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed:
                    raise RuntimeError(f"rank {failed[0]} of {n_ranks} exited with code "
                                       f"{codes[failed[0]]}")
                if all(c == 0 for c in codes):
                    return
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            for p in procs:
                p.wait()


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser().parse_args(argv)
    n_ranks = _check_multi_device(args)
    joined = any(getattr(args, k) is not None for k in _GROUP_FLAGS)
    rank = 0
    if joined:
        from caster_dta_torch.parallel.mesh import init_distributed

        import torch.distributed as dist

        init_distributed(args.coordinator, args.n_processes, args.process_id,
                         device=args.device)
        rank = dist.get_rank()
    writer = rank == 0

    if writer:
        os.makedirs(args.out_folder, exist_ok=True)
        print(f"Using dataset: {args.dataset}\nUsing seed: {args.seed}\n"
              f"Output folder: {args.out_folder}", flush=True)

    sizes = {}
    if args.dataset.lower() == "synthetic":
        sizes = {k: v for k, v in (("n_pairs", args.synthetic_pairs),
                                   ("n_proteins", args.synthetic_proteins),
                                   ("n_molecules", args.synthetic_molecules)) if v is not None}
    if args.synthetic_structures:
        if not args.structures_dir:
            raise SystemExit("--synthetic-structures requires --structures-dir")
        # load without the missing-structure drop, then synthesize backbones
        records = load_dataset(args.dataset, data_root=args.data_root, structures_dir=None,
                               **sizes)
        records = generate_missing_structures(records, args.structures_dir)
    else:
        records = load_dataset(args.dataset, data_root=args.data_root,
                               structures_dir=args.structures_dir, **sizes)
    dataset_kwargs = dict(DEFAULT_DATASET_KWARGS)
    cache_dir = args.structures_dir or os.path.join(args.data_root, "cache")
    if joined and not writer:
        import torch.distributed as dist

        dist.barrier()      # rank 0 featurizes into the cache first
    dataset = build_or_load_dataset(records, cache_dir, dataset_kwargs,
                                    n_workers=args.n_workers)
    if joined and writer:
        import torch.distributed as dist

        dist.barrier()
    if writer:
        print(dataset, flush=True)
    if not joined and n_ranks > 1 and not args.skip_training:
        launch_local_ranks(argv, n_ranks)
        with open(os.path.join(args.out_folder, "train_history.json")) as f:
            history = json.load(f)
        with open(os.path.join(args.out_folder, "test_metrics.json")) as f:
            test_metrics = json.load(f)
        return {"history": history, "test_metrics": test_metrics, "dataset": dataset}

    saved_kwargs_path = os.path.join(args.out_folder, "model_kwargs.json")
    initial_params = None
    if args.resume and os.path.exists(saved_kwargs_path):
        # resume rebuilds the model from the run's own saved kwargs, not the
        # CLI flags: resuming a --protein-convs 3 run without re-passing the
        # flag must not silently reconfigure (or clobber) the run
        with open(saved_kwargs_path) as f:
            saved = json.load(f)
        pk, mk, jk = (saved["protein_gnn_kwargs"], saved["molecule_gnn_kwargs"],
                      saved["joint_gnn_kwargs"])
    elif args.checkpoint is not None and not args.skip_training:
        # the reference's --checkpoint workflow (train_model.py:23-32,
        # 520-525 + inference_utils.py:40-70): rebuild the model from the
        # checkpoint's kwargs and fine-tune from its params. A file path pins
        # that checkpoint; only the folder's model_kwargs.json is read beside it
        if os.path.isdir(args.checkpoint):
            ckpt_dir, param_file = args.checkpoint, None
        else:
            ckpt_dir, param_file = os.path.dirname(args.checkpoint), args.checkpoint
        _, initial_params, ck = load_model_from_checkpoint(
            ckpt_dir, args.use_best, param_file=param_file, device="cpu")
        pk, mk, jk = (ck["protein_gnn_kwargs"], ck["molecule_gnn_kwargs"],
                      ck["joint_gnn_kwargs"])
    else:
        pk, mk, jk = default_model_kwargs(dataset.metadata_dict)
        pk["num_convs"] = args.protein_convs
        mk["num_convs"] = args.molecule_convs
    if writer and not (args.resume and os.path.exists(saved_kwargs_path)):
        checkpoints.save_run_artifacts(args.out_folder, dataset_kwargs,
                                       dataset._report_scale_data(), pk, mk, jk)

    max_num, max_bsize = dataset_budgets(args.dataset)
    # bf16 matmuls = the reference's AMP-on default (train_model.py:478)
    cfg = TrainConfig(n_epochs=args.n_epochs, seed=args.seed, resume=args.resume,
                      compute_dtype="bfloat16", n_dp=args.n_dp, gp=args.gp)

    if args.skip_training:
        model, params, _ = load_model_from_checkpoint(
            args.checkpoint or args.out_folder, args.use_best, device=args.device)
        _, _, test_idx = split_dataset(dataset, args.seed)
        test_dl = BucketedLoader(dataset, test_idx, max_num=max_num,
                                 max_batch_size=max_bsize, shuffle=False)
        trainer = Trainer(model, cfg, device=args.device)
        _, pred, target, _ = trainer.eval_epoch(test_dl, unscale=dataset.unscale_target)
        report = metrics_mod.regression_report(pred, target)
        print(json.dumps(report, indent=2), flush=True)
        return report

    model = build_model({"protein_gnn_kwargs": pk, "molecule_gnn_kwargs": mk,
                         "joint_gnn_kwargs": jk})
    result = fit(model, dataset, args.dataset, args.out_folder, cfg,
                 max_num=max_num, max_batch_size=max_bsize,
                 initial_params=initial_params, device=args.device, verbose=writer)
    if writer:
        with open(os.path.join(args.out_folder, "train_history.json"), "w") as f:
            json.dump(result["history"], f, indent=4)
        with open(os.path.join(args.out_folder, "test_metrics.json"), "w") as f:
            json.dump(result["test_metrics"], f, indent=4)
        print("Test metrics:", json.dumps(result["test_metrics"], indent=2), flush=True)
    if joined:
        import torch.distributed as dist

        dist.destroy_process_group()
    return {**result, "dataset": dataset}


if __name__ == "__main__":
    pin_mkl_code_path()
    main()
