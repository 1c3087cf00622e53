"""Protein-molecule pair dataset: featurize raw inputs into deduplicated graph
stores, scale the targets, report feature metadata (counterpart of
caster_dta_tpu/data/pairs.py).

Behavioral spec: reference dataset/dual_dataset.py:25-399
(ProteinMoleculeDataset). It takes the canonical six columns as records
(data/datasets.py) where the JAX package takes a DataFrame, and it is the
port's ``PairDataset`` (data/batching.py), which ``fit`` takes: the same
stores, pair index, targets, composable standardize/minmax/log scaling with
the same JSON artifact schema, and the same metadata dict.
"""
from __future__ import annotations

import multiprocessing
import os
import time
from functools import partial
from typing import Optional

import numpy as np

from caster_dta_torch.data import build
from caster_dta_torch.data.batching import PairDataset
from caster_dta_torch.native import host


class ProteinMoleculeDataset(PairDataset):
    """Dedup'd protein/molecule graph stores + pair index + scaled targets,
    featurized from ``records`` (a dict of the canonical columns).

    Proteins take the native host library (built at first use; a failed build
    raises) unless ``native_host=False`` asks for the dense numpy path, which
    gives the same graphs. ``n_workers`` featurizes in a pool of spawned
    processes as the JAX package's pool does (0: in this process)."""

    def __init__(self, records: dict, sparse_edges=False,
                 protein_dist_units="nanometers",
                 protein_edge_thresh=1.0, protein_thresh_type="dist",
                 protein_keep_selfloops=False,
                 protein_vector_features=True,
                 protein_include_esm2=False,
                 protein_include_residue_posenc=False,
                 protein_include_aa_props=True,
                 molecule_full_atomtype=False,
                 molecule_onehot_ordinal_feats=False,
                 molecule_include_selfloops=False,
                 scale_output=None,
                 n_workers: Optional[int] = None,
                 native_host: bool = True):
        self.records = records
        self.sparse_edges = sparse_edges  # kept for kwargs-schema parity
        self.protein_dist_units = protein_dist_units
        self.protein_edge_thresh = protein_edge_thresh
        self.protein_thresh_type = protein_thresh_type
        self.protein_keep_selfloops = protein_keep_selfloops
        self.protein_vector_features = protein_vector_features
        self.protein_include_esm2 = protein_include_esm2
        self.protein_include_residue_posenc = protein_include_residue_posenc
        self.protein_include_aa_props = protein_include_aa_props
        self.molecule_full_atomtype = molecule_full_atomtype
        self.molecule_onehot_ordinal_feats = molecule_onehot_ordinal_feats
        self.molecule_include_selfloops = molecule_include_selfloops

        mol_fn = partial(build.molecule_smiles_to_graph,
                         molecule_full_atomtype=molecule_full_atomtype,
                         molecule_onehot_ordinal_feats=molecule_onehot_ordinal_feats,
                         molecule_include_selfloops=molecule_include_selfloops)
        prot_fn = partial(build.protein_file_to_graph,
                          dist_units=protein_dist_units,
                          edge_thresh=protein_edge_thresh,
                          thresh_type=protein_thresh_type,
                          keep_self_loops=protein_keep_selfloops,
                          vectorize_features=protein_vector_features,
                          add_esm2_embeds=protein_include_esm2,
                          add_residue_posenc=protein_include_residue_posenc,
                          include_aa_props=protein_include_aa_props,
                          native=native_host)
        if native_host:
            host.load_library()   # built once here, not in each worker

        t0 = time.perf_counter()
        mols = dict.fromkeys(zip(records["molecule_id"], records["molecule_smiles"]))
        prots = dict.fromkeys(zip(records["protein_id"], records["protein_sequence"],
                                  records["protein_file"]))
        molecule_data = dict(zip((m for m, _ in mols),
                                 _parallel_map(mol_fn, [s for _, s in mols], n_workers)))
        protein_data = dict(zip((p for p, _, _ in prots),
                                _parallel_map(prot_fn, [f for _, _, f in prots], n_workers)))
        self.featurize_seconds = time.perf_counter() - t0
        self.n_graphs = len(mols) + len(prots)

        # sorted stores for run-to-run consistency (dual_dataset.py:352-353,391-392)
        super().__init__({k: protein_data[k] for k in sorted(protein_data)},
                         {k: molecule_data[k] for k in sorted(molecule_data)},
                         list(zip(records["protein_id"], records["molecule_id"])),
                         records["affinity_score"],
                         scale_output=[scale_output] if isinstance(scale_output, str)
                         else scale_output)
        if "split" in records:
            self.split = list(records["split"])
        self.idx_protein_strat = np.unique(records["protein_id"], return_inverse=True)[1]
        self.idx_molecule_strat = np.unique(records["molecule_id"], return_inverse=True)[1]

    def __str__(self):
        md = self.metadata_dict
        aff = self.affinity_data
        return (
            "ProteinMoleculeDataset:\n"
            f"\t{len(self)} protein-molecule pairs and targets\n"
            f"\t{len(self.protein_data)} unique proteins\n"
            f"\t{len(self.molecule_data)} unique molecules\n"
            f"\tProtein edge threshold (type): {self.protein_edge_thresh} "
            f"({self.protein_thresh_type})\n"
            f"\tFeature metadata: {md}\n"
            f"\ttarget rescaling: {self.scale_output}; "
            f"min {aff.min():.4f} max {aff.max():.4f} "
            f"mean {aff.mean():.4f} std {aff.std(ddof=1):.4f}\n")

    def _report_scale_data(self) -> dict:
        """The reference's dataset_rescale_params.json schema
        (dual_dataset.py:219-243)."""
        return {"scale_output": self.scale_output,
                **{kind: dict(self._factors.get(kind, {})) for kind in self.scale_output}}

    def _load_scale_data_from_dict(self, scale_data_dict: dict) -> None:
        """Adopt another run's scaling factors (unscale_target then undoes
        that run's scaling)."""
        self.scale_output = scale_data_dict["scale_output"]
        self._factors = {kind: {k: float(v) for k, v in scale_data_dict[kind].items()}
                         for kind in self.scale_output
                         if kind in ("standardize", "minmax")}


def _parallel_map(fn, items, n_workers):
    """``[fn(x) for x in items]``, in a pool of spawned processes (the parent
    may hold a CUDA context, which forked children must not inherit) for 8 or
    more items unless ``n_workers`` is 0. None takes the CPUs this process
    may use, at most one worker per chunk of 8 items."""
    if n_workers == 0 or len(items) < 8:
        return [fn(x) for x in items]
    if n_workers is None:
        n_workers = min(len(os.sched_getaffinity(0)), -(-len(items) // 8))
    with multiprocessing.get_context("spawn").Pool(n_workers) as pool:
        return list(pool.imap(fn, items, chunksize=8))
