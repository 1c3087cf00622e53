"""Result statistics and drawings for the three downstream tasks
(counterpart of caster_dta_tpu/analysis/visualize.py).

Behavioral spec: reference visualize_biolip_results.py (binding vs
non-binding attention paired t-tests + histograms + length scatterplots),
visualize_variation_results.py (ref/alt/diff structure grids + molecule
attention drawings per variant-drug pair), visualize_binder_results.py
(percentile filtering of screen scores + per-protein top-drug drawings).
Each function takes the records its task returns. Statistics come before
any drawing and need no matplotlib: with ``draw=False`` a function computes
and writes what it would without the figures; a call that draws needs
matplotlib (inference/visualization.pyplot).
"""
from __future__ import annotations

import os

import numpy as np
from scipy import stats

from caster_dta_torch.data import tables
from caster_dta_torch.inference import visualization as viz


def _column(values: list) -> np.ndarray:
    """A column of per-row numbers as pandas types it: float32 when every
    value is a float32 scalar, else float64."""
    if values and all(isinstance(v, np.float32) for v in values):
        return np.asarray(values, dtype=np.float32)
    return np.asarray(values, dtype=np.float64)


def biolip_statistics(results_df: dict, base_score: str = "attention") -> dict:
    """Per pair with an annotated binding residue inside its attention
    profile: the mean ``protein_<base_score>`` over binding and over
    non-binding residues, raw and log-scaled (log10 of the score times the
    protein length); -> {"rows": the kept rows, "mean_bind", "mean_nonbind",
    "mean_bind_scaled", "mean_nonbind_scaled": arrays, "ttest",
    "ttest_scaled": {"t", "p"} of scipy's paired t-test}
    (reference visualize_biolip_results.py:40-156)."""
    keep, cols = [], {k: [] for k in ("mean_bind", "mean_nonbind", "mean_bind_scaled",
                                      "mean_nonbind_scaled")}
    for i, (res, attn, seq) in enumerate(zip(results_df["binding_residues"],
                                             results_df[f"protein_{base_score}"],
                                             results_df["protein_sequence"])):
        pos = [int(y[1:]) for y in res.split(" ") if y != ""]
        bind = np.array([attn[j - 1] for j in pos if 0 < j <= len(attn)])
        posset = set(pos)
        nonbind = np.array([attn[j - 1] for j in range(1, len(attn) + 1) if j not in posset])
        if len(bind) == 0:
            continue
        keep.append(i)
        cols["mean_bind"].append(np.mean(bind))
        cols["mean_nonbind"].append(np.mean(nonbind))
        cols["mean_bind_scaled"].append(np.mean(np.log10(bind * len(seq) + 1e-30)))
        cols["mean_nonbind_scaled"].append(np.mean(np.log10(nonbind * len(seq) + 1e-30)))
    out = {"rows": keep, **{k: _column(v) for k, v in cols.items()}}
    for suffix, a, b in (("", "mean_bind", "mean_nonbind"),
                         ("_scaled", "mean_bind_scaled", "mean_nonbind_scaled")):
        t, p = stats.ttest_rel(out[a], out[b])
        out[f"ttest{suffix}"] = {"t": float(t), "p": float(p)}
    return out


def visualize_biolip_results(results_df: dict, output_dir: str,
                             base_score: str = "attention", num_bins: int = 41,
                             draw: bool = True) -> dict:
    """Binding-site recovery t-tests (``biolip_statistics``), and with
    ``draw`` the difference histograms and length scatterplots under
    ``output_dir/base_score``. -> {"ttest": {"t", "p"}, "ttest_scaled": ...}."""
    st = biolip_statistics(results_df, base_score)
    out = {k: st[k] for k in ("ttest", "ttest_scaled")}
    if not draw:
        return out
    plt = viz.pyplot()
    output_dir = os.path.join(output_dir, base_score)
    os.makedirs(output_dir, exist_ok=True)
    plen = [len(results_df["protein_sequence"][i]) for i in st["rows"]]
    for suffix, a, b in (("", "mean_bind", "mean_nonbind"),
                         ("_scaled", "mean_bind_scaled", "mean_nonbind_scaled")):
        t, p = out[f"ttest{suffix}"]["t"], out[f"ttest{suffix}"]["p"]
        diff = st[a] - st[b]
        absmax = abs(diff.max()) if len(diff) else 1.0
        fig, ax = plt.subplots()
        ax.hist(diff, bins=np.linspace(-absmax, absmax, num_bins))
        ax.axvline(diff.mean(), color="k", linestyle="dashed", linewidth=1.2)
        ax.text(0.7, 0.9, f"Paired t-test\nt = {t:.4f}\np = {p:.3e}",
                ha="left", va="top", transform=ax.transAxes)
        ax.set_xlabel("Difference")
        ax.set_ylabel("Frequency")
        ax.set_title("Difference in Average Attention (Binding - Nonbinding)")
        fig.savefig(os.path.join(
            output_dir, f"diff_binding_nonbinding_residue_{base_score}{suffix}_hist.png"),
            dpi=300)
        plt.close(fig)

        fig, ax = plt.subplots()
        ax.scatter(plen, diff, alpha=0.5, s=5)
        ax.set_xlabel("Protein Length")
        ax.set_ylabel("Difference (Binding - Nonbinding)")
        fig.savefig(os.path.join(
            output_dir,
            f"diff_binding_nonbinding_residue_{base_score}{suffix}_vs_protein_length.png"),
            dpi=300)
        plt.close(fig)
    return out


def visualize_variation_results(delta_df: dict, output_dir: str,
                                attn_type: str = "attention",
                                max_pairs: int | None = None, draw: bool = True) -> list:
    """Ref/alt/diff grids + molecule attention drawings per variant-drug pair
    (reference visualize_variation_results.py). -> [(structures png,
    molecule png)] per row; with ``draw=False`` the paths are named and
    nothing is written."""
    n = tables.n_rows(delta_df)
    rows = range(n if max_pairs is None else min(n, max_pairs))
    outputs = []
    if draw:
        viz.pyplot()
        os.makedirs(output_dir, exist_ok=True)
    for i in rows:
        tag = f"{delta_df['variant_id'][i]}__{delta_df['molecule_id'][i]}"
        grid = os.path.join(output_dir, f"{tag}_structures.png")
        mol_png = os.path.join(output_dir, f"{tag}_molecule.png")
        if draw:
            viz.draw_protein_difference(
                delta_df["ref_file"][i], delta_df["alt_file"][i],
                delta_df[f"ref_prot_{attn_type}"][i], delta_df[f"alt_prot_{attn_type}"][i],
                grid)
            viz.draw_mol_with_attn(delta_df["molecule_smiles"][i],
                                   delta_df[f"alt_mol_{attn_type}"][i], mol_png)
        outputs.append((grid, mol_png))
    return outputs


def visualize_binder_results(results_df: dict, output_dir: str,
                             percentile: float = 99.0, draw_top: int = 3,
                             draw: bool = True):
    """The pairs at or above the ``percentile`` of the screen's scores,
    written as ``top_percentile_binders.csv`` (the JAX package's columns and
    cells), and with ``draw`` the score histogram and the ``draw_top`` best
    pairs' molecule drawings (reference visualize_binder_results.py:64-82).
    -> (those records, the drawings' paths)."""
    os.makedirs(output_dir, exist_ok=True)
    scores = results_df["affinity_score"]
    thresh = np.percentile(scores, percentile)
    top_df = tables.where(results_df, [s >= thresh for s in scores])
    tables.write_csv(top_df, os.path.join(output_dir, "top_percentile_binders.csv"))
    if not draw:
        return top_df, []

    plt = viz.pyplot()
    fig, ax = plt.subplots()
    ax.hist(scores, bins=50)
    ax.axvline(thresh, color="r", linestyle="dashed", label=f"{percentile}th percentile")
    ax.set_xlabel("Predicted affinity")
    ax.set_ylabel("Count")
    ax.legend()
    fig.savefig(os.path.join(output_dir, "affinity_histogram.png"), dpi=300)
    plt.close(fig)

    drawn = []
    best = tables.sort_by(tables.dropna(top_df, "affinity_score"), "affinity_score",
                          ascending=False)
    for i in range(min(draw_top, tables.n_rows(best))):
        if best.get("molecule_attention") is None or best["molecule_attention"][i] is None:
            continue
        png = os.path.join(output_dir, f"{best['protein_id'][i]}__{best['molecule_id'][i]}.png")
        viz.draw_mol_with_attn(best["molecule_smiles"][i], best["molecule_attention"][i], png)
        drawn.append(png)
    return top_df, drawn
