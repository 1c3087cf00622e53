"""Attention/explanation drawings (counterpart of caster_dta_tpu/inference/
visualization.py).

Behavioral spec: reference inference/visualization_utils.py: 2D molecule
drawings with per-atom attention, protein renders colored by per-residue
attention, and ref/alt/difference grids. RDKit drawing and headless PyMOL are
optional backends, used when importable (neither is a dependency); otherwise
matplotlib draws: the molecule on a Kamada-Kawai layout of its bond graph
(``_mol_layout``, networkx's algorithm step for step, without networkx), the
protein as a 3D CA trace. matplotlib is imported only inside the drawing
functions; a drawing call without it raises ImportError naming it.
"""
from __future__ import annotations

import numpy as np
import scipy.optimize


def pyplot():
    """matplotlib.pyplot on the Agg backend; ImportError naming matplotlib
    when it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("drawing needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _hop_distances(n: int, edges) -> np.ndarray:
    """Shortest path lengths in edges between all nodes (breadth first),
    1e6 between nodes that no path joins."""
    adj = [[] for _ in range(n)]
    for a, b in edges:
        adj[a].append(b)
        adj[b].append(a)
    dist = np.full((n, n), 1e6)
    for s in range(n):
        dist[s, s] = 0
        frontier, d = [s], 0
        while frontier:
            d += 1
            nxt = []
            for u in frontier:
                for v in adj[u]:
                    if dist[s, v] == 1e6:
                        dist[s, v] = d
                        nxt.append(v)
            frontier = nxt
    return dist


def _rescale(pos: np.ndarray) -> np.ndarray:
    """Centered, the largest coordinate magnitude scaled to 1
    (networkx's rescale_layout)."""
    pos -= pos.mean(axis=0)
    lim = np.abs(pos).max()
    if lim > 0:
        pos *= 1 / lim
    return pos


def _kk_cost(pos_vec, invdist, meanweight, dim):
    """Kamada-Kawai cost and gradient (networkx's _kamada_kawai_costfn)."""
    n = invdist.shape[0]
    pos_arr = pos_vec.reshape((n, dim))
    delta = pos_arr[:, np.newaxis, :] - pos_arr[np.newaxis, :, :]
    nodesep = np.linalg.norm(delta, axis=-1)
    direction = np.einsum("ijk,ij->ijk", delta, 1 / (nodesep + np.eye(n) * 1e-3))
    offset = nodesep * invdist - 1.0
    offset[np.diag_indices(n)] = 0
    cost = 0.5 * np.sum(offset ** 2)
    grad = (np.einsum("ij,ij,ijk->ik", invdist, offset, direction)
            - np.einsum("ij,ij,ijk->jk", invdist, offset, direction))
    sumpos = np.sum(pos_arr, axis=0)
    cost += 0.5 * meanweight * np.sum(sumpos ** 2)
    grad += meanweight * sumpos
    return cost, grad.ravel()


def _mol_layout(mol):
    """2D atom coordinates: networkx's ``kamada_kawai_layout`` of the bond
    graph (circular start, L-BFGS-B on the same cost), atoms on a line when
    there is no bond."""
    n = mol.GetNumAtoms()
    edges = [(b.a1, b.a2) for b in mol.bonds]
    if not edges:
        return np.asarray([(i, 0.0) for i in range(n)])
    theta = (np.linspace(0, 1, n + 1)[:-1] * 2 * np.pi).astype(np.float32)
    start = _rescale(np.column_stack([np.cos(theta), np.sin(theta), np.zeros((n, 0))]))
    start = start + np.zeros(2)
    dist = _hop_distances(n, edges)
    res = scipy.optimize.minimize(_kk_cost, start.ravel(), method="L-BFGS-B",
                                  args=(1 / (dist + np.eye(n) * 1e-3), 1e-3, 2), jac=True)
    return _rescale(res.x.reshape((-1, 2))) + np.zeros(2)


def draw_mol_with_attn(smiles: str, attn_weights, out_file: str, cmap: str = "Reds"):
    """2D molecule drawing with per-atom attention
    (reference visualization_utils.py:10-23)."""
    attn = np.asarray(attn_weights, dtype=float)
    attn = attn / max(attn.max(), 1e-12)
    try:
        from rdkit import Chem
        from rdkit.Chem.Draw import rdMolDraw2D
        mol = Chem.MolFromSmiles(smiles)
        d = rdMolDraw2D.MolDraw2DCairo(600, 600)
        colors = {i: (1.0, 1.0 - a, 1.0 - a, 0.6) for i, a in enumerate(attn)}
        rdMolDraw2D.PrepareAndDrawMolecule(
            d, mol, highlightAtoms=list(range(len(attn))),
            highlightAtomColors={i: c[:3] for i, c in colors.items()})
        d.FinishDrawing()
        with open(out_file, "wb") as f:
            f.write(d.GetDrawingText())
        return out_file
    except ImportError:
        pass

    plt = pyplot()
    from caster_dta_torch.data.featurize.chem import mol_from_smiles

    mol = mol_from_smiles(smiles)
    pos = _mol_layout(mol)
    fig, ax = plt.subplots(figsize=(6, 6))
    for b in mol.bonds:
        p, q = pos[b.a1], pos[b.a2]
        lw = {"SINGLE": 1.5, "DOUBLE": 3.0, "TRIPLE": 4.0, "AROMATIC": 2.5}.get(
            b.bond_type, 1.5)
        ax.plot([p[0], q[0]], [p[1], q[1]], color="0.3", lw=lw, zorder=1)
    sc = ax.scatter(pos[:, 0], pos[:, 1], c=attn[:len(pos)], cmap=cmap,
                    s=420, zorder=2, edgecolors="k")
    for i, a in enumerate(mol.GetAtoms()):
        ax.annotate(a.symbol, pos[i], ha="center", va="center", zorder=3)
    fig.colorbar(sc, ax=ax, label="attention")
    ax.set_axis_off()
    fig.savefig(out_file, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_file


def draw_protein_with_attn(pdb_file: str, attn_weights, out_file: str, cmap: str = "Reds"):
    """Protein render colored by per-residue attention; PyMOL B-factor
    spectrum when available (reference visualization_utils.py:26-78), else a
    matplotlib 3D CA trace."""
    attn = np.asarray(attn_weights, dtype=float)
    try:
        import pymol2
        with pymol2.PyMOL() as p:
            p.cmd.load(pdb_file, "prot")
            p.cmd.alter("prot", "b=0.0")
            for i, a in enumerate(attn):
                p.cmd.alter(f"prot and resi {i + 1}", f"b={float(a)}")
            p.cmd.spectrum("b", "white_red", "prot")
            p.cmd.show_as("cartoon", "prot")
            p.cmd.set("ray_opaque_background", 0)
            p.cmd.png(out_file, width=1200, height=1200, dpi=150, ray=1)
        return out_file
    except ImportError:
        pass

    plt = pyplot()
    from caster_dta_torch.data.featurize.pdb import load_backbone_coords

    coords, _ = load_backbone_coords(pdb_file)
    ca = coords[:, 1, :] * 10
    n = min(len(ca), len(attn))
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(projection="3d")
    ax.plot(ca[:, 0], ca[:, 1], ca[:, 2], color="0.6", lw=1)
    sc = ax.scatter(ca[:n, 0], ca[:n, 1], ca[:n, 2], c=attn[:n], cmap=cmap, s=30)
    fig.colorbar(sc, ax=ax, shrink=0.6, label="attention")
    ax.set_axis_off()
    fig.savefig(out_file, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_file


def draw_protein_difference(ref_file: str, alt_file: str, ref_attn, alt_attn,
                            out_file: str, top_k_labels: int = 5):
    """Ref/alt/difference grid with top-residue labels
    (reference visualization_utils.py:81-191)."""
    plt = pyplot()
    from caster_dta_torch.data.featurize.pdb import load_backbone_coords

    ref_attn = np.asarray(ref_attn, float)
    alt_attn = np.asarray(alt_attn, float)
    n = min(len(ref_attn), len(alt_attn))
    diff = alt_attn[:n] - ref_attn[:n]

    fig = plt.figure(figsize=(18, 6))
    for j, (f, a, title, cmap) in enumerate([
            (ref_file, ref_attn, "reference", "Reds"),
            (alt_file, alt_attn, "alternate", "Reds"),
            (alt_file, diff, "difference (alt - ref)", "coolwarm")]):
        coords, _ = load_backbone_coords(f)
        ca = coords[:, 1, :] * 10
        m = min(len(ca), len(a))
        ax = fig.add_subplot(1, 3, j + 1, projection="3d")
        ax.plot(ca[:, 0], ca[:, 1], ca[:, 2], color="0.7", lw=1)
        sc = ax.scatter(ca[:m, 0], ca[:m, 1], ca[:m, 2], c=a[:m], cmap=cmap, s=25)
        top = np.argsort(-np.abs(a[:m]))[:top_k_labels]
        for t in top:
            ax.text(ca[t, 0], ca[t, 1], ca[t, 2], str(t + 1), fontsize=8)
        ax.set_title(title)
        ax.set_axis_off()
        fig.colorbar(sc, ax=ax, shrink=0.5)
    fig.savefig(out_file, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_file
