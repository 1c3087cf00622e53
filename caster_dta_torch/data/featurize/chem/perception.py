"""Molecular perception: rings, aromaticity, implicit hydrogens, radicals,
hybridization, conjugation, and double-bond stereo.

Implements the standard published algorithms (OpenSMILES normal-valence
implicit-H rule, Hückel 4n+2 aromaticity over the ring basis, steric-number
hybridization). Property semantics follow what the reference reads off RDKit
atoms/bonds (utils/create_smiles_features.py).

Rings come from the port's own bridge finder (Tarjan's low links) and minimum
cycle basis. The basis is the one ``networkx.minimum_cycle_basis`` returns
(de Pina's algorithm as networkx implements it: a spanning tree by Kruskal over
the edges in adjacency order, the chords as orthogonal vectors, each cycle the
shortest odd path through a lifted copy of the graph), with the same
tie-breaking, so the same rings come back in the same order with their atoms
in the same order. Aromaticity reads the rings in that order, so both matter.

Documented divergences from RDKit (tested in tests/test_chem.py):
  * chiral tags are kept as written (RDKit's AssignStereochemistry may strip
    chemically-meaningless tags);
  * aromaticity is the classic Hückel model per ring + fused-pair pass, close
    to but not bit-identical with RDKit's default model on exotic systems.
"""
from __future__ import annotations

import heapq
from itertools import count

from caster_dta_torch.data.featurize.chem.mol import Mol, Atom


def sanitize(mol: Mol) -> Mol:
    perceive_rings(mol)
    compute_implicit_hydrogens(mol)
    perceive_aromaticity(mol)
    compute_radicals(mol)
    compute_hybridization(mol)
    perceive_conjugation(mol)
    assign_double_bond_stereo(mol)
    return mol


def _adjacency(mol: Mol) -> dict:
    """Atom -> {neighbour: None}, in the insertion order of networkx.Graph
    built with add_nodes_from(range(n)) and add_edge per bond."""
    adj: dict = {i: {} for i in range(len(mol.atoms))}
    for b in mol.bonds:
        adj[b.a1][b.a2] = None
        adj[b.a2][b.a1] = None
    return adj


def _bridges(adj: dict) -> set:
    """Edges on no cycle, as frozensets (Tarjan: an edge u-v of the DFS tree
    is a bridge when no back edge from v's subtree reaches u or above)."""
    disc: dict = {}
    low: dict = {}
    out = set()
    for root in adj:
        if root in disc:
            continue
        disc[root] = low[root] = len(disc)
        stack = [(root, None, iter(adj[root]))]
        while stack:
            v, parent, nbrs = stack[-1]
            for w in nbrs:
                if w == parent:
                    continue
                if w in disc:
                    low[v] = min(low[v], disc[w])
                else:
                    disc[w] = low[w] = len(disc)
                    stack.append((w, v, iter(adj[w])))
                    break
            else:
                stack.pop()
                if parent is not None:
                    low[parent] = min(low[parent], low[v])
                    if low[v] > disc[parent]:
                        out.add(frozenset((parent, v)))
    return out


def perceive_rings(mol: Mol) -> None:
    adj = _adjacency(mol)
    bridges = _bridges(adj)
    ring_atoms = set()
    for b in mol.bonds:
        b.in_ring = frozenset((b.a1, b.a2)) not in bridges
        if b.in_ring:
            ring_atoms.update((b.a1, b.a2))
    for a in mol.atoms:
        a.in_ring = a.idx in ring_atoms
    mol.rings = [list(c) for c in minimum_cycle_basis(adj)]


# ---------------------------------------------------------------------------
# minimum cycle basis, step for step as networkx 3 computes it (its sets are
# built by the same operations, so they iterate in the same order)
# ---------------------------------------------------------------------------

def _components(adj: dict):
    """Connected components as networkx's connected_components yields them:
    sets filled breadth first, in node order."""
    seen: set = set()
    n = len(adj)
    for v in adj:
        if v not in seen:
            c = _plain_bfs(adj, n - len(seen), v)
            seen.update(c)
            yield c


def _plain_bfs(adj: dict, n: int, source) -> set:
    seen = {source}
    nextlevel = [source]
    while nextlevel:
        thislevel = nextlevel
        nextlevel = []
        for v in thislevel:
            for w in adj[v]:
                if w not in seen:
                    seen.add(w)
                    nextlevel.append(w)
            if len(seen) == n:
                return seen
    return seen


class _Subgraph:
    """The induced subgraph view on ``nodes``: networkx iterates the node set
    itself when it holds under half of the graph, else the graph's nodes."""

    def __init__(self, adj: dict, component: set):
        self.adj = adj
        self.nodes = set(n for n in component if n in adj)
        if 2 * len(self.nodes) < len(adj):
            self.order = [n for n in self.nodes if n in adj]
        else:
            self.order = [n for n in adj if n in self.nodes]

    def edges(self) -> list:
        out, seen = [], {}
        for n in self.order:
            for nbr in self.adj[n]:
                if nbr in self.nodes and nbr not in seen:
                    out.append((n, nbr))
            seen[n] = 1
        return out


def minimum_cycle_basis(adj: dict) -> list:
    """networkx.minimum_cycle_basis(G) of the graph with adjacency ``adj``:
    a list of cycles, each a list of nodes."""
    return sum((_min_cycle_basis(_Subgraph(adj, c)) for c in _components(adj)), [])


def _min_cycle_basis(g: _Subgraph) -> list:
    cb = []
    edges = g.edges()
    tree_edges = _kruskal(edges)
    tree_set = set(tree_edges)
    chords = set(e for e in edges if e not in tree_set) - {(v, u) for u, v in tree_edges}
    set_orth = [{edge} for edge in chords]
    while set_orth:
        base = set_orth.pop()
        cycle_edges = _min_cycle(g, edges, base)
        cb.append([v for u, v in cycle_edges])
        set_orth = [
            ({e for e in orth if e not in base if e[::-1] not in base}
             | {e for e in base if e not in orth if e[::-1] not in orth})
            if sum((e in orth or e[::-1] in orth) for e in cycle_edges) % 2
            else orth
            for orth in set_orth
        ]
    return cb


def _kruskal(edges: list) -> list:
    """Spanning forest edges, Kruskal over ``edges`` in order (every weight 1,
    so the stable sort keeps the order)."""
    parent: dict = {}

    def find(x):
        root = x
        while parent.get(root, root) != root:
            root = parent[root]
        while x != root:
            parent[x], x = root, parent.get(x, x)
        return root

    tree = []
    for u, v in edges:
        ru, rv = find(u), find(v)
        if ru != rv:
            tree.append((u, v))
            parent[ru] = rv
    return tree


def _add_edge(adj: dict, u, v) -> None:
    adj.setdefault(u, {})
    adj.setdefault(v, {})
    adj[u][v] = None
    adj[v][u] = None


def _min_cycle(g: _Subgraph, edges: list, orth: set) -> list:
    """The shortest cycle of ``g`` with an odd number of edges in ``orth``:
    the shortest path from a node n to its lifted copy (n, 1), where edges in
    ``orth`` cross between the two copies."""
    lifted: dict = {}
    for u, v in edges:
        if (u, v) in orth or (v, u) in orth:
            _add_edge(lifted, u, (v, 1))
            _add_edge(lifted, (u, 1), v)
        else:
            _add_edge(lifted, u, v)
            _add_edge(lifted, (u, 1), (v, 1))
    lift = {n: _bfs_length(lifted, n, (n, 1)) for n in g.order}
    start = min(lift, key=lift.get)
    path = [n[0] if isinstance(n, tuple) else n
            for n in _bidirectional_dijkstra(lifted, start, (start, 1))]

    # drop the edges that the path takes twice
    edgelist = list(zip(path, path[1:]))
    edgeset: set = set()
    for e in edgelist:
        if e in edgeset:
            edgeset.remove(e)
        elif e[::-1] in edgeset:
            edgeset.remove(e[::-1])
        else:
            edgeset.add(e)
    min_edgelist = []
    for e in edgelist:
        if e in edgeset:
            min_edgelist.append(e)
            edgeset.remove(e)
        elif e[::-1] in edgeset:
            min_edgelist.append(e[::-1])
            edgeset.remove(e[::-1])
    return min_edgelist


def _bfs_length(adj: dict, source, target) -> int:
    """Unit-weight shortest path length (networkx's Dijkstra length)."""
    if source == target:
        return 0
    dist = {source: 0}
    frontier = [source]
    while frontier:
        nxt = []
        for v in frontier:
            for w in adj[v]:
                if w not in dist:
                    dist[w] = dist[v] + 1
                    if w == target:
                        return dist[w]
                    nxt.append(w)
        frontier = nxt
    raise ValueError(f"no path between {source} and {target}")


def _bidirectional_dijkstra(adj: dict, source, target) -> list:
    """networkx.bidirectional_dijkstra's path with unit weights, with its
    tie-breaking (heap entries ordered by distance, then push order)."""
    if source == target:
        return [source]
    dists: list = [{}, {}]
    preds: list = [{source: None}, {target: None}]

    def path(curr, direction):
        ret = []
        while curr is not None:
            ret.append(curr)
            curr = preds[direction][curr]
        return list(reversed(ret)) if direction == 0 else ret

    fringe: list = [[], []]
    seen: list = [{source: 0}, {target: 0}]
    c = count()
    heapq.heappush(fringe[0], (0, next(c), source))
    heapq.heappush(fringe[1], (0, next(c), target))
    finaldist = None
    meetnode = None
    direction = 1
    while fringe[0] and fringe[1]:
        direction = 1 - direction
        dist, _, v = heapq.heappop(fringe[direction])
        if v in dists[direction]:
            continue
        dists[direction][v] = dist
        if v in dists[1 - direction]:
            return path(meetnode, 0) + path(preds[1][meetnode], 1)
        for w in adj[v]:
            vw_length = dist + 1
            if w in dists[direction]:
                continue
            if w not in seen[direction] or vw_length < seen[direction][w]:
                seen[direction][w] = vw_length
                heapq.heappush(fringe[direction], (vw_length, next(c), w))
                preds[direction][w] = v
                if w in seen[1 - direction]:
                    finaldist_w = vw_length + seen[1 - direction][w]
                    if finaldist is None or finaldist > finaldist_w:
                        finaldist, meetnode = finaldist_w, w
    raise ValueError(f"no path between {source} and {target}")


def _effective_valences(atom: Atom):
    """Charge-adjusted normal valences (OpenSMILES + common charge rules)."""
    q = atom.formal_charge
    base = atom.default_valences
    if atom.symbol == "B":
        return tuple(max(0, v - q) for v in base)
    if atom.symbol == "C":
        return tuple(max(0, v - abs(q)) for v in base)
    return tuple(max(0, v + q) for v in base)


def compute_implicit_hydrogens(mol: Mol) -> None:
    for a in mol.atoms:
        if a.explicit_hs is not None:        # bracket atom: H count is explicit
            a.implicit_hs = 0
            continue
        # connection count: aromatic bonds count 1 each plus one shared pi
        if a.aromatic and any(b.bond_type == "AROMATIC" for b in a.bonds):
            conn = sum(1 if b.bond_type == "AROMATIC" else b.order for b in a.bonds)
            conn += 1
        else:
            conn = a.bond_order_sum()
        conn = int(conn + 0.5)  # round up x.5 from odd aromatic counts
        for v in _effective_valences(a):
            if conn <= v:
                a.implicit_hs = v - conn
                break
        else:
            a.implicit_hs = 0


def compute_radicals(mol: Mol) -> None:
    for a in mol.atoms:
        if a.explicit_hs is None:
            a.radicals = 0                   # implicit H filled the valence
            continue
        used = a.bond_order_sum() + a.explicit_hs
        if a.aromatic and any(b.bond_type == "AROMATIC" for b in a.bonds):
            used += 1
        used = int(used + 0.5)
        vals = _effective_valences(a)
        for v in vals:
            if used <= v:
                a.radicals = v - used
                break
        else:
            a.radicals = 0


def _pi_electrons(mol: Mol, atom: Atom, ring: set) -> int | None:
    """Hückel pi-electron contribution of `atom` within `ring`;
    None -> atom cannot participate (sp3-like), ring not aromatic."""
    in_ring_double = exo_double = False
    for b in atom.bonds:
        other = b.other(atom.idx).idx
        if b.bond_type in ("DOUBLE", "AROMATIC"):
            if other in ring:
                in_ring_double = True
            else:
                exo_double = True
        elif b.bond_type == "TRIPLE":
            return None
    if atom.aromatic or in_ring_double:
        return 1
    if exo_double:
        return 0                              # e.g. quinone carbonyl carbon
    # saturated atom: heteroatom lone pair may contribute 2 (pyrrole N,
    # furan O, thiophene S); carbanion 2; carbocation 0
    q = atom.formal_charge
    if atom.symbol == "C":
        if q == 1:
            return 0
        if q == -1:
            return 2
        return None
    lp = (atom.valence_electrons - q - int(atom.bond_order_sum() + 0.5)
          - atom.implicit_hs - (atom.explicit_hs or 0)) // 2
    if lp > 0:
        return 2
    return None


def perceive_aromaticity(mol: Mol) -> None:
    """Hückel 4n+2 over basis rings, iterated to fixpoint, then over fused
    pairs (covers naphthalene-like systems written Kekulé)."""
    rings = [set(r) for r in mol.rings]
    changed = True
    guard = 0
    while changed and guard < 10:
        guard += 1
        changed = False
        candidates = list(rings)
        # fused pairs: union of two basis rings sharing an edge
        for i in range(len(rings)):
            for j in range(i + 1, len(rings)):
                if len(rings[i] & rings[j]) >= 2:
                    candidates.append(rings[i] | rings[j])
        for ring in candidates:
            if len(ring) < 3:
                continue
            if all(mol.atoms[a].aromatic for a in ring):
                continue
            pis = [_pi_electrons(mol, mol.atoms[a], ring) for a in ring]
            if any(p is None for p in pis):
                continue
            if sum(pis) % 4 == 2:
                for a in ring:
                    mol.atoms[a].aromatic = True
                changed = True
    # bonds between aromatic atoms within a ring become AROMATIC
    for b in mol.bonds:
        if (b.in_ring and mol.atoms[b.a1].aromatic and mol.atoms[b.a2].aromatic
                and _share_ring(mol, b.a1, b.a2)):
            b.bond_type = "AROMATIC"


def _share_ring(mol: Mol, a1: int, a2: int) -> bool:
    return any(a1 in r and a2 in r for r in mol.rings)


def compute_hybridization(mol: Mol) -> None:
    for a in mol.atoms:
        if a.aromatic:
            a.hybridization = "SP2"
            continue
        order_sum = int(a.bond_order_sum() + 0.5) + a.implicit_hs + (a.explicit_hs or 0)
        nonbonded = a.valence_electrons - a.formal_charge - order_sum - a.radicals
        lp = max(0, nonbonded // 2)
        sigma = a.total_sigma()
        # multiple bonds consume p orbitals: steric number = sigma + lone pairs
        sn = sigma + lp
        # sp-like corrections: cumulated/triple bonds
        n_double = sum(1 for b in a.bonds if b.bond_type == "DOUBLE")
        n_triple = sum(1 for b in a.bonds if b.bond_type == "TRIPLE")
        if n_triple or n_double >= 2:
            sn = min(sn, 2)
        elif n_double == 1:
            sn = min(sn, max(sigma + lp - 1, 3)) if sigma + lp > 3 else sn
            sn = min(sn, 3) if sigma <= 3 else sn
        a.hybridization = {0: "S", 1: "S", 2: "SP", 3: "SP2", 4: "SP3",
                           5: "SP3D", 6: "SP3D2"}.get(sn, "UNSPECIFIED")


def _can_conjugate(atom: Atom) -> bool:
    if atom.aromatic:
        return True
    if any(b.bond_type in ("DOUBLE", "TRIPLE", "AROMATIC") for b in atom.bonds):
        return True
    if atom.symbol in ("N", "O", "S", "P"):
        order_sum = int(atom.bond_order_sum() + 0.5) + atom.implicit_hs + (atom.explicit_hs or 0)
        lp = (atom.valence_electrons - atom.formal_charge - order_sum) // 2
        return lp > 0
    return False


def perceive_conjugation(mol: Mol) -> None:
    """RDKit-style: a bond is conjugated when both ends can hold an aligned
    p orbital (multiple bond / aromatic / heteroatom lone pair), and for a
    single bond at least one end has a multiple bond so there is actually an
    adjacent pi system."""
    for b in mol.bonds:
        a1, a2 = mol.atoms[b.a1], mol.atoms[b.a2]
        if b.bond_type == "AROMATIC":
            b.conjugated = True
            continue
        if not (_can_conjugate(a1) and _can_conjugate(a2)):
            b.conjugated = False
            continue
        if b.bond_type in ("DOUBLE", "TRIPLE"):
            # conjugated if an adjacent bond continues the pi system
            b.conjugated = any(
                ob is not b and ob.bond_type in ("DOUBLE", "TRIPLE", "AROMATIC")
                or (ob is not b and _can_conjugate(ob.other(end.idx)))
                for end in (a1, a2) for ob in end.bonds)
        else:
            has_pi = lambda atom: atom.aromatic or any(
                ob.bond_type in ("DOUBLE", "TRIPLE", "AROMATIC") for ob in atom.bonds)
            b.conjugated = has_pi(a1) or has_pi(a2)


def assign_double_bond_stereo(mol: Mol) -> None:
    """E/Z from directional single bonds (/ and \\), RDKit STEREOE/STEREOZ."""
    for b in mol.bonds:
        if b.bond_type != "DOUBLE" or b.in_ring:
            continue
        s1 = _end_direction(mol, b.a1, b)
        s2 = _end_direction(mol, b.a2, b)
        if s1 == 0 or s2 == 0:
            continue
        b.stereo = "STEREOE" if s1 * s2 < 0 else "STEREOZ"


def _end_direction(mol: Mol, atom_idx: int, dbond) -> int:
    for nb in mol.atoms[atom_idx].bonds:
        if nb is dbond or nb.direction == "NONE":
            continue
        sign = 1 if nb.direction == "ENDUPRIGHT" else -1
        # '/' means "up toward a2"; flip if the stereo atom is the bond start
        if nb.a1 == atom_idx:
            sign = -sign
        return sign
    return 0
