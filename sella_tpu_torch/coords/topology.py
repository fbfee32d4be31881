"""Host-side topology discovery: bonds, angles, dihedrals, fragments.

A copy of ``sella_tpu/coords/topology.py`` (plain numpy setup code that
runs once per structure or per rebuild event), without its optional
dispatch to the native C++ bond search and flood fill: this module is
the numpy path that ``tests/test_native.py`` holds the native one to.
Rules:

* bonds: pairs within ``scale * (rcov_i + rcov_j)``, searched over
  periodic images (MIC via a reduced cell); the scale grows 5% per
  round until the bond graph is connected (or fragments are allowed,
  which instead adds per-fragment translation+rotation coordinates —
  TRICs);
* angles: all bonded triples whose angle is not within ``atol`` of
  0/pi; near-linear angles are replaced by an improper dihedral when
  the center has >=3 neighbors (2-neighbor linear centers need a dummy
  atom — not yet implemented here; a warning is raised);
* dihedrals: all angle pairs sharing a bond edge, plus improper
  dihedrals at 3-4 coordinate centers with no proper dihedral (keeps
  the Jacobian well-conditioned for planar groups).
"""
from __future__ import annotations

from itertools import combinations, product
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.elements import covalent_radii


def _angle_of(pos, i, j, k, tvec_ij, tvec_jk) -> float:
    dx1 = -(pos[j] - pos[i] + tvec_ij)
    dx2 = pos[k] - pos[j] + tvec_jk
    c = dx1 @ dx2 / (np.linalg.norm(dx1) * np.linalg.norm(dx2))
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


class Topology:
    """Discovered coordinate lists.

    bonds: list of (i, j, ncvec(3,))
    angles: list of (i, j, k, ncvecs(2,3))
    dihedrals: list of (i, j, k, l, ncvecs(3,3))
    fragments: list of index arrays (only when allow_fragments and the
      graph is disconnected), lone_atoms: isolated atoms.
    """

    def __init__(self):
        self.bonds: List[Tuple[int, int, np.ndarray]] = []
        self.angles: List[Tuple[int, int, int, np.ndarray]] = []
        self.dihedrals: List[Tuple[int, int, int, int, np.ndarray]] = []
        self.fragments: List[np.ndarray] = []
        self.lone_atoms: List[int] = []
        self.forbidden_angles: set = set()


def _bond_key(i, j, ncvec):
    if (j, tuple(-np.asarray(ncvec))) < (i, tuple(np.asarray(ncvec))):
        return (j, i, tuple(int(-c) for c in ncvec))
    return (i, j, tuple(int(c) for c in ncvec))


def _angle_key(a, j, b, ncvs):
    """Reversal-invariant canonical key of an angle record."""
    ncvs = np.asarray(ncvs, dtype=np.int64)
    fwd = (a, j, b) + tuple(map(tuple, ncvs.tolist()))
    rev = (b, j, a) + tuple(map(tuple, (-ncvs[::-1]).tolist()))
    return min(fwd, rev)


def _dihedral_key(i, j, k, l, ncvs):
    """Reversal-invariant canonical key of a dihedral record."""
    ncvs = np.asarray(ncvs, dtype=np.int64)
    fwd = (i, j, k, l) + tuple(map(tuple, ncvs.tolist()))
    rev = (l, k, j, i) + tuple(map(tuple, (-ncvs[::-1]).tolist()))
    return min(fwd, rev)


def _candidate_bonds(positions, cell, pbc, labels, scale, rcov):
    """All atom pairs (across fragments) within the covalent threshold,
    including periodic images (``internal.py:3260-3332``).

    The image search runs in the Minkowski-reduced basis (one +-1 shell
    is exhaustive there; on the raw basis a skewed cell can hide a
    closer image — reference ``internal.py:2638,3274``) and the found
    offsets are mapped back to the caller's basis.

    """
    from ..utils.lattice import reduce_cell_basis

    any_pbc0 = bool(np.any(pbc))
    M = np.eye(3, dtype=np.int64)
    if any_pbc0:
        cell, M = reduce_cell_basis(cell, pbc)

    n = len(positions)
    ii, jj = np.triu_indices(n, k=0)
    same = (labels[ii] == labels[jj]) & (labels[ii] != -1)
    ii, jj = ii[~same], jj[~same]
    if len(ii) == 0:
        return []

    dx = positions[jj] - positions[ii]
    any_pbc = bool(np.any(pbc))
    if any_pbc:
        inv = np.linalg.inv(cell)
        frac = dx @ inv
        offset = np.where(pbc, np.round(frac), 0.0).astype(np.int64)
        ranges = [np.arange(-int(p), int(p) + 1) for p in pbc]
        base_ts = np.array(list(product(*ranges)), dtype=np.int64)
        shifted = base_ts[None, :, :] - offset[:, None, :]
        tvecs = shifted @ cell
    else:
        shifted = np.zeros((len(ii), 1, 3), dtype=np.int64)
        tvecs = np.zeros((len(ii), 1, 3))

    dists = np.linalg.norm(dx[:, None, :] + tvecs, axis=2)
    thr = scale * (rcov[ii] + rcov[jj])
    mask = dists <= thr[:, None]
    self_pair = ii == jj
    zero_ts = np.all(shifted == 0, axis=2)
    mask &= ~(self_pair[:, None] & zero_ts)

    out = []
    pi, ti = np.nonzero(mask)
    for p, t in zip(pi, ti):
        n_red = shifted[p, t].astype(np.int64)
        out.append((int(ii[p]), int(jj[p]),
                    n_red @ M if any_pbc0 else n_red))
    return out


def _flood_labels(n, bonds) -> Tuple[np.ndarray, int]:
    adj = [[] for _ in range(n)]
    for i, j, _ in bonds:
        adj[i].append(j)
        adj[j].append(i)
    labels = -np.ones(n, dtype=np.int64)
    nlab = 0
    for s in range(n):
        if labels[s] != -1:
            continue
        stack = [s]
        labels[s] = nlab
        while stack:
            u = stack.pop()
            for v in adj[u]:
                if labels[v] != labels[s]:
                    labels[v] = labels[s]
                    stack.append(v)
        nlab += 1
    return labels, nlab


def find_bonds(
    numbers: np.ndarray,
    positions: np.ndarray,
    cell: np.ndarray,
    pbc: np.ndarray,
    scale: float = 1.25,
    allow_fragments: bool = False,
    existing: Optional[list] = None,
) -> Topology:
    """Iterative bond discovery until the graph connects
    (``internal.py:3366-3455``)."""
    topo = Topology()
    n = len(numbers)
    rcov = covalent_radii[numbers]
    seen = set()
    if existing:
        for i, j, ncvec in existing:
            topo.bonds.append((i, j, np.asarray(ncvec, dtype=np.int64)))
            seen.add(_bond_key(i, j, ncvec))

    first_run = True
    while True:
        labels, nlab = _flood_labels(n, topo.bonds)
        # single atoms with no bonds keep label -1 handling below
        nbonds = np.zeros(n, dtype=np.int64)
        for i, j, _ in topo.bonds:
            nbonds[i] += 1
            nbonds[j] += 1
        labels_eff = labels.copy()
        labels_eff[nbonds == 0] = -1

        if nlab == 1:
            break
        if allow_fragments and not first_run:
            break

        cands = _candidate_bonds(positions, cell, pbc, labels_eff, scale,
                                 rcov)
        for i, j, ts in cands:
            key = _bond_key(i, j, ts)
            if key in seen:
                continue
            seen.add(key)
            topo.bonds.append((i, j, np.asarray(ts, dtype=np.int64)))
        first_run = False
        scale *= 1.05

    if allow_fragments and nlab != 1:
        groups: Dict[int, list] = {}
        for i, lab in enumerate(labels_eff):
            if lab == -1:
                topo.lone_atoms.append(i)
            else:
                groups.setdefault(int(lab), []).append(i)
        topo.fragments = [
            np.array(g, dtype=np.int64) for g in groups.values() if g
        ]
    return topo


def find_angles(topo: Topology, positions: np.ndarray, cell: np.ndarray,
                atol: float) -> None:
    """All bonded triples with a non-degenerate bend
    (``internal.py:3457-3573``, without the dummy-atom machinery)."""
    n = len(positions)
    # neighbor list: (j, ncvec from center to j)
    neigh = [[] for _ in range(n)]
    for i, j, ncvec in topo.bonds:
        neigh[i].append((j, ncvec))
        neigh[j].append((i, -ncvec))

    linear_centers = []  # (j, (a, nca), (b, ncb)) needing dummy atoms
    for j in range(n):
        linear = []
        for (a, nca), (b, ncb) in combinations(neigh[j], 2):
            # angle a-j-b; tvec_aj = -nca (from a to j), tvec_jb = ncb
            tv1 = -nca @ cell
            tv2 = ncb @ cell
            ang = _angle_of(positions, a, j, b, tv1, tv2)
            key = (a, j, b, tuple(nca), tuple(ncb))
            if atol < ang < np.pi - atol:
                topo.angles.append(
                    (a, j, b, np.stack([-nca, ncb]).astype(np.int64))
                )
            else:
                topo.forbidden_angles.add(key)
                linear.append(((a, nca), (b, ncb)))
        if linear:
            if len(neigh[j]) == 2:
                # needs a dummy atom; handled by the Internals container
                # (sorted shortest-bond-first for permutational
                # invariance, ``internal.py:3482-3486``)
                (a, nca), (b, ncb) = sorted(
                    neigh[j],
                    key=lambda t: np.linalg.norm(
                        positions[t[0]] - positions[j] + t[1] @ cell
                    ),
                )
                linear_centers.append((j, (a, nca), (b, ncb)))
            else:
                # replace each linear angle with an improper dihedral
                # through a third neighbor (``internal.py:3551-3573``)
                for (a, nca), (b, ncb) in linear:
                    for c, ncc in neigh[j]:
                        if c in (a, b):
                            continue
                        ncvecs = np.stack(
                            [-nca, ncc, ncb - ncc]
                        ).astype(np.int64)
                        topo.dihedrals.append((a, j, c, b, ncvecs))
                        break
                    else:
                        raise RuntimeError(
                            "Unable to find improper dihedral to replace "
                            "linear angle!"
                        )
    return linear_centers


def find_dihedrals(topo: Topology) -> None:
    """Proper dihedrals from angle pairs sharing a bond edge, plus
    impropers at undersampled 3-4 coordinate centers
    (``internal.py:3575-3671``)."""
    seen = set()

    def try_add(i, j, k, l, ncvecs):
        # canonical key (reversal-invariant)
        fwd = (i, j, k, l) + tuple(map(tuple, ncvecs))
        rev_ncv = tuple(map(tuple, (-np.asarray(ncvecs))[::-1]))
        rev = (l, k, j, i) + rev_ncv
        if fwd in seen or rev in seen:
            return
        seen.add(fwd)
        topo.dihedrals.append(
            (i, j, k, l, np.asarray(ncvecs, dtype=np.int64))
        )

    # index angles by their edges
    edge_map: Dict[tuple, list] = {}
    for idx, (a, j, b, ncv) in enumerate(topo.angles):
        for e in ((min(a, j), max(a, j)), (min(j, b), max(j, b))):
            edge_map.setdefault(e, []).append(idx)

    tried = set()
    for angle_ids in edge_map.values():
        for x, y in combinations(angle_ids, 2):
            if (x, y) in tried:
                continue
            tried.add((x, y))
            d = _combine_angles(topo.angles[x], topo.angles[y])
            if d is None:
                continue
            i, j, k, l, ncvecs = d
            # reject self-closing ring dihedral
            if i == l and np.all(np.sum(ncvecs, axis=0) == 0):
                continue
            try_add(i, j, k, l, ncvecs)

    # improper dihedrals at 3-4 coordinate centers lacking propers
    centers = set()
    for (i, j, k, l, _) in topo.dihedrals:
        centers.add(j)
        centers.add(k)
    n = 1 + max(
        [max(i, j, k) for (i, j, k, _) in topo.angles] +
        [max(i, j) for (i, j, _) in topo.bonds] + [0]
    )
    neigh = [[] for _ in range(n)]
    for i, j, ncvec in topo.bonds:
        neigh[i].append((j, ncvec))
        neigh[j].append((i, -ncvec))
    for c in range(n):
        if len(neigh[c]) not in (3, 4) or c in centers:
            continue
        (n0, v0), (n1, v1), (n2, v2) = neigh[c][:3]
        ncvecs = np.stack([-v0, v1, v2 - v1]).astype(np.int64)
        try_add(n0, c, n1, n2, ncvecs)


def _combine_angles(a1, a2):
    """Join two angles sharing a directed bond into a dihedral
    (the reference's Angle.__add__, ``internal.py:331-463``)."""
    i1, j1, k1, ncv1 = a1
    i2, j2, k2, ncv2 = a2
    # orientations of each angle: (first, center, last) with ncvecs rows
    # (first->center is -ncv[0]? our convention: ncv rows are tvec steps)
    # Our angle record: (a, j, b, ncvecs=[(j-a step), (b-j step)])
    for A in (
        (i1, j1, k1, ncv1),
        (k1, j1, i1, -ncv1[::-1]),
    ):
        for B in (
            (i2, j2, k2, ncv2),
            (k2, j2, i2, -ncv2[::-1]),
        ):
            a, b, c, nA = A
            d, e, f, nB = B
            # dihedral a-b-c-f when (b, c) == (d, e) and middle steps agree
            if (b, c) == (d, e) and np.all(nA[1] == nB[0]):
                ncvecs = np.stack([nA[0], nA[1], nB[1]])
                if a == c or b == f or a == b or c == f:
                    # degenerate
                    continue
                return (a, b, c, f, ncvecs.astype(np.int64))
    return None
