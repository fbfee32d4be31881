"""Internal-coordinate container and batched evaluation engine.

Counterpart of ``sella_tpu/coords/internals.py``:

* topology lives in plain host lists (setup code, see
  :mod:`sella_tpu_torch.coords.topology`); :class:`Internals` is host
  numpy, as in the JAX package;
* :class:`_Engine` evaluates one topology with per-kind index tensors
  (exact counts: the JAX package pads each kind to a multiple of 16 for
  XLA's static shapes, which eager torch does not need) — values via
  ``vmap(fn)``, the B matrix via ``vmap(grad)`` and an out-of-place
  ``index_add``, curvature contractions via ``vmap(jvp(grad))`` HVPs —
  as pure torch functions of ``(pos, cell)`` that ``torch.func.vmap``
  batches over lanes. Its index tensors are built once per device;
* coordinate ordering: translations, bonds, angles, dihedrals, other,
  rotations.

Linear centers: >=3-coordinate centers get improper-dihedral
replacements; 2-coordinate centers get a dummy atom perpendicular to the
axis with a constrained dummy bond/angle and an improper-dihedral bend
(``internal.py:3482-3550``).
"""
from __future__ import annotations

import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, jvp, vmap

from ..atoms import Atoms
from ..utils import units
from ..utils.elements import covalent_radii
from . import primitives as prim
from . import topology as topo_mod
from .constraints import Constraints, DummyStore, DuplicateInternalError


def _t(a) -> torch.Tensor:
    """A host float64 tensor of ``a``."""
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


class Internals:
    """Redundant internal coordinates of one structure."""

    def __init__(
        self,
        atoms: Atoms,
        cons: Optional[Constraints] = None,
        allow_fragments: bool = False,
        atol_deg: float = 15.0,
    ) -> None:
        self.atoms = atoms
        self.dummies = DummyStore()
        if cons is None:
            cons = Constraints(atoms, dummies=self.dummies)
        else:
            cons.dummies = self.dummies
        self.cons = cons
        self.allow_fragments = allow_fragments
        self.atol = np.radians(atol_deg)
        # dinds[i] = extended index of atom i's dummy, or -1
        self.dinds = -np.ones(len(atoms), dtype=np.int64)

        # coordinate records
        self.trans: List[Tuple[np.ndarray]] = []    # (indices,) per axis-triple
        self.trans_axes: List[int] = []
        self.bonds: List[Tuple[int, int, np.ndarray]] = []
        self.angles: List[tuple] = []
        self.dihedrals: List[tuple] = []
        self.rotations: List[tuple] = []  # (indices, axis, ref_positions)
        self.others: List[tuple] = []     # (fn, indices) user coordinates
        self.fragment_atom_groups: List[np.ndarray] = []

        self._engine = None
        self._bond_keys = set()
        # reversal-invariant canonical keys of coordinates the user has
        # banned from auto-discovery (reference forbid_* API,
        # ``internal.py:3190-3245``)
        self.forbidden = {"bonds": set(), "angles": set(),
                          "dihedrals": set()}

        # The reference folds every constrained coordinate into the
        # coordinate set itself (``internal.py:3061-3069``): the
        # constrained DOF must be spanned by q so the IC-space basis
        # split can separate Ucons from Ufree, and the constrained rows
        # carry their own guess-Hessian entries (h0cart=70 for
        # trans/rot, ``internal.py:3793-3818``). Same group order.
        for rec in cons.records["translations"]:
            self.add_translation(rec.indices, rec.axis)
        for rec in cons.records["bonds"]:
            self.add_bond(rec.indices,
                          None if rec.ncvecs is None else rec.ncvecs[0])
        for rec in cons.records["angles"]:
            self.add_angle(rec.indices, rec.ncvecs)
        for rec in cons.records["dihedrals"]:
            self.add_dihedral(rec.indices, rec.ncvecs)
        for rec in cons.records["other"]:
            self.add_user_coordinate(rec.fn, rec.indices)
        for rec in cons.records["rotations"]:
            self.add_rotation(rec.indices, rec.axis, refpos=rec.ref)

    # -- counts (reference property names) -----------------------------------
    @property
    def ntrans(self):
        return len(self.trans)

    @property
    def nbonds(self):
        return len(self.bonds)

    @property
    def nangles(self):
        return len(self.angles)

    @property
    def ndihedrals(self):
        return len(self.dihedrals)

    @property
    def nother(self):
        return len(self.others)

    @property
    def nrotations(self):
        return len(self.rotations)

    @property
    def nint(self):
        return (self.ntrans + self.nbonds + self.nangles + self.ndihedrals
                + self.nother + self.nrotations)

    @property
    def natoms(self):
        return len(self.atoms)

    @property
    def ndummies(self):
        return len(self.dummies)

    @property
    def ndof(self):
        return 3 * (self.natoms + self.ndummies)

    def all_positions(self) -> np.ndarray:
        if self.ndummies:
            return np.vstack([self.atoms.positions,
                              self.dummies.positions])
        return self.atoms.positions

    # -- registration ---------------------------------------------------------
    def _get_ncvecs(self, indices, ncvecs, mic: bool) -> np.ndarray:
        """Resolve integer image vectors: explicit, zero, or
        minimum-image through the reduced basis (reference
        ``internal.py:2670-2691``)."""
        k = len(indices)
        if ncvecs is None:
            if not mic:
                return np.zeros((k - 1, 3), dtype=np.int64)
            from ..utils.lattice import mic_ncvec

            pos = self.all_positions()
            return np.array([
                mic_ncvec(pos[int(b)] - pos[int(a)], self.atoms.cell,
                          self.atoms.pbc)
                for a, b in zip(indices[:-1], indices[1:])
            ], dtype=np.int64)
        if mic:
            raise ValueError(
                "mic=True and explicit ncvecs are mutually exclusive"
            )
        return np.asarray(ncvecs, dtype=np.int64).reshape(k - 1, 3)

    def add_bond(self, indices, ncvec=None, mic: bool = False) -> None:
        i, j = int(indices[0]), int(indices[1])
        ncvec = self._get_ncvecs((i, j),
                                 None if ncvec is None else [ncvec],
                                 mic)[0]
        key = topo_mod._bond_key(i, j, np.asarray(ncvec))
        if key in self._bond_keys:
            raise DuplicateInternalError(f"bond {indices} exists")
        if key in self.forbidden["bonds"]:
            raise DuplicateInternalError(f"bond {indices} is forbidden")
        self._bond_keys.add(key)
        self.bonds.append((i, j, np.asarray(ncvec, dtype=np.int64)))
        self._engine = None

    def add_angle(self, indices, ncvecs=None, mic: bool = False) -> None:
        i, j, k = map(int, indices)
        ncvecs = self._get_ncvecs((i, j, k), ncvecs, mic)
        if topo_mod._angle_key(i, j, k, ncvecs) in self.forbidden["angles"]:
            raise DuplicateInternalError(f"angle {indices} is forbidden")
        self.angles.append((i, j, k, ncvecs))
        self._engine = None

    def add_dihedral(self, indices, ncvecs=None, mic: bool = False) -> None:
        i, j, k, l = map(int, indices)
        ncvecs = self._get_ncvecs((i, j, k, l), ncvecs, mic)
        if (topo_mod._dihedral_key(i, j, k, l, ncvecs)
                in self.forbidden["dihedrals"]):
            raise DuplicateInternalError(
                f"dihedral {indices} is forbidden"
            )
        self.dihedrals.append((i, j, k, l, ncvecs))
        self._engine = None

    # -- forbid API (reference ``internal.py:3190-3245``) ----------------------
    def forbid_bond(self, indices, ncvec=None, mic: bool = False) -> None:
        """Ban a bond from auto-discovery (and drop it if present)."""
        i, j = int(indices[0]), int(indices[1])
        ncvec = self._get_ncvecs((i, j),
                                 None if ncvec is None else [ncvec],
                                 mic)[0]
        key = topo_mod._bond_key(i, j, ncvec)
        self.forbidden["bonds"].add(key)
        if key in self._bond_keys:
            self._bond_keys.discard(key)
            self.bonds = [
                b for b in self.bonds
                if topo_mod._bond_key(b[0], b[1], b[2]) != key
            ]
            self._engine = None

    def forbid_angle(self, indices, ncvecs=None, mic: bool = False) -> None:
        i, j, k = map(int, indices)
        key = topo_mod._angle_key(
            i, j, k, self._get_ncvecs((i, j, k), ncvecs, mic)
        )
        self.forbidden["angles"].add(key)
        kept = [
            a for a in self.angles
            if topo_mod._angle_key(*a) != key
        ]
        if len(kept) != len(self.angles):
            self.angles = kept
            self._engine = None

    def forbid_dihedral(self, indices, ncvecs=None,
                        mic: bool = False) -> None:
        i, j, k, l = map(int, indices)
        key = topo_mod._dihedral_key(
            i, j, k, l, self._get_ncvecs((i, j, k, l), ncvecs, mic)
        )
        self.forbidden["dihedrals"].add(key)
        kept = [
            d for d in self.dihedrals
            if topo_mod._dihedral_key(*d) != key
        ]
        if len(kept) != len(self.dihedrals):
            self.dihedrals = kept
            self._engine = None

    def add_translation(self, indices, axis=None) -> None:
        indices = np.atleast_1d(np.asarray(indices, dtype=np.int64))
        if axis is None:
            for a in range(3):
                self.add_translation(indices, a)
            return
        self.trans.append(indices)
        self.trans_axes.append(int(axis))
        self._engine = None

    def add_user_coordinate(self, fn, indices) -> None:
        """Register a user-defined coordinate: ``fn(pos)`` is a pure torch
        scalar function of the gathered (k, 3) positions; derivatives
        come from ``torch.func`` (the reference's ``make_internal`` factory,
        ``internal.py:1181-1206``)."""
        indices = np.asarray(indices, dtype=np.int64)
        self.others.append((fn, indices))
        self._engine = None

    def add_displacement(self, indices=None, refpos=None, W=None) -> None:
        """Weighted squared displacement from a reference geometry
        (``internal.py:1081-1108``)."""
        if indices is None:
            indices = np.arange(self.natoms, dtype=np.int64)
        indices = np.asarray(indices, dtype=np.int64)
        if refpos is None:
            refpos = self.all_positions()[indices].copy()
        if W is None:
            W = np.eye(3 * len(indices))
        refpos_t = _t(refpos)
        W_t = _t(W)
        self.add_user_coordinate(
            lambda p: prim.displacement_value(
                p, refpos_t.to(p.device), W_t.to(p.device)), indices
        )

    def add_rotation(self, indices, axis=None, refpos=None) -> None:
        indices = np.asarray(indices, dtype=np.int64)
        if axis is None:
            for a in range(3):
                self.add_rotation(indices, a, refpos=refpos)
            return
        if refpos is None:
            refpos = self.all_positions()[indices].copy()
        self.rotations.append(
            (indices, int(axis), np.asarray(refpos, dtype=np.float64))
        )
        self._engine = None

    def rebase_cell(self, Minv: np.ndarray) -> None:
        """Remap integer cell-offset vectors after a lattice rebase
        ``new_cell = M @ old_cell`` with positions unchanged: every
        ncvec maps ``n -> n @ M^{-1}`` so each bonded displacement
        ``r_j - r_i + n @ cell`` — and hence every internal value,
        Jacobian and Hessian — is preserved exactly (the role ASE's
        Niggli remap plays for the reference, ``peswrapper.py:1521-1567``).
        """
        Minv = np.asarray(np.rint(Minv), dtype=np.int64)
        self.bonds = [(i, j, nc @ Minv) for i, j, nc in self.bonds]
        self.angles = [
            (a, j, b, ncs @ Minv) for a, j, b, ncs in self.angles
        ]
        self.dihedrals = [
            (i, j, k, l, ncs @ Minv)
            for i, j, k, l, ncs in self.dihedrals
        ]
        self._bond_keys = {
            topo_mod._bond_key(i, j, nc) for i, j, nc in self.bonds
        }
        self.forbidden = {
            "bonds": {
                topo_mod._bond_key(i, j, np.asarray(nc) @ Minv)
                for i, j, nc in self.forbidden["bonds"]
            },
            "angles": {
                topo_mod._angle_key(k[0], k[1], k[2],
                                    np.asarray(k[3:]) @ Minv)
                for k in self.forbidden["angles"]
            },
            "dihedrals": {
                topo_mod._dihedral_key(k[0], k[1], k[2], k[3],
                                       np.asarray(k[4:]) @ Minv)
                for k in self.forbidden["dihedrals"]
            },
        }
        if self.cons is not None:
            self.cons.rebase_cell(Minv)
        self._engine = None

    # -- topology auto-discovery ----------------------------------------------
    def find_all_bonds(self, scale: float = 1.25) -> None:
        t = topo_mod.find_bonds(
            self.atoms.numbers, self.atoms.positions, self.atoms.cell,
            self.atoms.pbc, scale=scale,
            allow_fragments=self.allow_fragments,
            existing=self.bonds,
        )
        for i, j, ncvec in t.bonds:
            try:
                self.add_bond((i, j), ncvec)
            except DuplicateInternalError:
                pass
        if self.allow_fragments and (t.fragments or t.lone_atoms):
            for i in t.lone_atoms:
                self.add_translation([i])
            for group in t.fragments:
                self.fragment_atom_groups.append(group)
                self.add_translation(group)
                if len(group) >= 2:
                    self.add_rotation(group)

    def find_all_angles(self, allow_dummies: bool = True) -> None:
        """Discover all bond-pair angles. ``allow_dummies=False`` skips
        the dummy-atom insertion at linear centers (reference
        ``internal.py:3482-3550``) — used by the batched tier's repave
        event, where the atom count is a static shape and a linear
        center must instead be covered by redundant coordinates."""
        t = topo_mod.Topology()
        t.bonds = self.bonds
        linear_centers = topo_mod.find_angles(
            t, self.all_positions(), self.atoms.cell, self.atol
        )
        # skip angles already present (e.g. merged constraint
        # coordinates — the reference's _internals_set check)
        have_a = {topo_mod._angle_key(*a) for a in self.angles}
        self.angles.extend(
            a for a in t.angles
            if topo_mod._angle_key(*a) not in self.forbidden["angles"]
            and topo_mod._angle_key(*a) not in have_a
        )
        # linear-angle improper replacements land in t.dihedrals
        have_d = {topo_mod._dihedral_key(*d) for d in self.dihedrals}
        self.dihedrals.extend(
            d for d in t.dihedrals
            if topo_mod._dihedral_key(*d) not in self.forbidden["dihedrals"]
            and topo_mod._dihedral_key(*d) not in have_d
        )
        if allow_dummies:
            for j, (a, nca), (b, ncb) in linear_centers:
                self._add_dummy_for_linear_center(j, a, nca, b, ncb)
        self._engine = None

    def _add_dummy_for_linear_center(self, j, a, nca, b, ncb) -> None:
        """Insert a dummy atom perpendicular to a 2-coordinate linear
        center so its bend is representable (``internal.py:3482-3550``):
        the dummy bond and one dummy angle are constrained; the improper
        dihedral a-j-dummy-b becomes the bending coordinate."""
        pos = self.all_positions()
        cell = self.atoms.cell
        if self.dinds[j] < 0:
            dx1 = pos[a] - pos[j] + nca @ cell
            dx1 = dx1 / np.linalg.norm(dx1)
            dx2 = pos[b] - pos[j] + ncb @ cell
            dx2 = dx2 / np.linalg.norm(dx2)
            dpos = np.cross(-dx1, dx2)
            nrm = np.linalg.norm(dpos)
            if nrm < 1e-4:
                # exactly collinear: basis vector most orthogonal to dx1
                dim = int(np.argmin(np.abs(dx1)))
                dpos = np.zeros(3)
                dpos[dim] = 1.0
                dpos -= dx1 * (dpos @ dx1)
                dpos /= np.linalg.norm(dpos)
            else:
                dpos = dpos / nrm
            dind = self.natoms + self.dummies.append(pos[j] + dpos)
            self.dinds[j] = dind
        dind = int(self.dinds[j])

        # constrained dummy bond + ONE dummy angle (two would
        # over-constrain, ``internal.py:3518-3527``)
        try:
            self.add_bond((j, dind))
        except DuplicateInternalError:
            pass
        self.cons.fix_bond((j, dind))
        self.cons.fix_angle((a, j, dind), ncvecs=np.vstack([-nca, [0, 0, 0]]))
        # bending DOF: improper dihedral a-j-dummy-b
        self.add_dihedral(
            (a, j, dind, b),
            ncvecs=np.vstack([-nca, [0, 0, 0], ncb]),
        )
        # angles through the dummy for every bond at j
        for (i2, j2, nc2) in self.bonds:
            if j2 == j and i2 != dind:
                other, nco = i2, -np.asarray(nc2)
            elif i2 == j and j2 != dind:
                other, nco = j2, np.asarray(nc2)
            else:
                continue
            tv1 = -nco @ cell
            ang = topo_mod._angle_of(
                self.all_positions(), other, j, dind, tv1, np.zeros(3)
            )
            if self.atol < ang < np.pi - self.atol:
                self.add_angle(
                    (other, j, dind), ncvecs=np.vstack([-nco, [0, 0, 0]])
                )

    def find_all_dihedrals(self) -> None:
        t = topo_mod.Topology()
        t.bonds = self.bonds
        t.angles = self.angles
        t.dihedrals = list(self.dihedrals)
        topo_mod.find_dihedrals(t)
        seen: set = set()
        out = []
        for d in t.dihedrals:
            k = topo_mod._dihedral_key(*d)
            if k in self.forbidden["dihedrals"] or k in seen:
                continue
            seen.add(k)
            out.append(d)
        self.dihedrals = out
        self._engine = None

    def validate_basis(self) -> None:
        """Warn when the coordinate set does not span the expected DOF
        (``internal.py:3673-3702``)."""
        jac = self.jacobian()
        s = np.linalg.svd(np.asarray(jac), compute_uv=False)
        ndeloc = int(np.sum(s > 1e-8))
        has_trics = bool(self.trans or self.rotations)
        n = self.natoms + self.ndummies
        if has_trics:
            ndof = 3 * n
        elif any(np.any(b[2] != 0) for b in self.bonds):
            ndof = 3 * n
        elif n <= 1:
            ndof = 0
        elif n == 2:
            ndof = 1
        else:
            ndof = 3 * n - 6
        if ndeloc != ndof:
            warnings.warn(f"{ndeloc} coords found! Expected {ndof}.")

    def check_for_bad_internals(self) -> Optional[dict]:
        """Angles that left the (atol, pi-atol) window
        (``internal.py:3704-3736``)."""
        if not self.angles:
            return None
        vals = self.calc()
        a0 = self.ntrans + self.nbonds
        angle_vals = vals[a0:a0 + self.nangles]
        bad_mask = ~(
            (self.atol < angle_vals) & (angle_vals < np.pi - self.atol)
        )
        if np.any(bad_mask):
            return {"angles": [self.angles[i] for i in np.where(bad_mask)[0]],
                    "bonds": []}
        return None

    def copy(self) -> "Internals":
        new = Internals(self.atoms, self.cons.copy(), self.allow_fragments)
        new.dummies.positions = self.dummies.positions.copy()
        new.cons.dummies = new.dummies
        new.dinds = self.dinds.copy()
        new.atol = self.atol
        new.trans = list(self.trans)
        new.trans_axes = list(self.trans_axes)
        new.bonds = list(self.bonds)
        new.angles = list(self.angles)
        new.dihedrals = list(self.dihedrals)
        new.rotations = list(self.rotations)
        new.others = list(self.others)
        new.fragment_atom_groups = list(self.fragment_atom_groups)
        new._bond_keys = set(self._bond_keys)
        new.forbidden = {g: set(s) for g, s in self.forbidden.items()}
        return new

    # -- evaluation engine -----------------------------------------------------
    def _get_engine(self):
        if self._engine is None:
            self._engine = _Engine(self)
        return self._engine

    def calc(self) -> np.ndarray:
        return self._get_engine().calc(
            _t(self.all_positions()), _t(self.atoms.cell)).numpy()

    def jacobian(self) -> np.ndarray:
        """B matrix, (nint, 3 natoms)."""
        return self._get_engine().jacobian(
            _t(self.all_positions()), _t(self.atoms.cell)).numpy()

    def hessian_rdot(self, v: np.ndarray) -> np.ndarray:
        """Directional curvature ``(dB/dx · v)``: rows are per-coordinate
        HVPs, shape (nint, 3 natoms) (``internal.py:2307-2575``)."""
        return self._get_engine().hessian_rdot(
            _t(self.all_positions()), _t(self.atoms.cell),
            _t(np.asarray(v).reshape(self.natoms + self.ndummies, 3)),
        ).numpy()

    def hessian_ldot(self, w: np.ndarray) -> np.ndarray:
        """``sum_k w_k Hess(q_k)``, shape (3n, 3n) — the curvature
        correction used in Hc and Hessian conversions
        (``linalg.py:601-618``)."""
        return self._get_engine().hessian_ldot(
            _t(self.all_positions()), _t(self.atoms.cell), _t(w)).numpy()

    def check_gradient(self, delta: float = 1e-6,
                       rtol: float = 1e-5) -> float:
        """FD self-check of the B matrix at the current geometry
        (the reference's per-coordinate ``check_gradient``,
        ``internal.py:289-305``). Returns the max abs error and raises
        ``AssertionError`` beyond ``rtol`` (relative to the largest
        Jacobian entry)."""
        B = self.jacobian()
        pos0 = self.all_positions().copy()
        n3 = pos0.size
        err = 0.0
        scale = max(np.abs(B).max(), 1.0)
        for k in range(n3):
            dp = np.zeros(n3)
            dp[k] = delta
            qp = self._calc_at(pos0 + dp.reshape(-1, 3))
            qm = self._calc_at(pos0 - dp.reshape(-1, 3))
            fd = self.wrap(qp - qm) / (2 * delta)
            err = max(err, float(np.abs(fd - B[:, k]).max()))
        assert err <= rtol * scale, (
            f"B-matrix FD error {err:.3e} > {rtol * scale:.3e}"
        )
        return err

    def check_hessian(self, delta: float = 1e-5,
                      rtol: float = 5e-4) -> float:
        """FD self-check of ``hessian_ldot`` against differentiated
        Jacobians (the reference's ``check_hessian``,
        ``internal.py:307-328``)."""
        rng = np.random.RandomState(0)
        w = rng.normal(size=self.nint)
        Hl = self.hessian_ldot(w)
        pos0 = self.all_positions().copy()
        n3 = pos0.size
        err = 0.0
        scale = max(np.abs(Hl).max(), 1.0)
        for k in range(n3):
            dp = np.zeros(n3)
            dp[k] = delta
            Bp = self._jac_at(pos0 + dp.reshape(-1, 3))
            Bm = self._jac_at(pos0 - dp.reshape(-1, 3))
            fd = w @ (Bp - Bm) / (2 * delta)
            err = max(err, float(np.abs(fd - Hl[:, k]).max()))
        assert err <= rtol * scale, (
            f"hessian_ldot FD error {err:.3e} > {rtol * scale:.3e}"
        )
        return err

    def _calc_at(self, pos: np.ndarray) -> np.ndarray:
        return self._get_engine().calc(_t(pos), _t(self.atoms.cell)).numpy()

    def _jac_at(self, pos: np.ndarray) -> np.ndarray:
        return self._get_engine().jacobian(
            _t(pos), _t(self.atoms.cell)).numpy()

    class _HessLdot:
        def __init__(self, inner):
            self.ldot = inner

    def hessian(self):
        """Adapter matching the reference's ``int.hessian().ldot(w)``."""
        return Internals._HessLdot(self.hessian_ldot)

    def cell_jacobian(self) -> np.ndarray:
        """dq/dcell at fixed positions, shape (nint, 3, 3) — the
        reference's cell-derivative closures (``internal.py:148-185``).
        Only coordinates with periodic images depend on the cell;
        translations/rotations/others are cell-independent."""
        return self._get_engine().cell_jacobian(
            _t(self.all_positions()), _t(self.atoms.cell)).numpy()

    def wrap(self, vec: np.ndarray) -> np.ndarray:
        """Wrap periodic components of a coordinate difference
        (``internal.py:2577-2627``): dihedrals to (-pi, pi]; rotation
        vectors by 2 pi about their own axis when the magnitude exceeds
        pi (v and v (1 - 2 pi/|v|) are the same rotation)."""
        out = np.asarray(vec, dtype=np.float64).copy()
        d0 = self.ntrans + self.nbonds + self.nangles
        d1 = d0 + self.ndihedrals
        out[d0:d1] = (out[d0:d1] + np.pi) % (2 * np.pi) - np.pi
        if self.nrotations:
            r0 = self.nint - self.nrotations
            # a 2 pi wrap needs the full rotation VECTOR: only complete
            # same-fragment axis triples are wrapped; an isolated
            # single-axis registration (add_rotation(idx, axis=1)) has
            # no well-defined scalar period and is left untouched
            for k in self._rotation_triples():
                v = out[r0 + k:r0 + k + 3]
                nrm = np.linalg.norm(v)
                while nrm > np.pi:
                    v -= 2 * np.pi * v / nrm
                    nrm = np.linalg.norm(v)
                out[r0 + k:r0 + k + 3] = v
        return out

    def _rotation_triples(self) -> list:
        """Offsets (within the rotation block) of complete axis triples
        (0, 1, 2) registered for one fragment."""
        trips = []
        rots = self.rotations
        k = 0
        while k < len(rots):
            if k + 2 < len(rots):
                (i0, a0, _), (i1, a1, _), (i2, a2, _) = rots[k:k + 3]
                if ((a0, a1, a2) == (0, 1, 2)
                        and np.array_equal(i0, i1)
                        and np.array_equal(i0, i2)):
                    trips.append(k)
                    k += 3
                    continue
            k += 1
        return trips

    # -- Lindh-style diagonal guess Hessian -------------------------------------
    def guess_hessian(self, h0cart: float = 70.0) -> np.ndarray:
        """(``internal.py:3738-3820``)"""
        # dummies enter as element 'X' (Z=0, rcov 0.2) like the
        # reference's all_atoms (``internal.py:3744-3747``)
        Z = np.concatenate(
            [self.atoms.numbers,
             np.zeros(self.ndummies, dtype=self.atoms.numbers.dtype)]
        )
        pos = self.all_positions()
        cell = self.atoms.cell
        vals = self.calc()
        h0 = np.zeros(self.nint)
        h0_tr = 0.05 * units.Hartree
        nbonds_per_atom = np.zeros(self.natoms + self.ndummies,
                                   dtype=np.int64)
        for i, j, _ in self.bonds:
            nbonds_per_atom[i] += 1
            nbonds_per_atom[j] += 1

        idx = 0
        for _ in self.trans:
            h0[idx] = h0_tr if self.allow_fragments else h0cart
            idx += 1
        b0 = idx
        for n, (i, j, ncvec) in enumerate(self.bonds):
            rcov = covalent_radii[Z[i]] + covalent_radii[Z[j]]
            rij = vals[b0 + n]
            h0[idx] = (
                0.3601 * np.exp(-1.944 * (rij - rcov) / units.Bohr)
                * units.Hartree / units.Bohr**2
            )
            idx += 1
        for (a, j, b, ncvs) in self.angles:
            rcovaj = covalent_radii[Z[a]] + covalent_radii[Z[j]]
            rcovjb = covalent_radii[Z[j]] + covalent_radii[Z[b]]
            raj = np.linalg.norm(pos[j] - pos[a] + ncvs[0] @ cell)
            rjb = np.linalg.norm(pos[b] - pos[j] + ncvs[1] @ cell)
            h0[idx] = (
                0.089 + 0.11 * np.exp(
                    -0.44 * (raj + rjb - rcovaj - rcovjb) / units.Bohr
                ) / (rcovaj * rcovjb / units.Bohr**2) ** (-0.42)
            ) * units.Hartree
            idx += 1
        dummy_set = set(range(self.natoms, self.natoms + self.ndummies))
        for (i, j, k, l, ncvs) in self.dihedrals:
            if any(int(q) in dummy_set for q in (i, j, k, l)):
                h0[idx] = 0.5 * units.Hartree
                idx += 1
                continue
            rcovjk = covalent_radii[Z[j]] + covalent_radii[Z[k]]
            rjk = np.linalg.norm(pos[k] - pos[j] + ncvs[1] @ cell)
            L = nbonds_per_atom[j] + nbonds_per_atom[k] - 2
            L = max(L, 0)
            h0[idx] = (
                0.0015 + 14.0 * max(L, 1) ** 0.57 * np.exp(
                    -2.85 * (rjk - rcovjk) / units.Bohr
                ) / (rjk * rcovjk / units.Bohr**2) ** 4.00
            ) * units.Hartree
            idx += 1
        for _ in self.others:
            h0[idx] = h0cart
            idx += 1
        for _ in self.rotations:
            h0[idx] = h0_tr if self.allow_fragments else h0cart
            idx += 1
        return np.diag(np.abs(h0))


def _per_lane(fn, *arrays):
    """``fn`` of one geometry's ``(n, 3)`` arrays, over any leading dims
    (vmap over the flattened lanes; a plain call for one geometry)."""
    if arrays[0].ndim == 2:
        return fn(*arrays)
    lead = arrays[0].shape[:-2]
    out = vmap(fn)(*(a.reshape((-1,) + a.shape[-2:]) for a in arrays))
    return out.reshape(lead + out.shape[1:])


class _Engine:
    """Evaluation engine for one topology: torch functions of positions
    ``pos (..., n, 3)`` (one geometry or a batch of lanes) and a cell
    ``(3, 3)``, which compose with ``torch.func``.

    Bonds, angles and dihedrals are evaluated per kind in one batched
    call with analytic gradients (:mod:`.primitives` ``*_value`` /
    ``*_grads``); their curvature rows are the directional derivatives
    of those gradients (:func:`.primitives.grad_and_jvp`). Rotations are
    evaluated once per fragment for all three axes, batched over lanes
    (:func:`.primitives.rotation_jacobians`); user coordinates go per
    lane through ``vmap``. Rows are placed by one-hot matmuls (the
    ``(3n, 3n)`` curvature sum by an out-of-place ``index_add``). The
    host index arrays are copied to a device once per device
    (:meth:`_on`)."""

    def __init__(self, ints: Internals) -> None:
        self.n = ints.natoms + ints.ndummies
        kinds = []
        for name, recs, arity in (("bond", ints.bonds, 2),
                                  ("angle", ints.angles, 3),
                                  ("dihedral", ints.dihedrals, 4)):
            if not recs:
                continue
            idx = np.array([r[:arity] for r in recs], dtype=np.int64)
            ncv = np.array([np.asarray(r[arity], dtype=np.float64)
                            .reshape(arity - 1, 3) for r in recs])
            kinds.append((name, idx, ncv))
        self.kinds = kinds
        self.nb = len(ints.bonds)
        self.na = len(ints.angles)
        self.nd = len(ints.dihedrals)
        self.trans = [(np.asarray(idx, dtype=np.int64), int(ax))
                      for idx, ax in zip(ints.trans, ints.trans_axes)]
        # rotation entries grouped by fragment (same atoms, same
        # reference): one evaluation serves all three axes
        self.rot_groups, self.rot_entries, keys = [], [], {}
        for idx, ax, ref in ints.rotations:
            idx = np.asarray(idx, dtype=np.int64)
            ref = np.asarray(ref, dtype=np.float64)
            key = (idx.tobytes(), ref.tobytes())
            if key not in keys:
                keys[key] = len(self.rot_groups)
                self.rot_groups.append((idx, ref))
            self.rot_entries.append((keys[key], int(ax)))
        self.others = [(fn, np.asarray(idx, dtype=np.int64))
                       for fn, idx in ints.others]
        self.counts = (len(self.trans), self.nb, self.na, self.nd,
                       len(self.others), len(self.rot_entries))
        self._dev = {}

    def _on(self, dev):
        """The index tensors on ``dev`` (built once per device)."""
        key = torch.device(dev)
        if key not in self._dev:
            n = self.n
            i64 = dict(dtype=torch.int64, device=key)
            f64 = dict(dtype=torch.float64, device=key)
            kinds = []
            for name, idx, ncv in self.kinds:
                nk, arity = idx.shape
                # (nk, n, arity) one-hot placing each coordinate's atoms:
                # rows of B are one batched matmul, deterministic on the
                # card (an index_add there sums in atomic order)
                onehot = np.zeros((nk, n, arity))
                onehot[np.arange(nk)[:, None], idx, np.arange(arity)] = 1.0
                # flat DOF index of every (coordinate, atom, axis) entry
                # of a (3n, 3n) matrix
                dof = (3 * idx[:, :, None] + np.arange(3)).reshape(nk, -1)
                mat = (dof[:, :, None] * 3 * n + dof[:, None, :]).reshape(-1)
                kinds.append((name, torch.as_tensor(idx, **i64),
                              torch.as_tensor(ncv, **f64),
                              torch.as_tensor(onehot, **f64),
                              torch.as_tensor(mat, **i64)))
            trans_rows = np.zeros((len(self.trans), n, 3))
            for k, (idx, ax) in enumerate(self.trans):
                trans_rows[k, idx, ax] = 1.0 / idx.shape[0]
            self._dev[key] = dict(
                kinds=kinds,
                trans=[(torch.as_tensor(idx, **i64), ax)
                       for idx, ax in self.trans],
                trans_rows=torch.as_tensor(
                    trans_rows.reshape(len(self.trans), 3 * n), **f64),
                rots=[(torch.as_tensor(idx, **i64),
                       torch.as_tensor(ref, **f64), self._dofs(idx, key))
                      for idx, ref in self.rot_groups],
                others=[(fn, torch.as_tensor(idx, **i64),
                         self._dofs(idx, key))
                        for fn, idx in self.others],
            )
        return self._dev[key]

    def _dofs(self, idx: np.ndarray, dev):
        """(the (n, m) one-hot of an index set, the flat indices of its
        (3n, 3n) block)."""
        n = self.n
        onehot = np.zeros((n, len(idx)))
        onehot[idx, np.arange(len(idx))] = 1.0
        dof = (3 * idx[:, None] + np.arange(3)).reshape(-1)
        mat = (dof[:, None] * 3 * n + dof[None, :]).reshape(-1)
        return (torch.as_tensor(onehot, dtype=torch.float64, device=dev),
                torch.as_tensor(mat, dtype=torch.int64, device=dev))

    @staticmethod
    def _place(onehot, vals):
        """Rows of the full DOF space from per-atom blocks: ``vals``
        (..., [nk,] m, 3) placed by ``onehot`` ([nk,] n, m) and flattened
        to (..., [nk,] 3n)."""
        out = onehot.to(vals.dtype) @ vals
        return out.reshape(out.shape[:-2] + (-1,))

    @staticmethod
    def _offsets(ncv, cell):
        """Cartesian image offsets (nk, k-1, 3) of integer ``ncv``."""
        return ncv.to(cell.dtype) @ cell

    # batched per-kind evaluations -------------------------------------------
    def _calc_impl(self, pos, cell):
        d = self._on(pos.device)
        lead = pos.shape[:-2]
        parts = []
        for idx, ax in d["trans"]:
            parts.append(torch.mean(pos[..., idx, ax], dim=-1)[..., None])
        for name, idx, ncv, _, _ in d["kinds"]:
            parts.append(prim.KIND_VALUES[name](pos[..., idx, :],
                                                self._offsets(ncv, cell)))
        for fn, idx, _ in d["others"]:
            parts.append(_per_lane(lambda p, fn=fn, idx=idx: fn(p[idx]),
                                   pos)[..., None])
        vals = [prim.rotation_value(pos[..., idx, :], ref)
                for idx, ref, _ in d["rots"]]
        for g, ax in self.rot_entries:
            parts.append(vals[g][..., ax:ax + 1])
        if not parts:
            return torch.zeros(lead + (0,), dtype=pos.dtype,
                               device=pos.device)
        return torch.cat(parts, dim=-1)

    def _jac_impl(self, pos, cell):
        d = self._on(pos.device)
        lead = pos.shape[:-2]
        n3 = 3 * self.n
        rows = self._trans_rows(d, pos, lead)
        for name, idx, ncv, onehot, _ in d["kinds"]:
            g = prim.KIND_GRADS[name](pos[..., idx, :],
                                      self._offsets(ncv, cell))
            rows.append(self._place(onehot, g))
        rows += self._extra_jac_rows(d, pos)
        if not rows:
            return torch.zeros(lead + (0, n3), dtype=pos.dtype,
                               device=pos.device)
        return torch.cat(rows, dim=-2)

    @staticmethod
    def _trans_rows(d, pos, lead):
        if not len(d["trans"]):
            return []
        tr = d["trans_rows"].to(pos.dtype)
        return [tr.expand(lead + tr.shape)]

    def _extra_jac_rows(self, d, pos):
        """B rows of the user coordinates and rotations."""
        rows = []
        for fn, idx, (onehot, _) in d["others"]:
            g = _per_lane(lambda p, fn=fn, idx=idx: grad(fn)(p[idx]), pos)
            rows.append(self._place(onehot, g)[..., None, :])
        jacs = [prim.rotation_jacobians(pos[..., idx, :], ref)
                for idx, ref, _ in d["rots"]]
        for g, ax in self.rot_entries:
            onehot = d["rots"][g][2][0]
            rows.append(self._place(onehot, jacs[g][..., ax, :, :])
                        [..., None, :])
        return rows

    def _hrdot_impl(self, pos, cell, v):
        """Rows: jvp of each coordinate's gradient along v."""
        return self._jac_hrdot_impl(pos, cell, v, with_jac=False)[1]

    def _jac_hrdot_impl(self, pos, cell, v, with_jac: bool = True):
        """``(B, dB[v])``: the Jacobian rows and their directional
        derivatives along v; bonds, angles and dihedrals give both from
        one dual-number pass (``B`` is None unless ``with_jac``)."""
        d = self._on(pos.device)
        lead = pos.shape[:-2]
        n3 = 3 * self.n
        rows, jrows = [], self._trans_rows(d, pos, lead)
        if len(d["trans"]):
            rows.append(torch.zeros(lead + (len(d["trans"]), n3),
                                    dtype=pos.dtype, device=pos.device))
        for name, idx, ncv, onehot, _ in d["kinds"]:
            g, hv = prim.grad_and_jvp(name, pos[..., idx, :],
                                      self._offsets(ncv, cell),
                                      v[..., idx, :])
            rows.append(self._place(onehot, hv))
            jrows.append(self._place(onehot, g))
        jrows = jrows + self._extra_jac_rows(d, pos) if with_jac else None
        for fn, idx, (onehot, _) in d["others"]:
            hv = _per_lane(lambda p, vv, fn=fn, idx=idx: jvp(
                grad(fn), (p[idx],), (vv[idx],))[1], pos, v)
            rows.append(self._place(onehot, hv)[..., None, :])
        hvs = [prim.rotation_jacobians_jvp(pos[..., idx, :], ref,
                                           v[..., idx, :])
               for idx, ref, _ in d["rots"]]
        for g, ax in self.rot_entries:
            onehot = d["rots"][g][2][0]
            rows.append(self._place(onehot, hvs[g][..., ax, :, :])
                        [..., None, :])
        if not rows:
            empty = torch.zeros(lead + (0, n3), dtype=pos.dtype,
                                device=pos.device)
            return (empty if with_jac else None), empty
        return (None if jrows is None else torch.cat(jrows, dim=-2),
                torch.cat(rows, dim=-2))

    def _hldot_impl(self, pos, cell, w):
        """sum_k w_k Hess(q_k) of one geometry: per-kind dense small
        Hessians (forward-mode derivatives of the analytic gradients),
        scatter-added into (3n, 3n) (linear in the coordinate count)."""
        d = self._on(pos.device)
        n3 = 3 * self.n
        H = torch.zeros(n3 * n3, dtype=pos.dtype, device=pos.device)
        off = len(d["trans"])
        for name, idx, ncv, _, mat in d["kinds"]:
            nk = idx.shape[0]
            hess = vmap(jacfwd(prim.KIND_GRADS[name]))(
                pos[idx], self._offsets(ncv, cell))
            hw = hess * w[off:off + nk][:, None, None, None, None]
            H = H.index_add(0, mat, hw.reshape(-1))
            off += nk
        for fn, idx, (_, mat) in d["others"]:
            H = H.index_add(0, mat, (w[off] * hessian(fn)(pos[idx]))
                            .reshape(-1))
            off += 1
        hess = [prim.rotation_hess(pos[idx], ref)       # (3, m, 3, m, 3)
                for idx, ref, _ in d["rots"]]
        for g, ax in self.rot_entries:
            mat = d["rots"][g][2][1]
            H = H.index_add(0, mat, (w[off] * hess[g][ax]).reshape(-1))
            off += 1
        return H.reshape(n3, n3)

    # public entry points
    def calc(self, pos, cell):
        return self._calc_impl(pos, cell)

    def cell_jacobian(self, pos, cell):
        return jacfwd(self._calc_impl, argnums=1)(pos, cell)

    def jacobian(self, pos, cell):
        return self._jac_impl(pos, cell)

    def hessian_rdot(self, pos, cell, v):
        return self._hrdot_impl(pos, cell, v)

    def hessian_ldot(self, pos, cell, w):
        return self._hldot_impl(pos, cell, w)
