"""Constraint container (coordinate layer, C9 subset).

Sequential-API equivalent of the reference ``Constraints``
(``sella/internal.py:2748-3030`` of the upstream Sella): equality and
inequality (lt/gt) constraints on translations, bonds, angles, dihedrals,
arbitrary coordinates, and rigid rotations, with the same evaluation
order (translations, bonds, angles, dihedrals, other, rotations) and the
same conventions:

* rotation constraints have target 0 and, with ``ignore_rotation=True``
  (default), contribute only their Jacobian rows (residual forced to 0) —
  they are projections, not holonomic constraints
  (``internal.py:2781-2786``);
* dihedral residuals are wrapped to (-pi, pi];
* fixed atoms / Cartesian DOF are single-atom translation coordinates
  (``internal.py:2981-3011``).

Counterpart of ``sella_tpu/coords/constraints.py``: host code whose
values and derivatives come from the torch primitives of
:mod:`sella_tpu_torch.coords.primitives`, evaluated on CPU float64
tensors (numpy in, numpy out). A user coordinate (``fix_other``) is a
torch function of the gathered ``(k, 3)`` positions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch.func import grad, hessian

from ..atoms import Atoms
from . import primitives as prim


class DuplicateInternalError(ValueError):
    pass


class DuplicateConstraintError(DuplicateInternalError):
    pass


_KIND_NBODY = {"bond": 2, "angle": 3, "dihedral": 4}
_VALUE_FNS = {
    "bond": prim.bond_value,
    "angle": prim.angle_value,
    "dihedral": prim.dihedral_value,
}

# evaluation-order of constraint groups (matches the reference's _names
# ordering used by e.g. the MaxInternalStep weights,
# ``sella/optimize/restricted_step.py:230-241`` upstream)
GROUPS = ("translations", "bonds", "angles", "dihedrals", "other",
          "rotations")


@dataclass
class Record:
    kind: str                      # bond|angle|dihedral|translation|rotation|other
    indices: np.ndarray            # atom indices involved
    target: float = 0.0
    comparator: str = "eq"         # eq | lt | gt
    active: bool = True
    axis: int = 0                  # translation dim / rotation axis
    ncvecs: Optional[np.ndarray] = None     # (k-1, 3) integer cell offsets
    ref: Optional[np.ndarray] = None        # rotation reference positions
    fn: object = None               # custom coordinate fn for 'other'

    def same_coord(self, other: "Record") -> bool:
        return (
            self.kind == other.kind
            and self.axis == other.axis
            and self.fn is other.fn
            and len(self.indices) == len(other.indices)
            and bool(np.all(self.indices == other.indices))
        )


def _t(a) -> torch.Tensor:
    """A host float64 tensor of ``a``."""
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _tvec(rec: Record, cell: np.ndarray) -> torch.Tensor:
    k = _KIND_NBODY[rec.kind]
    if rec.ncvecs is None:
        return torch.zeros((k - 1, 3), dtype=torch.float64)
    return _t(np.asarray(rec.ncvecs) @ np.asarray(cell))


class DummyStore:
    """Mutable positions of dummy atoms, shared between Internals and
    Constraints (the reference threads a dummies Atoms object through
    both, ``internal.py:2748-2756``)."""

    def __init__(self) -> None:
        self.positions = np.zeros((0, 3))

    def __len__(self) -> int:
        return len(self.positions)

    def append(self, pos) -> int:
        self.positions = np.vstack([self.positions, np.asarray(pos)])
        return len(self.positions) - 1

    def copy(self) -> "DummyStore":
        new = DummyStore()
        new.positions = self.positions.copy()
        return new


class Constraints:
    """Holds constraint records and evaluates residual/Jacobian/Hessian.

    Coordinate indices >= len(atoms) refer to dummy atoms in the shared
    :class:`DummyStore` (used by the internal-coordinate machinery for
    linear centers)."""

    def __init__(self, atoms: Atoms, ignore_rotation: bool = True,
                 dummies: Optional[DummyStore] = None) -> None:
        self.atoms = atoms
        self.ignore_rotation = ignore_rotation
        self.dummies = dummies if dummies is not None else DummyStore()
        self.records: dict = {g: [] for g in GROUPS}
        # ingest ASE constraints carried over by atoms.from_ase
        # (``internal.py:2760-2761``)
        for c in getattr(atoms, "info", {}).get("ase_constraints", []):
            self.merge_ase_constraint(c)

    def _all_positions(self) -> np.ndarray:
        if len(self.dummies):
            return np.vstack([self.atoms.positions,
                              self.dummies.positions])
        return self.atoms.positions

    @property
    def _ntotal(self) -> int:
        return len(self.atoms) + len(self.dummies)

    # -- registration --------------------------------------------------------
    def _add(self, group: str, rec: Record, replace_ok: bool = True) -> None:
        for existing in self.records[group]:
            if existing.same_coord(rec):
                if replace_ok and group != "rotations":
                    existing.target = rec.target
                    existing.comparator = rec.comparator
                    return
                raise DuplicateConstraintError(
                    f"{rec.kind} constraint on {rec.indices} already exists"
                )
        self.records[group].append(rec)

    def fix_translation(
        self,
        index: Union[None, int, Sequence[int]] = None,
        dim: Optional[int] = None,
        target: Optional[float] = None,
    ) -> None:
        """Fix the mean position of a set of atoms (or one atom) along an
        axis; no dim means all three (``internal.py:2861-2904``)."""
        if index is None:
            index = np.arange(len(self.atoms), dtype=np.int32)
        index = np.atleast_1d(np.asarray(index, dtype=np.int32))
        if dim is None:
            if target is not None:
                raise ValueError('"target" requires explicit "dim"')
            for d in range(3):
                self.fix_translation(index, dim=d)
            return
        if target is None:
            target = float(np.mean(self._all_positions()[index, dim]))
        rec = Record("translation", index, target=target, axis=dim)
        self._add("translations", rec)

    def fix_rotation(
        self,
        indices: Optional[Sequence[int]] = None,
        axis: Optional[int] = None,
    ) -> None:
        if indices is None:
            indices = np.arange(len(self.atoms), dtype=np.int32)
        indices = np.asarray(indices, dtype=np.int32)
        if axis is None:
            for a in range(3):
                self.fix_rotation(indices, a)
            return
        rec = Record(
            "rotation",
            indices,
            target=0.0,
            axis=axis,
            ref=self._all_positions()[indices].copy(),
        )
        self._add("rotations", rec, replace_ok=False)

    def fix_atom(self, index: int) -> None:
        self.fix_translation(index)

    def fix_cartesian(self, index: int, dims: Sequence[int] = (0, 1, 2)):
        for d in dims:
            self.fix_translation(index, dim=d)

    def _fix_internal(self, kind, group, conv, indices, target=None,
                      comparator="eq", ncvecs=None):
        indices = np.asarray(indices, dtype=np.int32)
        rec = Record(kind, indices, comparator=comparator, ncvecs=ncvecs)
        if target is None:
            target = self._value_of(rec)
        else:
            target = target * conv
        rec.target = float(target)
        self._add(group, rec)

    def fix_bond(self, indices, target=None, comparator="eq", ncvecs=None):
        self._fix_internal("bond", "bonds", 1.0, indices, target,
                           comparator, ncvecs)

    def fix_angle(self, indices, target=None, comparator="eq", ncvecs=None):
        self._fix_internal("angle", "angles", np.pi / 180.0, indices,
                           target, comparator, ncvecs)

    def fix_dihedral(self, indices, target=None, comparator="eq",
                     ncvecs=None):
        self._fix_internal("dihedral", "dihedrals", np.pi / 180.0, indices,
                           target, comparator, ncvecs)

    def fix_other(self, fn, indices, target=None, comparator="eq"):
        """Constrain a user-defined coordinate (reference ``fix_other``,
        ``internal.py:2955-2979``): ``fn(pos)`` is a pure torch scalar
        function of the gathered ``(k, 3)`` positions; the constraint
        Jacobian and curvature come from ``torch.func``. Supports eq/lt/gt
        comparators like every other constraint kind."""
        indices = np.asarray(indices, dtype=np.int32)
        rec = Record("other", indices, comparator=comparator, fn=fn)
        if target is None:
            target = self._value_of(rec)
        rec.target = float(target)
        self._add("other", rec)

    @property
    def targets(self) -> np.ndarray:
        """Constraint target values, active rows only (reference
        ``internal.py:2775-2779``)."""
        return np.array([r.target for r in self._iter_records()])

    def rebase_cell(self, Minv: np.ndarray) -> None:
        """Remap record ncvecs after ``new_cell = M @ old_cell`` (see
        ``Internals.rebase_cell``)."""
        Minv = np.asarray(np.rint(Minv), dtype=np.int64)
        for rec in self._iter_records(only_active=False):
            if rec.ncvecs is not None:
                rec.ncvecs = np.asarray(rec.ncvecs) @ Minv

    # -- bookkeeping ---------------------------------------------------------
    def _iter_records(self, only_active: bool = True):
        for g in GROUPS:
            for rec in self.records[g]:
                if rec.active or not only_active:
                    yield rec

    @property
    def ncons(self) -> int:
        return sum(1 for _ in self._iter_records())

    def has_inequalities(self) -> bool:
        return any(
            rec.comparator in ("lt", "gt")
            for rec in self._iter_records(only_active=False)
        )

    def disable_satisfied_inequalities(self) -> None:
        """(``internal.py:2796-2807``)"""
        for rec in self._iter_records(only_active=False):
            val = self._value_of(rec)
            if rec.comparator == "lt" and val <= rec.target:
                rec.active = False
            elif rec.comparator == "gt" and val >= rec.target:
                rec.active = False
            else:
                rec.active = True

    def validate_inequalities(self) -> bool:
        """Re-activate violated inactive inequalities
        (``internal.py:2809-2823``)."""
        all_valid = True
        for rec in self._iter_records(only_active=False):
            if rec.active:
                continue
            val = self._value_of(rec)
            if rec.comparator == "lt" and val > rec.target:
                rec.active = True
                all_valid = False
            elif rec.comparator == "gt" and val < rec.target:
                rec.active = True
                all_valid = False
        return all_valid

    # -- evaluation ----------------------------------------------------------
    def _value_of(self, rec: Record) -> float:
        pos = self._all_positions()
        cell = self.atoms.cell
        if rec.kind == "translation":
            return float(np.mean(pos[rec.indices, rec.axis]))
        if rec.kind == "rotation":
            v = prim.rotation_value(_t(pos[rec.indices]), _t(rec.ref))
            return float(v[rec.axis])
        if rec.kind == "other":
            return float(rec.fn(_t(pos[rec.indices])))
        fn = _VALUE_FNS[rec.kind]
        return float(fn(_t(pos[rec.indices]), _tvec(rec, cell)))

    def calc(self) -> np.ndarray:
        return np.array([self._value_of(r) for r in self._iter_records()])

    def wrap(self, vec: np.ndarray) -> np.ndarray:
        """Wrap dihedral residual components into (-pi, pi]."""
        out = np.asarray(vec, dtype=np.float64).copy()
        for i, rec in enumerate(self._iter_records()):
            if rec.kind == "dihedral":
                out[i] = (out[i] + np.pi) % (2 * np.pi) - np.pi
        return out

    def residual(self) -> np.ndarray:
        """Constraint residual; rotation rows zeroed when
        ``ignore_rotation`` (``internal.py:2781-2786``)."""
        if self.ncons == 0:
            return np.zeros(0)
        targets = np.array([r.target for r in self._iter_records()])
        res = self.wrap(self.calc() - targets)
        if self.ignore_rotation:
            for i, rec in enumerate(self._iter_records()):
                if rec.kind == "rotation":
                    res[i] = 0.0
        return res

    def jacobian(self) -> np.ndarray:
        """(ncons, 3n_total) constraint Jacobian drdx (n_total includes
        dummies)."""
        n = self._ntotal
        pos = self._all_positions()
        cell = self.atoms.cell
        rows = []
        for rec in self._iter_records():
            row = np.zeros((n, 3))
            if rec.kind == "translation":
                row[rec.indices, rec.axis] = 1.0 / len(rec.indices)
            elif rec.kind == "rotation":
                J = prim.rotation_jac(_t(pos[rec.indices]), _t(rec.ref))
                row[rec.indices] = J[rec.axis].numpy()
            elif rec.kind == "other":
                g = grad(rec.fn)(_t(pos[rec.indices]))
                row[rec.indices] = g.numpy()
            else:
                gfn = {
                    "bond": prim.bond_grad,
                    "angle": prim.angle_grad,
                    "dihedral": prim.dihedral_grad,
                }[rec.kind]
                g = gfn(_t(pos[rec.indices]), _tvec(rec, cell))
                row[rec.indices] = g.numpy()
            rows.append(row.ravel())
        if not rows:
            return np.zeros((0, 3 * n))
        return np.stack(rows, axis=0)

    def hessian_ldot(self, L: np.ndarray) -> np.ndarray:
        """``Hc = sum_k L_k hess_k`` — the constraint curvature entering
        the Hessian of the Lagrangian (``peswrapper.py:349-361``)."""
        n = self._ntotal
        pos = self._all_positions()
        cell = self.atoms.cell
        Hc = np.zeros((3 * n, 3 * n))
        for lk, rec in zip(np.asarray(L), self._iter_records()):
            # exactly-zero multipliers contribute nothing (translations
            # are linear: identically zero curvature). Rotation second
            # derivatives are safe at degenerate (symmetric-fragment)
            # Kearsley spectra via the closed-form resolvent rule in
            # primitives._dq_jvp — no |L| threshold needed.
            if lk == 0.0 or rec.kind == "translation":
                continue
            if rec.kind == "rotation":
                H = prim.rotation_hess(
                    _t(pos[rec.indices]), _t(rec.ref)
                )[rec.axis].numpy()
            elif rec.kind == "other":
                H = hessian(rec.fn)(_t(pos[rec.indices])).numpy()
            else:
                hfn = {
                    "bond": prim.bond_hess,
                    "angle": prim.angle_hess,
                    "dihedral": prim.dihedral_hess,
                }[rec.kind]
                H = hfn(_t(pos[rec.indices]), _tvec(rec, cell)).numpy()
            k = len(rec.indices)
            H = H.reshape(k, 3, k, 3)
            idx = rec.indices
            for a in range(k):
                for b in range(k):
                    Hc[3 * idx[a]:3 * idx[a] + 3, 3 * idx[b]:3 * idx[b] + 3] += (
                        lk * H[a, :, b, :]
                    )
        return Hc

    def merge_ase_constraint(self, ase_cons) -> None:
        """Ingest an ASE constraint object (``internal.py:2981-3030``).

        Duck-typed on the class name so ASE stays an optional
        dependency: FixAtoms, FixCom, FixBondLengths, FixCartesian and
        FixInternals are mapped onto the native fix_* API.
        """
        name = type(ase_cons).__name__
        if name == "FixAtoms":
            for index in ase_cons.index:
                try:
                    self.fix_translation(int(index))
                except DuplicateConstraintError:
                    pass
        elif name == "FixCom":
            try:
                self.fix_translation()
            except DuplicateConstraintError:
                pass
        elif name == "FixBondLengths":
            lengths = getattr(ase_cons, "bondlengths", None)
            for i, pair in enumerate(ase_cons.pairs):
                target = None if lengths is None else lengths[i]
                try:
                    self.fix_bond(tuple(pair), target=target)
                except DuplicateConstraintError:
                    pass
        elif name == "FixCartesian":
            for dim, relaxed in enumerate(ase_cons.mask):
                if relaxed:
                    continue
                try:
                    self.fix_translation(int(ase_cons.a), dim=dim)
                except DuplicateConstraintError:
                    pass
        elif name == "FixInternals":
            for lst, adder in (
                (getattr(ase_cons, "bonds", []), self.fix_bond),
                (getattr(ase_cons, "angles", []), self.fix_angle),
                (getattr(ase_cons, "dihedrals", []), self.fix_dihedral),
            ):
                for target, indices in lst or []:
                    try:
                        adder(indices, target=target)
                    except DuplicateInternalError:
                        pass
            if getattr(ase_cons, "bondcombos", None):
                raise RuntimeError(
                    "Combination constraints are not supported."
                )
        else:
            raise RuntimeError(
                f"ASE constraint class {name} is not supported."
            )

    def copy(self) -> "Constraints":
        import copy as _copy

        new = Constraints(self.atoms, self.ignore_rotation,
                          dummies=self.dummies)
        new.records = {
            g: [_copy.deepcopy(r) for r in self.records[g]] for g in GROUPS
        }
        return new
