"""Standalone Atoms container.

The reference is built on ``ase.Atoms``; this framework is self-contained,
so it ships a minimal structure container with the same essential surface
(positions / numbers / cell / pbc / masses / attached calculator,
`get_potential_energy`, `get_forces`). An adapter accepts real ASE Atoms
when ASE happens to be installed (:func:`from_ase`).

Unlike ASE, construction is cheap by design — the reference needed a
``LightAtoms`` shim to avoid Atoms.__init__ overhead
(``sella/internal.py:41-47``); here the container itself is
light and all hot-path code operates on raw arrays anyway.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from .utils.elements import atomic_masses, chemical_symbols, symbol_to_number


def _parse_symbols(symbols) -> np.ndarray:
    """Convert a symbols spec (list of str/int, or formula-free string) to Z."""
    if isinstance(symbols, str):
        # Parse simple formula strings like "H2O" or "Xe4".
        out = []
        i = 0
        while i < len(symbols):
            j = i + 1
            if j < len(symbols) and symbols[j].islower():
                j += 1
            sym = symbols[i:j]
            k = j
            while k < len(symbols) and symbols[k].isdigit():
                k += 1
            count = int(symbols[j:k]) if k > j else 1
            out.extend([symbol_to_number[sym]] * count)
            i = k
        return np.array(out, dtype=np.int32)
    arr = []
    for s in symbols:
        if isinstance(s, str):
            arr.append(symbol_to_number[s])
        else:
            arr.append(int(s))
    return np.array(arr, dtype=np.int32)


class Atoms:
    """Minimal atomic-structure container.

    Parameters
    ----------
    symbols : str | sequence of str/int
        Chemical symbols ("H2O") or atomic numbers.
    positions : (n, 3) array
    cell : (3, 3) array, optional
    pbc : bool or (3,) bool
    masses : (n,) array, optional — defaults to standard atomic weights.
    calculator : object with ``get_potential_energy(atoms)`` and
        ``get_forces(atoms)``, or a torch
        :class:`sella_tpu_torch.potentials.base.Potential`.
    """

    def __init__(
        self,
        symbols: Union[str, Sequence] = (),
        positions: Optional[np.ndarray] = None,
        cell: Optional[np.ndarray] = None,
        pbc: Union[bool, Sequence[bool]] = False,
        masses: Optional[np.ndarray] = None,
        calculator=None,
    ) -> None:
        self.numbers = _parse_symbols(symbols)
        n = len(self.numbers)
        if positions is None:
            positions = np.zeros((n, 3))
        self.positions = np.asarray(positions, dtype=np.float64).reshape(n, 3).copy()
        if cell is None:
            cell = np.zeros((3, 3))
        self.cell = np.asarray(cell, dtype=np.float64).reshape(3, 3).copy()
        if isinstance(pbc, (bool, np.bool_)):
            pbc = [pbc] * 3
        self.pbc = np.asarray(pbc, dtype=bool).reshape(3).copy()
        if masses is None:
            masses = atomic_masses[self.numbers]
        self.masses = np.asarray(masses, dtype=np.float64).reshape(n).copy()
        self.calc = calculator
        self.info: dict = {}

    # -- basic protocol ----------------------------------------------------
    def __len__(self) -> int:
        return len(self.numbers)

    def copy(self) -> "Atoms":
        new = Atoms.__new__(Atoms)
        new.numbers = self.numbers.copy()
        new.positions = self.positions.copy()
        new.cell = self.cell.copy()
        new.pbc = self.pbc.copy()
        new.masses = self.masses.copy()
        new.calc = self.calc
        new.info = dict(self.info)
        return new

    @property
    def symbols(self):
        return [chemical_symbols[z] for z in self.numbers]

    def get_masses(self) -> np.ndarray:
        return self.masses.copy()

    def get_positions(self) -> np.ndarray:
        return self.positions.copy()

    def set_positions(self, positions) -> None:
        self.positions = np.asarray(positions, dtype=np.float64).reshape(
            len(self), 3
        )

    def get_cell(self) -> np.ndarray:
        return self.cell.copy()

    def set_cell(self, cell) -> None:
        self.cell = np.asarray(cell, dtype=np.float64).reshape(3, 3)

    # -- calculator interface ----------------------------------------------
    def _require_calc(self):
        if self.calc is None:
            raise RuntimeError("Atoms has no attached calculator/potential")
        return self.calc

    def get_potential_energy(self) -> float:
        calc = self._require_calc()
        if hasattr(calc, "energy_and_forces"):
            e, _ = calc.energy_and_forces(self)
            return float(e)
        return float(calc.get_potential_energy(self))

    def get_forces(self) -> np.ndarray:
        calc = self._require_calc()
        if hasattr(calc, "energy_and_forces"):
            _, f = calc.energy_and_forces(self)
            return np.asarray(f)
        return np.asarray(calc.get_forces(self))

    def __repr__(self) -> str:
        return (
            f"Atoms({''.join(self.symbols)}, pbc={self.pbc.tolist()})"
        )


def from_ase(ase_atoms) -> Atoms:
    """Convert an ``ase.Atoms`` (when ASE is installed) to our container."""
    atoms = Atoms(
        symbols=ase_atoms.numbers,
        positions=ase_atoms.positions,
        cell=np.asarray(ase_atoms.cell),
        pbc=ase_atoms.pbc,
        masses=ase_atoms.get_masses(),
    )
    if ase_atoms.calc is not None:
        from .potentials.base import ASECalculatorWrapper

        atoms.calc = ASECalculatorWrapper(ase_atoms)
    # carry ASE constraints over for later ingestion by Constraints
    atoms.info["ase_constraints"] = list(
        getattr(ase_atoms, "constraints", []) or []
    )
    return atoms


def as_atoms(obj) -> Atoms:
    """Accept either our Atoms or an ase.Atoms and return ours."""
    if isinstance(obj, Atoms):
        return obj
    # Duck-type ASE Atoms
    if hasattr(obj, "get_atomic_numbers") and hasattr(obj, "get_positions"):
        return from_ase(obj)
    raise TypeError(f"Cannot interpret {type(obj)!r} as Atoms")
