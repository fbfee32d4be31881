"""Physical unit constants (ASE-compatible: eV / Angstrom / amu base units).

The reference pulls these from ``ase.units``; ASE is not a dependency of
this framework, so the CODATA-2018 values ASE uses are defined here.
Used by the Lindh-style guess Hessian
(``sella/internal.py:3738-3820``) and the EMT potential.
"""

# 1 Hartree in eV (CODATA 2018, as in ase.units)
Hartree = 27.211386245988
# 1 Bohr in Angstrom
Bohr = 0.5291772105638411
# Boltzmann constant in eV/K
kB = 8.617333262145179e-05
# ASE time unit: Angstrom * sqrt(amu/eV)
fs = 0.09822694750253277
