from .base import ASECalculatorWrapper, Potential
from .emt import EMT, fcc111_primitive, fcc111_slab, fcc_bulk
from .mixed import F32Potential
from .pair import LennardJones, MorsePotential
from .tip3p import TIP3P, water_cluster

__all__ = [
    "EMT",
    "ASECalculatorWrapper",
    "F32Potential",
    "Potential",
    "LennardJones",
    "MorsePotential",
    "TIP3P",
    "fcc111_primitive",
    "fcc111_slab",
    "fcc_bulk",
    "water_cluster",
]
