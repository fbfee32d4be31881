from .base import ASECalculatorWrapper, Potential
from .emt import EMT, fcc111_primitive, fcc111_slab, fcc_bulk
from .pair import LennardJones, MorsePotential

__all__ = [
    "EMT",
    "ASECalculatorWrapper",
    "Potential",
    "LennardJones",
    "MorsePotential",
    "fcc111_primitive",
    "fcc111_slab",
    "fcc_bulk",
]
