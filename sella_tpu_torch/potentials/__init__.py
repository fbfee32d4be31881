from .base import ASECalculatorWrapper, Potential
from .binned import BinnedPairPotential, CellBins
from .emt import EMT, BinnedEMT, fcc111_primitive, fcc111_slab, fcc_bulk
from .mixed import F32Potential
from .mlff import MLPotential
from .pair import Harmonic, LennardJones, MorsePotential
from .sharded import ChunkedPairPotential
from .sw import StillingerWeber, si_diamond
from .tip3p import TIP3P, water_cluster

__all__ = [
    "EMT",
    "ASECalculatorWrapper",
    "BinnedEMT",
    "BinnedPairPotential",
    "CellBins",
    "ChunkedPairPotential",
    "F32Potential",
    "Harmonic",
    "MLPotential",
    "Potential",
    "LennardJones",
    "MorsePotential",
    "StillingerWeber",
    "TIP3P",
    "fcc111_primitive",
    "fcc111_slab",
    "fcc_bulk",
    "si_diamond",
    "water_cluster",
]
