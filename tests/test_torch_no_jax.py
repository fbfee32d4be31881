"""The port imports neither jax nor the JAX package.

A fresh interpreter with ``sys.modules['jax'] = None`` (so any
``import jax`` raises) imports every module of the port (walked with
``pkgutil``), drives two LJ4 steps of the ensemble, a two-input work
queue with a checkpoint, two steps of the atom+cell tier on periodic LJ,
one ``F32Potential`` gradient, two steps of the internal-coordinate tier
(the state round-tripped through ``interop``), a two-input internal
queue, and the large-system path: an order-0 ``run_mmf`` on a binned LJ
block, an order-1 step on the committed MLFF weights (the state
round-tripped through ``interop``), ``BinnedEMT`` and
Stillinger-Weber energies; then a step of the internal+cell tier, an
IRC step (its state round-tripped through ``interop``) and a two-job
heterogeneous queue.
"""
import os
import subprocess
import sys

import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = """
import importlib, os, pkgutil, sys, tempfile
sys.modules['jax'] = None
import numpy as np
import torch
torch.set_num_threads(1)
import sella_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(sella_tpu_torch.__path__,
                                              'sella_tpu_torch.')]
for name in mods:
    importlib.import_module(name)
assert {'sella_tpu_torch.parallel.checkpoint',
        'sella_tpu_torch.parallel.metrics',
        'sella_tpu_torch.parallel.ensemble_cell',
        'sella_tpu_torch.potentials.mixed', 'sella_tpu_torch.pes.cell',
        'sella_tpu_torch.utils.lattice', 'sella_tpu_torch.coords.primitives',
        'sella_tpu_torch.coords.constraints',
        'sella_tpu_torch.coords.topology', 'sella_tpu_torch.coords.internals',
        'sella_tpu_torch.parallel.ensemble_internal',
        'sella_tpu_torch.potentials.tip3p',
        'sella_tpu_torch.potentials.binned',
        'sella_tpu_torch.potentials.sharded',
        'sella_tpu_torch.potentials.mlff', 'sella_tpu_torch.potentials.sw',
        'sella_tpu_torch.parallel.largescale',
        'sella_tpu_torch.parallel.ensemble_cell_internal',
        'sella_tpu_torch.parallel.ensemble_irc',
        'sella_tpu_torch.parallel.hetero'} <= set(mods), mods
from sella_tpu_torch import (EnsembleConfig, LennardJones, run_ensemble,
                             run_ensemble_queue, summarize)
x0 = np.array([[0, 0, 0, 1, 0, 0, .5, .87, 0, .5, .29, .82]]) * 1.12
st = run_ensemble(LennardJones(), torch.as_tensor(x0),
                  EnsembleConfig(natoms=4), max_steps=2)
assert int(st.nsteps[0]) == 2, st.nsteps
assert summarize(st).n_total == 1
cfg = EnsembleConfig(natoms=4, order=0, eig=False, method='qn')
with tempfile.TemporaryDirectory() as tmp:
    res = run_ensemble_queue(LennardJones(), np.vstack([x0, x0 + 0.02]),
                             cfg, batch=1, max_steps_per_search=30,
                             refill_every=10, device='cpu',
                             checkpoint_path=os.path.join(tmp, 'q.pt'))
assert len(res) == 2 and all(r[3] for r in res), res
from sella_tpu_torch import (CellEnsembleConfig, F32Potential,
                             run_cell_ensemble)
from sella_tpu_torch.potentials import fcc_bulk
atoms = fcc_bulk('Cu', 1.55, reps=(2, 2, 2))
xc = atoms.positions.reshape(1, -1) + 0.02
cs = run_cell_ensemble(LennardJones(pbc=True), torch.as_tensor(xc),
                       CellEnsembleConfig(natoms=32, ncell=9),
                       atoms.cell, max_steps=2)
assert int(cs.nsteps[0]) == 2 and bool(torch.isfinite(cs.z).all())
g32 = F32Potential(LennardJones()).grad(torch.as_tensor(x0[0]),
                                        torch.zeros((3, 3),
                                                    dtype=torch.float64))
assert g32.dtype == torch.float64 and bool(torch.isfinite(g32).all())
from sella_tpu_torch import (InternalEnsembleConfig, InternalSearchState,
                             Internals, MorsePotential, Atoms,
                             run_internal_ensemble,
                             run_internal_ensemble_queue)
from sella_tpu_torch.interop import state_from_numpy, state_to_numpy
pos0 = np.random.RandomState(4).normal(size=(4, 3), scale=3.0)
ints = Internals(Atoms(['Xe'] * 4, pos0))
ints.find_all_bonds(); ints.find_all_angles(); ints.find_all_dihedrals()
morse = MorsePotential(epsilon=0.01955, r0=4.73, rho0=4.73 * 1.099)
icfg = InternalEnsembleConfig(natoms=4, nint=ints.nint, order=1,
                              gamma=1e-3)
xi = pos0.reshape(1, 12) + 0.05
ist = run_internal_ensemble(morse, ints, xi, icfg, max_steps=2,
                            device='cpu')
assert int(ist.nsteps[0]) == 2 and bool(torch.isfinite(ist.x).all())
back = state_from_numpy(state_to_numpy(ist), device='cpu',
                        state_cls=InternalSearchState)
assert all(torch.equal(getattr(back, k), getattr(ist, k))
           for k in InternalSearchState._fields)
ires = run_internal_ensemble_queue(
    morse, ints, np.vstack([xi, xi + 0.02]),
    icfg._replace(order=0, eig=False), batch=1, max_steps_per_search=4,
    refill_every=2, spill=None, device='cpu')
assert len(ires) == 2 and all(len(r) == 6 for r in ires), ires
from sella_tpu_torch import (BinnedEMT, BinnedPairPotential, MLPotential,
                             StillingerWeber, make_mmf_step, run_mmf)
from sella_tpu_torch.interop import mmf_state_from_numpy, mmf_state_to_numpy
from sella_tpu_torch.parallel.largescale import mmf_init
from sella_tpu_torch.potentials import fcc111_slab, si_diamond
from sella_tpu_torch.potentials.mlff import WEIGHTS_CU_EMT
blk = (fcc_bulk('Cu', 1.56, reps=(2, 2, 2)).positions
       + 0.05 * np.random.RandomState(8).normal(size=(32, 3))).ravel()
ms = run_mmf(BinnedPairPotential(LennardJones(rc=2.5), rc=2.5, x0=blk,
                                 shift=False), blk, order=0, fmax=1e-2,
             max_steps=100, device='cpu')
assert bool(ms.converged), int(ms.nsteps)
slab = fcc111_slab('Cu', 3.59, size=(8, 10, 4), vacuum=12.0)
xs, cs = slab.positions.ravel(), slab.cell
xc = fcc_bulk('Cu', 3.59, reps=(2, 2, 2)).positions.ravel()
ml = MLPotential([29] * 32, xc, None, rc=4.5,
                 params=MLPotential.params_from_npz(WEIGHTS_CU_EMT))
m1 = make_mmf_step(ml, None, order=1, mode_iter=2)(
    mmf_init(ml, xc, device='cpu'))
assert int(m1.nsteps) == 1 and bool(torch.isfinite(m1.x).all())
back = mmf_state_from_numpy(mmf_state_to_numpy(m1), device='cpu')
assert torch.equal(back.x, m1.x) and torch.equal(back.mem.S, m1.mem.S)
eb = BinnedEMT([29] * 320, xs, cs).energy(torch.as_tensor(xs),
                                          torch.as_tensor(cs))
si = si_diamond()
esw = StillingerWeber(pbc=True).energy(torch.as_tensor(si.positions.ravel()),
                                       torch.as_tensor(si.cell))
assert bool(torch.isfinite(eb)) and float(esw) < 0
from sella_tpu_torch import (CellInternalEnsembleConfig, IRCEnsembleConfig,
                             IRCState, run_cell_internal_ensemble,
                             run_heterogeneous_queue, run_irc_ensemble)
bi = Internals(atoms)
bi.find_all_bonds(scale=0.43)
ci = run_cell_internal_ensemble(
    LennardJones(pbc=True), bi,
    torch.as_tensor(atoms.positions.reshape(1, -1) + 0.02),
    CellInternalEnsembleConfig(
        natoms=32, nint=bi.nint, h0_cell=10.0), atoms.cell, max_steps=1)
assert int(ci.nsteps[0]) == 1 and bool(torch.isfinite(ci.x).all())
H4 = torch.eye(12, dtype=torch.float64) * 10.0
H4[0, 0] = -5.0
ir = run_irc_ensemble(LennardJones(), torch.as_tensor(x0), H4[None],
                      IRCEnsembleConfig(natoms=4, dx=0.1), np.full(4, 4.0),
                      max_steps=1)
back = state_from_numpy(state_to_numpy(ir), device='cpu', state_cls=IRCState)
assert torch.equal(back.x, ir.x) and int(ir.nsteps[0]) == 1
hq = run_heterogeneous_queue(LennardJones(), [x0[0], blk[:21]],
                             batch=1, max_steps_per_search=2, order=0,
                             device='cpu')
assert len(hq) == 2 and hq[1][0].shape == (21,)
bad = [m for m in sys.modules
       if (m == 'jax' or m.startswith(('jax.', 'jaxlib', 'sella_tpu.')) or
           m == 'sella_tpu') and sys.modules[m] is not None]
assert not bad, bad
print('NO_JAX_OK', len(mods))
"""


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", CODE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
