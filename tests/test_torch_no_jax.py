"""The port imports neither jax nor the JAX package.

A fresh interpreter with ``sys.modules['jax'] = None`` (so any
``import jax`` raises) imports the port's modules and drives two LJ4
steps of the ensemble.
"""
import os
import subprocess
import sys

import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = """
import sys
sys.modules['jax'] = None
import numpy as np
import torch
torch.set_num_threads(1)
import sella_tpu_torch
import sella_tpu_torch.interop
import sella_tpu_torch.ops.jacobi_eigh
import sella_tpu_torch.parallel.ensemble as ens
from sella_tpu_torch import EnsembleConfig, LennardJones, run_ensemble
x0 = np.array([[0, 0, 0, 1, 0, 0, .5, .87, 0, .5, .29, .82]]) * 1.12
st = run_ensemble(LennardJones(), torch.as_tensor(x0),
                  EnsembleConfig(natoms=4), max_steps=2)
assert int(st.nsteps[0]) == 2, st.nsteps
bad = [m for m in sys.modules
       if (m == 'jax' or m.startswith(('jax.', 'jaxlib', 'sella_tpu.')) or
           m == 'sella_tpu') and sys.modules[m] is not None]
assert not bad, bad
print('NO_JAX_OK')
"""


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", CODE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
