#!/usr/bin/env python3
"""The JAX package's results on the configurations of ``chip_smoke.py``
phases 7, 8, 12, 13b, 14, 15b and 16a, computed on the CPU.

The card's host has no JAX, so ``chip_smoke.py`` holds the port to the
numbers this script prints: one JSON line, ``{"JAX_LJ4_REF": ...,
"JAX_CONSTRAINT_REF": ..., "JAX_INTERNAL_REF": ...,
"JAX_LARGESCALE_REF": ..., "JAX_CELL_INT_REF": ..., "JAX_IRC_REF": ...,
"JAX_HETERO_REF": ...}``, whose values are
copied over the constants of those names. Each carries the sizes it was
computed at under ``"size"``, and ``chip_smoke.py`` raises when its own
sizes differ:

* phase 7: the LJ4 composite queue of ``bench.run_lj4_queue`` at the
  sizes of ``chip_smoke.LJ4_SIZE`` (the bench caps tail budgets at 4x the
  per-search budget, so ``LJ4_SIZE`` must too);
* phase 8: the three constrained LJ4 configs of ``run_constraints`` at
  1024 lanes and ``chip_smoke.CONSTRAINT_MAX_STEPS`` steps: converged
  lanes, and the mean steps (printed, not gated);
* phase 12: the bench's internal Xe4 config at ``chip_smoke.
  INTERNAL_SIZE`` (12a), the dummy-atom and fixed-bond configs at
  ``INT_CONS_SIZE`` (12c) and the served internal queue at
  ``INT_QUEUE_SIZE`` (12d), each with its converged share and counts;
* phase 13b: the three large-system runs of ``chip_smoke.
  LARGESCALE_RUNS`` (the LJ7 saddle from the injected numpy mode, the
  Cu slab and the 1024-atom binned-EMT minimizations) through the JAX
  ``run_mmf`` loop: steps, force calls, HVPs and the final energy, under
  ``"size"`` the whole ``LARGESCALE_RUNS``;
* phase 14: the internal+cell tier on phase 10's system at
  ``chip_smoke.CELL_INT_SIZE`` (converged share, steps, force calls) and
  the four runs of 14b at ``CELL_INT_EVENTS`` (per lane: steps, force
  calls, converged flags, energies);
* phase 15b: examples/04_irc_pipeline.py at its full size; its saddle
  stage's transition states are written to ``chip_smoke.
  IRC_PIPE_TS_FILE`` (the card's host has no JAX to make them);
* phase 16a: the heterogeneous LJ4/LJ7 campaign at ``chip_smoke.
  HETERO_SIZE``, per bucket.

Run from the repository root (about twenty minutes on one CPU; ``--only
internal``, ``--only cartesian``, ``--only largescale``, ``--only
cell_internal``, ``--only irc`` or ``--only hetero`` computes one of the
groups):

    JAX_PLATFORMS=cpu python3 tools/jax_reference_counts.py
"""
from __future__ import annotations

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import sella_tpu  # noqa: E402,F401  (float64 before any jnp use)
import bench  # noqa: E402
import chip_smoke as cs  # noqa: E402
from sella_tpu.parallel.ensemble import EnsembleConfig, run_ensemble  # noqa
from sella_tpu.potentials import LennardJones  # noqa: E402


def lj4_composite():
    size = dict(cs.LJ4_SIZE)
    if size["retry_step_cap"] != 4 * size["max_steps"]:
        raise SystemExit("bench.run_lj4_queue caps tail budgets at 4x "
                         "max_steps")
    os.environ["BENCH_LJ4_RETRIES"] = str(size["max_retries"])
    os.environ["BENCH_LJ4_FAST_RETRIES"] = "2"
    os.environ["BENCH_LJ4_TAIL_BATCH"] = str(size["tail_batch"])
    _, stats = bench.run_lj4_queue(size["total"], size["batch"],
                                   size["max_steps"])
    return {"size": size, **{k: stats[k] for k in (
        "converged_frac", "mean_steps_converged", "mean_matvecs",
        "mean_force_calls")}}


def constraints(batch=1024):
    def bond(x):
        p = x.reshape(-1, 3)
        return jnp.array([jnp.linalg.norm(p[0] - p[1]) - 1.3])

    minim = dict(natoms=4, order=0, fmax=1e-4, ncons=1, ctol=1e-6,
                 eig=False, method="qn")
    runs = {
        "eq_min": (minim, 3, None),
        "gt_min": (minim, 3, ("gt",)),
        "eq_saddle": (dict(natoms=4, order=1, fmax=1e-3, ncons=1), 0, None),
    }
    out = {"size": {"batch": batch, "max_steps": cs.CONSTRAINT_MAX_STEPS}}
    for name, (kw, seed, comp) in runs.items():
        x0 = cs.lj4_starts(batch, seed, jitter=0.05)
        st = run_ensemble(LennardJones(), jnp.asarray(x0),
                          EnsembleConfig(**kw),
                          max_steps=cs.CONSTRAINT_MAX_STEPS,
                          constraints=bond, comparators=comp)
        conv = np.asarray(st.converged)
        out[name] = {"converged": int(conv.sum()),
                     "mean_steps_converged": float(
                         np.asarray(st.nsteps)[conv].mean())}
    return out


def _jax_xe4(positions):
    from sella_tpu.atoms import Atoms
    from sella_tpu.coords.internals import Internals

    ints = Internals(Atoms(["Xe"] * len(positions), positions))
    ints.find_all_bonds()
    ints.find_all_angles()
    ints.find_all_dihedrals()
    # a jitted init_internal_state cannot call the host guess Hessian
    H0 = ints.guess_hessian()
    ints.guess_hessian = lambda *a, **k: H0
    return ints


def _jit_internal_helpers(JE):
    """Jit init_internal_state and refresh_internal for the JAX queue
    (eagerly each dispatches hundreds of single-operation compiles);
    once per process."""
    if getattr(JE, "_jitted_for_reference", False):
        return
    JE._jitted_for_reference = True
    JE.init_internal_state = jax.jit(JE.init_internal_state,
                                     static_argnums=(0, 1, 3, 4))
    JE.refresh_internal = jax.jit(JE.refresh_internal,
                                  static_argnums=(1, 2, 3, 4),
                                  static_argnames=("delta0",))


def _xe4_jax():
    import sella_tpu.parallel.ensemble_internal as JE
    from sella_tpu.potentials import MorsePotential
    from sella_tpu.utils.units import kB

    _jit_internal_helpers(JE)
    r0 = 4.73
    pot = MorsePotential(epsilon=226.9 * kB, r0=r0, rho0=r0 * 1.099)
    ints = _jax_xe4(np.random.RandomState(4).normal(size=(4, 3), scale=3.0))
    cfg = JE.InternalEnsembleConfig(natoms=4, nint=ints.nint, order=1,
                                    fmax=1e-3, gamma=1e-3, restart_after=60,
                                    absb="eigh", newton_chord=True)
    return JE, pot, ints, cfg


def internal_headline():
    JE, pot, ints, cfg = _xe4_jax()
    size = dict(cs.INTERNAL_SIZE)
    x0 = cs.xe4_setup(size["batch"])[2]
    step = jax.jit(JE.make_internal_step_fn(pot, ints, cfg))
    st = JE.init_internal_state(pot, ints, jnp.asarray(x0), cfg, None)
    key = jax.random.PRNGKey(0)
    for i in range(size["max_steps"]):
        st = step(st, jax.random.fold_in(key, i))
        if bool(jnp.all(st.converged)):
            break
    return {"size": size, **cs.int_stats(st.nsteps, st.nmatvec, st.neval,
                                         st.converged)}


def internal_constraints():
    """The dummy-atom and fixed-bond configs: converged lanes and the
    largest constraint error at the final geometries."""
    from sella_tpu.coords.constraints import DuplicateInternalError

    JE, pot, _, _ = _xe4_jax()
    size = dict(cs.INT_CONS_SIZE)
    batch = size["batch"]
    r0 = 4.73
    lin = np.array([[0.0, 0, 0], [r0, 0, 0], [2 * r0, 0, 0]])
    tet = np.array([[0, 0, 0], [1, 0, 0], [0.5, np.sqrt(3) / 2, 0],
                    [0.5, np.sqrt(3) / 6, np.sqrt(2.0 / 3)]]) * r0
    dints = _jax_xe4(lin)
    fints = _jax_xe4(tet)
    try:
        fints.add_bond((0, 1))
    except DuplicateInternalError:
        pass
    fints.cons.fix_bond((0, 1), target=1.15 * r0)
    out = {}
    for name, ints_c, x0, kw in (
            ("dummy", dints, (lin[None] + 0.2 * np.random.RandomState(
                0).normal(size=(batch, 3, 3))).reshape(batch, 9),
             dict(natoms=3, ndummies=1, ncons=2)),
            ("fixed_bond", fints, (tet[None] + 0.15 * np.random.RandomState(
                1).normal(size=(batch, 4, 3))).reshape(batch, 12),
             dict(natoms=4, ncons=1))):
        c = JE.InternalEnsembleConfig(nint=ints_c.nint, order=0, fmax=1e-3,
                                      delta0=0.05, **kw)
        st = JE.run_internal_ensemble(pot, ints_c, jnp.asarray(x0), c,
                                      max_steps=size["max_steps"])
        out[name] = {"size": size, "converged": int(st.converged.sum()),
                     "constraint_err": cs.constraint_error(
                         name, np.asarray(st.x))}
    return out


def internal_queue():
    JE, pot, ints, cfg = _xe4_jax()
    size = dict(cs.INT_QUEUE_SIZE)
    x0 = cs.xe4_setup(size["total"], seed=1)[2]
    res = JE.run_internal_ensemble_queue(
        pot, ints, jnp.asarray(x0), cfg, batch=size["batch"],
        max_steps_per_search=size["max_steps_per_search"],
        refill_every=size["refill_every"], spill="cartesian")
    return {"size": size, **cs.int_stats(
        [r[2] for r in res], [r[4] for r in res], [r[5] for r in res],
        [r[3] for r in res])}


def internal():
    return {"headline": internal_headline(), **internal_constraints(),
            "queue": internal_queue()}


def largescale():
    """Phase 13b's runs: ``run_mmf`` of the JAX package (its host loop,
    sella_tpu/parallel/largescale.py:287-305) from ``mmf_init``, the LJ7
    saddle's mode replaced by ``chip_smoke.lj7_start``'s numpy draw."""
    from sella_tpu.parallel import largescale as L
    from sella_tpu.potentials import BinnedEMT, EMT as JEMT

    out = {"size": cs.LARGESCALE_RUNS}
    for name, cfg in cs.LARGESCALE_RUNS.items():
        if name == "lj7_saddle":
            x0, v0 = cs.lj7_start()
            pot, cell = LennardJones(), None
            state = L.mmf_init(pot, jnp.asarray(x0))._replace(
                mode=jnp.asarray(v0))
        else:
            x0, cell_np = cs.rattled_slab(name)
            z = np.array([29] * (x0.size // 3))
            cell = jnp.asarray(cell_np)
            pot = JEMT(z, pbc=True) if name == "cu_slab_min" \
                else BinnedEMT(z, x0, cell_np)
            state = L.mmf_init(pot, jnp.asarray(x0), cell)
        step = L.make_mmf_step(pot, cell, cfg["order"], cfg["fmax"],
                               cfg["max_move"])

        def multi(s, step=step):
            return jax.lax.fori_loop(0, 25, lambda i, st: jax.lax.cond(
                st.converged, lambda t: t, step, st), s)

        multi = jax.jit(multi)
        for _ in range(cfg["max_steps"] // 25 + 1):
            state = multi(state)
            if bool(state.converged) or \
                    int(state.nsteps) >= cfg["max_steps"]:
                break
        out[name] = {"converged": bool(state.converged),
                     "nsteps": int(state.nsteps),
                     "neval": int(state.neval),
                     "nmatvec": int(state.nmatvec),
                     "energy": float(state.f), "lam": float(state.lam)}
    return out


def _jit_cell_internal_helpers(JC):
    """Jit the JAX internal+cell init and refresh (eagerly each
    dispatches hundreds of single-operation compiles); once per
    process. The cell mask rides as a hashable key."""
    if getattr(JC, "_jitted_for_reference", False):
        return
    JC._jitted_for_reference = True
    init, refresh = JC.init_cell_internal_state, JC.refresh_cell_internal

    def key(m):
        return None if m is None else tuple(map(tuple, np.asarray(m)))

    def unkey(k):
        return None if k is None else np.asarray(k, bool)

    j_init = jax.jit(lambda pot, ints, x0, cfg, c0, mk, s0: init(
        pot, ints, x0, cfg, c0, unkey(mk), s0), static_argnums=(0, 1, 3, 5))
    j_refresh = jax.jit(lambda st, pot, ints, cfg, mk, mask: refresh(
        st, pot, ints, cfg, None, unkey(mk), mask),
        static_argnums=(1, 2, 3, 4))
    JC.init_cell_internal_state = (
        lambda pot, ints, x0, cfg, cell0, cell_mask=None, s0=None: j_init(
            pot, ints, jnp.asarray(x0), cfg, jnp.asarray(cell0),
            key(cell_mask), None if s0 is None else jnp.asarray(s0)))
    JC.refresh_cell_internal = (
        lambda st, pot, ints, cfg, cell0=None, cell_mask=None, mask=None:
        j_refresh(st, pot, ints, cfg, key(cell_mask), mask))


def _cached_guess(ints):
    # a jitted init cannot call the host guess Hessian
    H0 = ints.guess_hessian()
    ints.guess_hessian = lambda *a, **k: H0
    return ints


def cell_internal_headline():
    """14a: the bench's bulk Cu EMT system in internal coordinates + cell
    (``chip_smoke.cell_int_setup``), driven as the phase drives it."""
    import sella_tpu.parallel.ensemble_cell_internal as JC
    from sella_tpu.atoms import Atoms
    from sella_tpu.coords.internals import Internals
    from sella_tpu.potentials import EMT

    _jit_cell_internal_helpers(JC)
    size = dict(cs.CELL_INT_SIZE)
    _, tints, x0, s0, cell0, nat = cs.cell_int_setup(size["batch"])
    at = tints.atoms
    ints = Internals(Atoms(list(at.symbols), at.positions, cell=at.cell,
                           pbc=at.pbc))
    ints.find_all_bonds()
    assert ints.nint == tints.nint
    _cached_guess(ints)
    cfg = JC.CellInternalEnsembleConfig(**cs.cell_int_config(
        tints)._asdict())
    pot = EMT(np.array([29] * nat), pbc=True)
    st = JC.init_cell_internal_state(pot, ints, x0, cfg, cell0, None, s0)
    step = jax.jit(JC.make_cell_internal_step_fn(pot, ints, cfg, None))
    key = jax.random.PRNGKey(0)
    steps = 0
    while steps < size["max_steps"]:
        for _ in range(min(10, size["max_steps"] - steps)):
            st = step(st, key)
            steps += 1
        if bool(jnp.all(st.converged)):
            break
    conv = np.asarray(st.converged)
    return {"size": size, "converged_frac": float(conv.mean()),
            "mean_steps_converged": float(np.asarray(st.nsteps)[conv].mean()),
            "mean_force_calls": float(np.asarray(st.neval).mean()),
            "steps_run": steps}


def cell_internal_events():
    """14b: ``chip_smoke.ci_event_setups``'s four runs through the JAX
    entry points."""
    import sella_tpu.parallel.ensemble_cell_internal as JC
    from sella_tpu.atoms import Atoms
    from sella_tpu.coords.internals import Internals

    _jit_cell_internal_helpers(JC)
    out = {"size": dict(cs.CELL_INT_EVENTS)}
    for name, su in cs.ci_event_setups().items():
        ints = _cached_guess(cs.ci_event_ints(su, Atoms, Internals))
        pot = LennardJones(pbc=True, **su["pot"])
        ncell = 9 if su["mask"] is None else int(su["mask"].sum())
        cfg = JC.CellInternalEnsembleConfig(natoms=len(su["symbols"]),
                                            nint=ints.nint, ncell=ncell,
                                            **su["cfg"])
        x0 = jnp.asarray(su["x0"])
        s0 = None if su["s0"] is None else jnp.asarray(su["s0"])
        if name == "queue":
            res = JC.run_cell_internal_ensemble_queue(
                pot, ints, x0, cfg, jnp.asarray(su["cell"]), s0_all=s0,
                **su["run"])
            out[name] = {"nsteps": [r["nsteps"] for r in res],
                         "converged": [r["converged"] for r in res],
                         "f": [r["f"] for r in res]}
            continue
        st = JC.run_cell_internal_ensemble(
            pot, ints, x0, cfg, jnp.asarray(su["cell"]),
            cell_mask=su["mask"], s0=s0, **su["run"])
        if su["run"].get("niggli") or su["run"].get("repave"):
            st = st[0]
        out[name] = {"nsteps": np.asarray(st.nsteps).tolist(),
                     "neval": np.asarray(st.neval).tolist(),
                     "converged": np.asarray(st.converged).tolist(),
                     "f": np.asarray(st.f).tolist()}
    return out


def cell_internal():
    return {"headline": cell_internal_headline(),
            "events": cell_internal_events()}


def irc_pipeline():
    """15b: examples/04_irc_pipeline.py at its full size. The saddle
    stage's transition states (x and H of every lane, and the example's
    selection, its first four converged lanes) go to
    ``chip_smoke.IRC_PIPE_TS_FILE``; the IRC queue's steps, converged
    flags and endpoint energies, and each item's force calls (the JAX
    queue does not report them: ``run_irc_ensemble`` forward and reverse
    on the same four, whose lanes step exactly as in the queue), are
    returned."""
    from sella_tpu.parallel import ensemble_irc as JI

    tet = np.array([[0, 0, 0], [1, 0, 0], [0.5, np.sqrt(3) / 2, 0],
                    [0.5, np.sqrt(3) / 6, np.sqrt(2.0 / 3)]]) * 1.12
    rng = np.random.RandomState(7)
    x0 = jnp.asarray((tet[None] + 0.12 * rng.normal(size=(8, 4, 3))
                      ).reshape(8, 12))
    pot = LennardJones()
    st = run_ensemble(pot, x0, EnsembleConfig(natoms=4, order=1, fmax=1e-4,
                                              gamma=1e-3), max_steps=300)
    conv = np.asarray(st.converged)
    sel = np.where(conv)[0][:4]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    np.savez(os.path.join(root, cs.IRC_PIPE_TS_FILE), x=np.asarray(st.x),
             H=np.asarray(st.B), f=np.asarray(st.f), converged=conv,
             sel=sel)
    x_ts, H_ts = cs.irc_pipeline_inputs()
    pc = cs.irc_pipeline_config()
    cfg = JI.IRCEnsembleConfig(**pc["cfg"])
    res = JI.run_irc_ensemble_queue(pot, jnp.asarray(x_ts),
                                    jnp.asarray(H_ts), cfg, pc["masses"],
                                    batch=pc["batch"], directions="both")
    neval = {}
    for d, sgn in (("forward", 1), ("reverse", -1)):
        s = JI.run_irc_ensemble(pot, jnp.asarray(x_ts), jnp.asarray(H_ts),
                                cfg, pc["masses"], direction=d,
                                max_steps=150)
        neval[sgn] = np.asarray(s.neval).tolist()
    return {"nsteps": [r["nsteps"] for r in res],
            "neval": [neval[r["direction"]][r["ts"]] for r in res],
            "converged": [r["converged"] for r in res],
            "f": [r["f"] for r in res]}


def hetero():
    """16a: ``chip_smoke.hetero_jobs`` through the JAX
    ``run_heterogeneous_queue`` (``prfo_eigh="eigh"``)."""
    from sella_tpu.parallel.hetero import run_heterogeneous_queue

    size = dict(cs.HETERO_SIZE)
    jobs = cs.hetero_jobs(size["per_kind"])
    res = run_heterogeneous_queue(
        LennardJones(), jobs, size["batch"],
        max_steps_per_search=size["max_steps_per_search"],
        refill_every=size["refill_every"], **cs.hetero_config_kw())
    res = [(np.asarray(r[0]), float(r[1]), int(r[2]), bool(r[3]),
            int(r[4]), int(r[5])) for r in res]
    return {"size": size, **cs._bucket_stats(res, jobs)}


if __name__ == "__main__":
    only = sys.argv[sys.argv.index("--only") + 1] if "--only" in sys.argv \
        else None
    out = {}
    if only in (None, "cartesian"):
        out.update(JAX_LJ4_REF=lj4_composite(),
                   JAX_CONSTRAINT_REF=constraints())
    if only in (None, "internal"):
        out["JAX_INTERNAL_REF"] = internal()
    if only in (None, "largescale"):
        out["JAX_LARGESCALE_REF"] = largescale()
    if only in (None, "cell_internal"):
        out["JAX_CELL_INT_REF"] = cell_internal()
    if only in (None, "irc"):
        out["JAX_IRC_REF"] = irc_pipeline()
    if only in (None, "hetero"):
        out["JAX_HETERO_REF"] = hetero()
    print(json.dumps(out))
