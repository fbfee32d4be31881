#!/usr/bin/env python3
"""Time chip_smoke.py's launch-bound phases with the port of a given tree.

Runs the selected phases of this checkout's ``chip_smoke.py`` with
``sella_tpu_torch`` imported from ``--tree`` (by default this checkout),
so that two trees can be compared in one call on the card (run them as
parent, change, change, parent), and prints the card's name and power
limit, then one JSON line per phase with its wall time. The gates that
hold a phase to the JAX package's counts at one size are reported, not
raised, so that other sizes can be timed too.

    python3 tools/time_served_queues.py [--tree DIR] PHASE[:ARGS] ...

PHASE is one of

* ``headline``: phase 4 (1024 lanes, ``prfo_eigh="jacobi"``);
* ``served:LANES:STARTS``: phase 6's served EMT headline;
* ``lj4``: phase 7's LJ4 composite queue at chip_smoke's size;
* ``internal_queue:LANES:INPUTS``: phase 12d;
* ``hetero:PER_KIND:LANES:STEPS``: phase 16a (PER_KIND LJ4 and PER_KIND
  LJ7 starts, STEPS a search).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def run(spec: str) -> dict:
    name, *args = spec.split(":")
    args = [int(a) for a in args]
    t = time.perf_counter()
    out = {"phase": spec}
    try:
        if name == "headline":
            st = cs.run_headline("jacobi")
            out.update(steps_run=st["steps_run"], s_per_step=st["s_per_step"])
        elif name == "served":
            st = cs.run_queue_headline(batch=args[0], total=args[1])
        elif name == "lj4":
            st = cs.run_lj4_composite(**cs.LJ4_SIZE)
        elif name == "internal_queue":
            st = cs.run_internal_queue(batch=args[0], total=args[1])
        elif name == "hetero":
            st = cs.run_hetero_campaign(size={
                "per_kind": args[0], "batch": args[1],
                "refill_every": cs.HETERO_SIZE["refill_every"],
                "max_steps_per_search": args[2]})
        else:
            raise SystemExit(f"unknown phase {name!r}")
        out["stats"] = {k: v for k, v in st.items()
                        if isinstance(v, (int, float, str, dict))}
    except AssertionError as e:
        out["gate"] = str(e)
    out["wall_s"] = time.perf_counter() - t
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT,
                    help="directory whose sella_tpu_torch is timed")
    ap.add_argument("phases", nargs="+")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_served_queues: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, os.path.abspath(a.tree))
    import sella_tpu_torch

    print(cs._card(), flush=True)
    print(json.dumps({"tree": os.path.dirname(os.path.abspath(
        sella_tpu_torch.__file__))}), flush=True)
    cs.phase_env()
    for spec in a.phases:
        print(json.dumps(run(spec)), flush=True)


if __name__ == "__main__":
    main()
