"""Readings for the check's limits: the program's sound runs, the control's, and planted faults.

    python3 portbench/control.py --workload <cell> --seeds 1 2 ... [--control 3] [--faults]

In one process, for each seed: the cell's set-up, the calls the check
reads (a classify cell's sampled calls, a train cell's steps through its
checked window steps) at the cell's own size, then the check's
numbers for the program; for the first ``--control`` seeds also for the
control (the reference with fp8 products in the program's place), and with
``--faults`` for each fault of ``portbench/faults.py`` the cell can have.
One JSON line per reading. The benchmark's runs never run this; it is how
the limits in the workload files were read (see ``PERF.md``).
"""

import argparse
import json
import os
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from portbench import core  # noqa: E402
from portbench.faults import FAULTS, plant  # noqa: E402


def reading(cell, config, seed, device, control=False, fault=None):
    import importlib

    undo = plant(cell["mode"], fault) if fault else None
    try:
        mode = importlib.import_module(f"portbench.modes.{cell['mode']}")
        runner = mode.Runner(types.SimpleNamespace(cell=cell, config=config, seed=seed, device=device))
        runner.setup()
        for i in runner.needed():
            runner.call(i)
        runner.finish()
        runner.release()
        numbers = runner.check(control=control)
    finally:
        if undo:
            undo()
    return {"seed": seed, "reading": "control" if control else fault or "program", **numbers,
            **{k: v for k, v in getattr(runner, "facts_after", {}).items() if not isinstance(v, list)}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=0, help="read the control on the first N seeds")
    p.add_argument("--faults", action="store_true", help="read every fault on the first 3 seeds")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py: needs a CUDA device", file=sys.stderr)
        return 2
    cell = core.find("workloads", args.workload)
    config = core.find("configs", cell["config"])
    config = dict(config, experiment={**config["experiment"], **cell.get("experiment", {})})
    for n, seed in enumerate(args.seeds):
        jobs = [(False, None)]
        if n < args.control:
            jobs.append((True, None))
        if args.faults and n < 3:
            jobs += [(False, f) for f in FAULTS[cell["mode"]] if not f.startswith("state_unchanged")]
        for control, fault in jobs:
            t0 = time.perf_counter()
            r = reading(cell, config, seed, "cuda:0", control, fault)
            r["seconds"] = time.perf_counter() - t0
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
