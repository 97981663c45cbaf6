"""One run of one cell: set-up, the measured window, the check, one result line.

Everything is found by name under the benchmark's folder: the cell in
``workloads/<cell>.json``, its configuration in ``configs/<config>.json``,
the mode that drives the program in ``modes/<mode>.py``, each end-to-end
metric's reader in ``end_to_end/<metric>.py`` and each per-layer metric's in
``metrics/<metric>.py``, the counts in ``counts/<config>.py``. Which metrics
a cell reports is ``BENCHMARK.json``'s: every end-to-end metric whose
``workloads`` list the cell (or that has none), and with ``--trace 1``
every per-layer metric that does.

The window runs whole calls, one caller, until ``--seconds`` have passed
and the calls the check reads have run; its length is the time of those
calls (for a mode that does not wait on each call, up to the final
synchronisation). Set-up's objects are frozen out of the garbage
collector's passes first, so the window's collections see the program's
objects alone. With ``--trace 1`` the profiler then covers
``trace_calls`` more whole calls, after the window closed, so the window
itself runs as it does untraced. After that the peak memory is read (the
window's peak, less what the check's sampled calls left allocated on the
card: the program's own footprint), the program's state freed, and the
mode's check compares what the checked calls produced with the plain
reference; each number is held to its limit in the workload file.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import types

import torch

from . import trace as tracing

__all__ = ["cell_metrics", "find", "main", "run_cell"]

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "diffusion_classifier_tpu")
WORK = os.path.join(CHECKOUT, "build", "portbench")


def find(kind: str, name: str, root: str = HERE) -> dict:
    """``<root>/<kind>/<name>.json``, with its name."""
    path = os.path.join(root, kind, f"{name}.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return dict(json.load(f), name=name)


def cell_metrics(bench: dict, cell: str, section: str) -> list:
    """The metrics of ``bench[section]`` that cell ``cell`` reports."""
    return [m for m in bench[section] if "workloads" not in m or cell in m["workloads"]]


def _reader(kind: str, name: str):
    """The module ``<kind>/<name>.py`` (a metric's name may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def process_start() -> float | None:
    """Seconds since boot at which this process started (``/proc``), or None."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_facts(device) -> dict:
    facts = {"kind": torch.cuda.get_device_name(device)}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        facts["nvidia_smi"] = out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        facts["nvidia_smi"] = f"not read: {e}"
    return facts


def _describe(window, sampled) -> None:
    """Print how the window's calls spread: quantiles of a call's time, the rate in each quarter."""
    ms = [(c1 - c0) * 1e3 for c0, c1, _ in window.calls]
    q = sorted(ms)
    at = lambda f: q[min(len(q) - 1, int(f * len(q)))]  # noqa: E731
    print("portbench: call_ms p5 p25 p50 p75 p95 p99 max = "
          + " ".join(f"{at(f):.3f}" for f in (0.05, 0.25, 0.5, 0.75, 0.95, 0.99)) + f" {q[-1]:.3f}", flush=True)
    if sampled:
        picked = sorted(m for i, m in enumerate(ms) if i in sampled)
        if picked:
            print(f"portbench: sampled calls {len(picked)}, median {picked[len(picked) // 2]:.3f} ms", flush=True)
    start, quarter = window.calls[0][0], window.seconds / 4
    images = [0] * 4
    for c0, _, n in window.calls:
        images[min(3, int((c0 - start) / quarter))] += n
    print("portbench: images/s by quarter of the window = " + " ".join(f"{n / quarter:.2f}" for n in images), flush=True)


def run_cell(cell: dict, config: dict, seed: int, seconds: float, trace: bool, device: str, *,
             end_to_end: list, per_layer: list, started: float | None = None, control: bool = False) -> dict:
    """Run one cell once; the result dict (``checks`` last), or raise.

    ``started`` is when the process started, in ``CLOCK_BOOTTIME`` seconds
    (default: now); ``control`` puts the reference in fp8 in the program's place.
    """
    started = time.clock_gettime(time.CLOCK_BOOTTIME) if started is None else started
    # the cell's own settings (evaluations, stages, class chunk) over the configuration's
    config = dict(config, experiment={**config["experiment"], **cell.get("experiment", {})})
    cuda = device.startswith("cuda")
    mode = importlib.import_module(f"portbench.modes.{cell['mode']}")
    ctx = types.SimpleNamespace(cell=cell, config=config, seed=seed, device=device)
    runner = mode.Runner(ctx)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    runner.setup()
    for k, v in runner.facts.items():
        print(f"portbench: {k} = {v}", flush=True)
    if cuda:  # the window's peak: the benchmark's own weights and set-up buffers are not the program's
        print(f"portbench: setup_peak_bytes = {torch.cuda.max_memory_allocated(device)}", flush=True)
        torch.cuda.reset_peak_memory_stats(device)
    gc.collect()
    gc.freeze()

    calls, stretch, counts = [], None, {}
    needed = runner.needed()
    setup_s = time.clock_gettime(time.CLOCK_BOOTTIME) - started
    w0 = time.perf_counter()
    i = 0
    while True:
        c0 = time.perf_counter()
        images = runner.call(i)
        calls.append((c0, time.perf_counter(), images))
        i += 1
        if time.perf_counter() - w0 >= seconds and (not needed or i > needed[-1]):
            break
    runner.finish()
    w1 = time.perf_counter()
    gc.unfreeze()
    window = types.SimpleNamespace(calls=calls, seconds=w1 - w0, setup_s=setup_s)
    _describe(window, getattr(runner, "sampled", ()))
    if trace:
        def stretch_calls(first=i):
            for j in range(first, first + cell["trace_calls"]):
                runner.call(j)
            runner.finish()

        with runner.counting(counts):
            stretch = tracing.profiled(stretch_calls, os.path.join(WORK, f"trace-{cell['name']}.json"))
    peak = torch.cuda.max_memory_allocated(device) - runner.held_bytes if cuda else 0
    print(f"portbench: check_held_bytes = {runner.held_bytes} (left out of memory_peak_bytes)", flush=True)

    runner.release()
    t_check = time.perf_counter()
    checks = runner.check(control=control)
    print(f"portbench: check_s = {time.perf_counter() - t_check}", flush=True)
    limits = cell["limits"]  # the numbers compared; any other number is printed beside them
    if not set(limits) <= set(checks):
        raise KeyError(f"limits for numbers the check does not read: {sorted(set(limits) - set(checks))}")
    correct = all(math.isfinite(checks[k]) and checks[k] <= limit for k, limit in limits.items())
    for k in sorted(set(checks) - set(limits)):
        print(f"portbench: {k} = {checks[k]} (read, not compared)", flush=True)
    for k, v in getattr(runner, "facts_after", {}).items():
        print(f"portbench: {k} = {v}", flush=True)

    metrics = {}
    if not trace:
        for m in end_to_end:
            metrics[m["name"]] = {"value": _reader("end_to_end", m["name"]).read(window), "unit": m["unit"]}
    else:
        counts_mod = importlib.import_module(f"portbench.counts.{config['name']}")
        record = types.SimpleNamespace(
            cell=cell, config=config, window=window, stretch=stretch, forwards=counts,
            work=runner.work(counts_mod.counts(config)),
        )
        for m in per_layer:
            value = _reader("metrics", m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": len(calls),
        "failed": 0 if correct else len(getattr(runner, "checked", {})) or 1,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else device, "kind": torch.cuda.get_device_name(device) if cuda else device,
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if trace and stretch is not None:
        result["device"].update(busy_s=stretch.busy_s, window_s=stretch.wall_s)
        result["breakdown"] = {"device_ops": stretch.device_ops, "idle_gaps": stretch.idle_gaps}
    result["checks"] = {k: {"value": checks[k], "limit": limit} for k, limit in limits.items()}
    return result


def main(argv=None) -> int:
    started = process_start()
    p = argparse.ArgumentParser(description="Run one benchmark cell of the PyTorch/CUDA port once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"portbench: {args.workload!r} is no workload of BENCHMARK.json", file=sys.stderr)
        return 2
    cell = find("workloads", args.workload)
    config = find("configs", cell["config"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {entry['chips']} CUDA device(s), this machine has {n}; "
              "nothing is measured on another device", file=sys.stderr)
        return 2
    # every build and kernel cache at a fixed path inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(WORK, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(WORK, "triton")
    device = "cuda:0"
    facts = card_facts(device)
    print(f"portbench: device {facts['kind']}; nvidia-smi: {facts['nvidia_smi']}", flush=True)
    result = run_cell(
        cell, config, args.seed, args.seconds, bool(args.trace), device,
        end_to_end=cell_metrics(bench, args.workload, "end_to_end"),
        per_layer=cell_metrics(bench, args.workload, "per_layer"),
        started=started,
    )
    found = loaded_forbidden()
    if found:
        print(f"portbench: the process has loaded {found}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
