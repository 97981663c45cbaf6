"""The program's spans in a host-and-device trace: device time and device idle charged to the layer open.

The port marks its layer boundaries with spans (``utils/profiling.py``):
``torch.profiler`` ranges named ``dc.<layer>`` (a call's top span
``dc.<layer>#<n>``), recorded on the profiler's clock when the program's
spans are on. From a trace of a ``portbench.stretch`` range that holds
them, :func:`by_span` builds two tables:

- device time by span: each kernel, copy and memset goes to the innermost
  ``dc.`` span open when the runtime call that launched it began (the
  ``cuda_runtime``/``cuda_driver`` event of the same ``correlation``), on
  the launching thread; a launch from a thread that opened no span (the
  backward's kernels, launched from autograd's thread) goes by time to the
  span open on the thread that opened the most;
- idle time by span: each gap between the device's events inside the
  range goes to the innermost span open, on that thread, when it began.

Time outside every span is ``no program span``; the idle table's entries
sum to the range's idle time. :data:`METRICS` turns the tables into
milliseconds a call. A program without spans leaves both tables with
``no program span`` alone, and every metric reads None.

``python3 -m portbench.spans --workload <cell> --seed <n>`` runs a cell's
set-up, then traces ``trace_calls`` calls: the device alone, then the host
and device with the spans off and on, four times in turns. It prints the
tables and writes them, the metrics, where the flash forward's kernels
fell and every host pass's wall (the spans' cost when on) to
``<--out>/<cell>-<seed>.json`` (default ``build/portbench/spans``). No
benchmark result line: the harness (``core.py``, ``trace.py``) does not
read spans.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import sys
import timeit
import types
from collections import defaultdict

import torch

from . import core, trace
from .trace import DEVICE_CATS, RANGE

__all__ = ["METRICS", "NONE", "SpanTables", "by_span", "main", "measure", "metric"]

PREFIX = "dc."
NONE = "no program span"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TURNS = 4  # host passes with spans off and on, in turns, for their cost when on

# metric -> (table, spans summed: a name and every name under it, the counter of calls)
METRICS = {
    "tournament_device_ms_per_call.classify": ("device", ("tournament",), "classify.calls"),
    "norm_device_ms_per_call.classify": ("device", ("norm",), "classify.calls"),
    "denoiser_wait_ms_per_call.classify": ("idle", ("denoiser", "norm", "attention"), "classify.calls"),
    "upload_wait_ms_per_call.latency": ("idle", ("upload", "haar"), "classify.calls"),
    "tournament_wait_ms_per_call.latency": ("idle", ("tournament",), "classify.calls"),
    "denoiser_wait_ms_per_call.latency": ("idle", ("denoiser", "norm", "attention"), "classify.calls"),
    "optimizer_device_ms_per_step.train": ("device", ("train.optimizer", "train.ema"), "train.steps"),
    "optimizer_wait_ms_per_step.train": ("idle", ("train.optimizer", "train.ema"), "train.steps"),
    "upload_wait_ms_per_step.train": ("idle", ("upload", "haar"), "train.steps"),
}


@dataclasses.dataclass
class SpanTables:
    device: dict  # span -> seconds of device events launched inside it
    idle: dict  # span -> seconds of device idle that began inside it
    idle_s: float  # the range's idle time: what ``idle`` sums to
    kernels: dict  # kernel name -> {span: seconds}


def _span_name(label: str) -> str:
    return label[len(PREFIX):].split("#")[0]


def _innermost(spans: list, times: list) -> list:
    """For each of ``times``, the innermost of ``spans`` (``(start, end, name)`` by start) open then."""
    out = [NONE] * len(times)
    stack, i = [], 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        if stack:
            out[q] = stack[-1][2]
    return out


def by_span(events: list) -> SpanTables:
    """The device's time and idle inside the ``portbench.stretch`` range of ``events``, by span."""
    ranges = [e for e in events if e.get("name") == RANGE and e.get("cat") == "user_annotation"]
    if not ranges:
        raise RuntimeError(f"the trace has no {RANGE} range")
    r0 = float(ranges[0]["ts"])
    r1 = r0 + float(ranges[0]["dur"])

    spans = defaultdict(list)  # thread -> [(start, end, name)]
    launches = {}  # correlation -> (start, thread)
    device = []  # (start, end, name, correlation), clipped to the range
    for e in events:
        cat, name = e.get("cat"), e.get("name", "")
        s = float(e["ts"])
        t = s + float(e["dur"])
        if cat == "user_annotation" and name.startswith(PREFIX):
            spans[e.get("tid")].append((s, t, _span_name(name)))
        elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (s, e.get("tid"))
        elif cat in DEVICE_CATS:
            s, t = max(s, r0), min(t, r1)
            if t > s:
                device.append((s, t, name, e.get("args", {}).get("correlation")))
    for v in spans.values():
        v.sort(key=lambda x: (x[0], -x[1]))
    main = max(spans, key=lambda k: len(spans[k])) if spans else None

    # device time: by the span open where and when each event was launched
    where = defaultdict(list)  # thread -> [(index into device, launch time)]
    for j, (_, _, _, corr) in enumerate(device):
        launch = launches.get(corr)
        if launch is not None:
            where[launch[1] if launch[1] in spans else main].append((j, launch[0]))
    owner = [NONE] * len(device)
    for tid, items in where.items():
        for (j, _), name in zip(items, _innermost(spans.get(tid, []), [t for _, t in items])):
            owner[j] = name
    device_by = defaultdict(float)
    kernels = defaultdict(lambda: defaultdict(float))
    for (s, t, name, _), span in zip(device, owner):
        device_by[span] += (t - s) / 1e6
        kernels[name][span] += (t - s) / 1e6

    # idle: each gap between the merged device events, by the span open when it began
    merged = []
    for s, t, _, _ in sorted(device):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    edges = [r0] + [x for m in merged for x in m] + [r1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    idle_by = defaultdict(float)
    for (a, b), span in zip(gaps, _innermost(spans.get(main, []), [a for a, _ in gaps])):
        idle_by[span] += (b - a) / 1e6
    return SpanTables(dict(device_by), dict(idle_by), sum(b - a for a, b in gaps) / 1e6,
                      {k: dict(v) for k, v in kernels.items()})


def _under(span: str, names) -> bool:
    return any(span == n or span.startswith(n + ".") for n in names)


def metric(name: str, tables: SpanTables, counters: dict) -> float | None:
    """Milliseconds a call of ``METRICS[name]``; None without calls or without any program span."""
    table_name, names, per = METRICS[name]
    calls = counters.get(per, 0)
    table = getattr(tables, table_name)
    if not calls or not set(table) - {NONE}:
        return None
    return 1e3 * sum(v for span, v in table.items() if _under(span, names)) / calls


def top(table: dict, n: int = 10) -> list:
    return sorted(([k, v] for k, v in table.items()), key=lambda x: -x[1])[:n]


def measure(runner, calls: int, path: str) -> dict:
    """Trace ``calls`` calls of a set-up ``runner``: the device alone, then ``TURNS`` times the host and
    device with spans off and on; the tables and metrics of the first pass with spans on, every pass's wall."""
    from torch.profiler import ProfilerActivity

    from diffusion_classifier_tpu_torch.utils import profiling

    first = [10**6]  # past every call the check samples: none keeps its outputs

    def run():
        for j in range(first[0], first[0] + calls):
            runner.call(j)
        runner.finish()
        first[0] += calls

    def run_with_spans():
        with profiling.spans():
            run()

    def stretch_wall(events):
        return next(float(e["dur"]) for e in events if e.get("name") == RANGE) / 1e6

    run()  # a stretch untraced, after set-up's warm-up
    host = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {"calls": calls, "host_wall_s": {"off": [], "on": []}}
    trace._profile(run, path, [ProfilerActivity.CUDA])
    dev, w0, w1 = trace._device(trace._events(path))
    busy, _ = trace._union([(s, t) for s, t, _, _ in dev])
    out["device_pass"] = {"wall_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6}
    for turn in range(TURNS):  # off, on, off, on, ...
        trace._profile(run, path, host)
        events = trace._events(path)
        out["host_wall_s"]["off"].append(stretch_wall(events))
        if turn == 0:
            out["idle_spans_off_s"] = by_span(events).idle_s
        profiling.reset_counters()
        trace._profile(run_with_spans, path, host)
        counters = profiling.counters()
        events = trace._events(path)
        out["host_wall_s"]["on"].append(stretch_wall(events))
        if turn:
            continue
        tables = by_span(events)
        out["counters"] = counters
        out["spans_per_call"] = sum(
            1 for e in events if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX)) / calls
        out["idle_s"] = tables.idle_s
        out["idle_by_span_sum_s"] = sum(tables.idle.values())
        # the same idle time, as the harness reckons it: the range less the union of its device events
        ranged = next(e for e in events if e.get("name") == RANGE)
        r0 = float(ranged["ts"])
        dev, _, _ = trace._device(events, r0, r0 + float(ranged["dur"]))
        out["idle_harness_s"] = stretch_wall(events) - trace._union([(s, t) for s, t, _, _ in dev])[0] / 1e6
        out["flash_fwd_by_span"] = defaultdict(float)
        for name, by in tables.kernels.items():
            for k, v in by.items() if "flash_fwd" in name else ():
                out["flash_fwd_by_span"][k] += v
        out["metrics"] = {m: metric(m, tables, counters) for m in METRICS}
        out["device_by_span"] = top(tables.device, len(tables.device))
        out["idle_by_span"] = top(tables.idle, len(tables.idle))
    os.remove(path)
    timer = lambda stmt, n=10**6: timeit.Timer(stmt, globals={"span": profiling.span}).timeit(n) * 1e6 / n  # noqa: E731
    out["span_off_us"] = {"call": timer("span('norm.group')"), "with_block": timer("with span('norm.group'): pass")}
    with torch.profiler.profile(activities=host), profiling.spans():  # a span's cost under the host pass
        out["span_on_us"] = timer("with span('norm.group'): pass", 10**4)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="A cell's device time and idle by the program's spans.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out", default=os.path.join(core.WORK, "spans"), help="folder for the JSON")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.spans: no CUDA device; nothing is measured", file=sys.stderr)
        return 2
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(core.WORK, "torch_extensions")
    cell = core.find("workloads", args.workload)
    config = core.find("configs", cell["config"])
    config = dict(config, experiment={**config["experiment"], **cell.get("experiment", {})})
    device = "cuda:0"
    mode = importlib.import_module(f"portbench.modes.{cell['mode']}")
    runner = mode.Runner(types.SimpleNamespace(cell=cell, config=config, seed=args.seed, device=device))
    runner.setup()
    os.makedirs(core.WORK, exist_ok=True)
    out = {"cell": cell["name"], "seed": args.seed, "device": core.card_facts(device)}
    out.update(measure(runner, cell["trace_calls"], os.path.join(core.WORK, f"spans-{cell['name']}.json")))
    runner.release()
    print("portbench: device_by_span = " + json.dumps(out["device_by_span"][:10]), flush=True)
    print("portbench: idle_by_span = " + json.dumps(out["idle_by_span"][:10]), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{cell['name']}-{args.seed}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k not in ("device_by_span", "idle_by_span")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
