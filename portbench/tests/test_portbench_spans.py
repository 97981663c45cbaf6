"""Reading the program's spans from hand-built Chrome traces: the innermost span, launches by thread, idle by span."""

import json

import pytest

from portbench import spans, trace

MAIN, AUTOGRAD = 1, 2


def _x(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def _launched(name, host_ts, dev_ts, dur, corr, tid=MAIN, cat="kernel"):
    """A runtime call on the host and the device event it launched, tied by ``correlation``."""
    return [_x("cuda_runtime", "cudaLaunchKernel", host_ts, 1, tid, correlation=corr),
            _x(cat, name, dev_ts, dur, 7, correlation=corr)]


# one call: classify [0, 100) > tournament.group [10, 90) > denoiser.full [20, 60) > attention.flash [30, 40)
SPANS = [
    _x("user_annotation", "dc.classify#1", 0, 100),
    _x("user_annotation", "dc.tournament.group", 10, 80),
    _x("user_annotation", "dc.denoiser.full", 20, 40),
    _x("user_annotation", "dc.attention.flash", 30, 10),
]
DEVICE = (
    _launched("Memcpy HtoD", 2, 3, 4, 1, cat="gpu_memcpy")  # classify: 3-7
    + _launched("flash_fwd_kernel", 32, 35, 10, 2)  # attention.flash: 35-45
    + _launched("elementwise", 50, 50, 10, 3)  # denoiser.full: 50-60
    + _launched("bwd_kernel", 35, 62, 8, 4, tid=AUTOGRAD)  # another thread at 35: attention.flash
    + _launched("reduce", 70, 75, 5, 5)  # tournament.group: 75-80
)
STRETCH = _x("user_annotation", trace.RANGE, 0, 120)


def test_device_time_goes_to_the_innermost_span_at_launch():
    t = spans.by_span([STRETCH] + SPANS + DEVICE)
    assert t.device == pytest.approx({"classify": 4e-6, "attention.flash": 18e-6, "denoiser.full": 10e-6,
                                      "tournament.group": 5e-6})
    assert t.kernels["flash_fwd_kernel"] == pytest.approx({"attention.flash": 10e-6})


def test_a_launch_on_another_thread_is_charged_by_time():
    t = spans.by_span([STRETCH] + SPANS + DEVICE)
    assert t.kernels["bwd_kernel"] == pytest.approx({"attention.flash": 8e-6})
    # moved to 55 on that thread, it falls in denoiser.full
    moved = [dict(e, ts=55) if e.get("tid") == AUTOGRAD else e for e in DEVICE]
    assert spans.by_span([STRETCH] + SPANS + moved).kernels["bwd_kernel"] == pytest.approx({"denoiser.full": 8e-6})


def test_idle_by_span_and_no_program_span_sum_to_the_stretch_idle():
    t = spans.by_span([STRETCH] + SPANS + DEVICE)
    # device busy 3-7, 35-45, 50-60, 62-70, 75-80: gaps 0-3 and 7-35 in classify, 45-50 in
    # denoiser.full (attention.flash closed at 40), 60-62, 70-75 and 80-120 in tournament.group
    assert t.idle == pytest.approx({"classify": 31e-6, "denoiser.full": 5e-6, "tournament.group": 47e-6})
    assert t.idle_s == pytest.approx(sum(t.idle.values())) == pytest.approx(83e-6)
    # the same idle time the harness's own reader finds, whatever it charges it to
    assert sum(v for _, v in trace._idle_gaps([STRETCH] + DEVICE)) == pytest.approx(t.idle_s)


def test_a_gap_outside_every_span_reads_no_program_span():
    late = _launched("k", 105, 110, 5, 9)  # launched after classify closed at 100
    t = spans.by_span([STRETCH] + SPANS + DEVICE + late)
    assert t.idle[spans.NONE] == pytest.approx(5e-6)  # 115-120 (80-110 began in tournament.group)
    assert t.idle["tournament.group"] == pytest.approx(2e-6 + 5e-6 + 30e-6)
    assert t.device[spans.NONE] == pytest.approx(5e-6)
    assert t.idle_s == pytest.approx(sum(t.idle.values()))


def test_metrics_read_milliseconds_a_call_and_none_without_spans():
    t = spans.by_span([STRETCH] + SPANS + DEVICE)
    counters = {"classify.calls": 2}
    # tournament.* innermost: 5 µs of device time, 47 µs of idle, over 2 calls
    assert spans.metric("tournament_device_ms_per_call.classify", t, counters) == pytest.approx(2.5e-3)
    assert spans.metric("tournament_wait_ms_per_call.latency", t, counters) == pytest.approx(23.5e-3)
    # denoiser.*, norm.*, attention.*: 28 µs of device time, 5 µs of idle
    assert spans.metric("denoiser_wait_ms_per_call.latency", t, counters) == pytest.approx(2.5e-3)
    assert spans.metric("upload_wait_ms_per_call.latency", t, counters) == 0
    assert spans.metric("norm_device_ms_per_call.classify", t, counters) == 0
    assert spans.metric("optimizer_device_ms_per_step.train", t, counters) is None  # no train.steps
    # a program without spans: every metric None
    bare = spans.by_span([STRETCH] + DEVICE)
    assert set(bare.idle) == set(bare.device) == {spans.NONE}
    assert all(spans.metric(m, bare, {"classify.calls": 2, "train.steps": 2}) is None for m in spans.METRICS)


def test_the_harness_device_pass_reads_the_same_with_spans_in_it(tmp_path):
    """``read_trace``'s times, kernels and device operations come from the device-only trace: spans leave them as they are."""
    host = {"traceEvents": [STRETCH] + DEVICE}
    read = []
    for extra in ([], SPANS):
        d, h = tmp_path / f"d{len(extra)}.json", tmp_path / f"h{len(extra)}.json"
        d.write_text(json.dumps({"traceEvents": DEVICE + extra}))
        h.write_text(json.dumps(host))
        read.append(trace.read_trace(str(d), str(h)))
    assert read[0] == read[1]
