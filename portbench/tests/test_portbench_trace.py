"""Reading a traced stretch: busy time as a union, the wall, kernels by name, idle gaps by host operation."""

import json

import pytest

from portbench import trace


def test_read_trace_unions_device_time_and_attributes_gaps(tmp_path):
    device = {"traceEvents": [
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 2, "dur": 3},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 15, "dur": 10},  # overlaps k1: counted once
        {"ph": "X", "cat": "kernel", "name": "flash_fwd_x", "ts": 40, "dur": 30},
    ]}
    host = {"traceEvents": device["traceEvents"] + [
        {"ph": "X", "cat": "user_annotation", "name": trace.RANGE, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 5, "dur": 20},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 6, "dur": 2},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 70, "dur": 25},
    ]}
    d, h = tmp_path / "d.json", tmp_path / "h.json"
    d.write_text(json.dumps(device))
    h.write_text(json.dumps(host))
    s = trace.read_trace(str(d), str(h))
    assert s.wall_s == pytest.approx(68e-6)  # first device event to the last
    assert s.busy_s == pytest.approx(48e-6)  # 3 + 15 + 30
    assert len(s.kernels) == 3
    assert s.kernel_seconds(("flash_fwd",)) == pytest.approx(30e-6)
    assert s.device_ops[0] == ["flash_fwd_x", pytest.approx(30e-6)]
    gaps = dict(s.idle_gaps)
    assert gaps["aten::mm"] == pytest.approx(20e-6)  # 0-2 no op, 5-10 and 25-40 in aten::mm
    assert gaps["aten::add"] == pytest.approx(30e-6)
    assert gaps["host: no traced operation"] == pytest.approx(2e-6)
