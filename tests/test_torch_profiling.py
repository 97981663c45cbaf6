"""The port's ``utils/profiling.py`` on the CPU: a loadable trace, ``timed``, ``StepTimer`` against JAX's."""

import json
import os

import numpy as np
import pytest
import torch

from diffusion_classifier_tpu.utils.profiling import StepTimer as JaxStepTimer
from diffusion_classifier_tpu_torch.utils import profiling

torch.set_num_threads(1)


def test_trace_writes_a_loadable_chrome_trace(tmp_path):
    a = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    with profiling.trace(str(tmp_path / "trace")) as prof:
        b = (a @ a).relu().sum()
    assert prof.trace_path is not None and os.path.dirname(prof.trace_path) == str(tmp_path / "trace")
    assert prof.trace_path.endswith(".pt.trace.json")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    ops = {e["name"] for e in events if e.get("cat") == "cpu_op"}
    assert {"aten::mm", "aten::relu", "aten::sum"} <= ops
    assert all(e["dur"] >= 0 for e in events if e.get("cat") == "cpu_op")
    assert any(row.key == "aten::mm" for row in prof.key_averages())
    assert torch.isfinite(b)
    # a second trace in the same folder is a file of its own
    with profiling.trace(str(tmp_path / "trace")) as second:
        a.sum()
    assert second.trace_path != prof.trace_path and os.path.isfile(second.trace_path)


def test_timed_returns_the_result_and_a_positive_time():
    x = torch.randn(128, 128)
    result, seconds = profiling.timed(torch.matmul, x, x)
    torch.testing.assert_close(result, x @ x, rtol=0, atol=0)
    assert isinstance(seconds, float) and seconds > 0
    # any pytree of outputs, or none
    (r1, r2), s = profiling.timed(lambda: (x.sum(), {"m": x.max()}))
    assert r1.shape == () and r2["m"] == x.max() and s > 0
    assert profiling.timed(lambda: None)[0] is None


@pytest.mark.parametrize("times", [[], [0.5], [0.003, 0.001, 0.002, 0.010, 0.004]])
def test_step_timer_summary_equals_jax(times):
    port, ref = profiling.StepTimer(), JaxStepTimer()
    port.times, ref.times = list(times), list(times)
    assert port.summary() == ref.summary()
    assert set(port.summary()) == ({"steps"} if not times else {"steps", "mean_s", "p50_s", "p95_s"})


def test_step_timer_measures_steps():
    timer = profiling.StepTimer()
    for _ in range(3):
        with timer.measure():
            torch.randn(64, 64).sum()
    assert len(timer.times) == 3 and all(t > 0 for t in timer.times)
    summary = timer.summary()
    assert summary["steps"] == 3 and summary["p50_s"] == float(np.percentile(timer.times, 50))
    with pytest.raises(RuntimeError, match="start"):
        timer.stop()
