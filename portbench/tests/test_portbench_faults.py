"""The check catches what it must: the control, and faults planted in the timed path.

Each test drives a whole run of a cell (the look for a card skipped, the
narrow nets of ``tiny.py`` on the CPU) and holds it to the workload file's
own limits. A sound run reads correct; the control (the reference with fp8
products in the program's place) and each planted fault
(``portbench/faults.py``) read not correct.
"""

import pytest

from portbench.faults import FAULTS, plant
from tiny import run, tiny

CLASSIFY = ["chexpert_dit_b4.classify_b16", "cifar10_unet.classify_b64", "chexpert_dit_b4.latency_b1"]
TRAIN = "cifar10_unet.train_b64"


@pytest.mark.parametrize("workload", CLASSIFY + [TRAIN])
def test_sound_run_is_correct_and_the_control_is_not(monkeypatch, workload):
    cell, config, e2e = tiny(monkeypatch, workload)
    sound = run(cell, config, e2e)
    assert sound["correct"], sound["checks"]
    control = run(cell, config, e2e, control=True)
    assert not control["correct"], control["checks"]


@pytest.mark.parametrize("workload,fault", [(w, f) for w in CLASSIFY + [TRAIN]
                                            for f in FAULTS["train" if w == TRAIN else "classify"]])
def test_planted_faults_are_not_correct(monkeypatch, workload, fault):
    cell, config, e2e = tiny(monkeypatch, workload)
    if fault == "half_the_rows":
        cell["batch"] = max(cell["batch"], 2)
    undo = plant(cell["mode"], fault)
    try:
        result = run(cell, config, e2e)
    finally:
        undo()
    assert not result["correct"], (fault, result["checks"])
