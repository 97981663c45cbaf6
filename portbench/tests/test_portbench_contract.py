"""The harness against its contract: names, metric coverage, discovery by name, imports, no card."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import core
from tiny import run, tiny

ROOT = core.CHECKOUT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_and_units_use_the_allowed_characters():
    b = bench()
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [w[k] for w in b["workloads"] for k in ("config", "traffic")]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [r for c in b["configs"] for r in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in b["end_to_end"] + b["per_layer"])
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        listed = [x["name"] for x in b[section]]
        assert len(listed) == len(set(listed)), section
    texts = [w["why"] for w in b["workloads"]] + [m["layer"] for m in b["per_layer"]]
    texts += [c["source"] for c in b["configs"]] + b["command"]
    assert all(0 < len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)
    assert len(json.dumps(b)) <= 64 * 1024


def test_every_metric_has_its_reader_and_every_cell_its_files():
    b = bench()
    for m in b["end_to_end"]:
        assert core._reader("end_to_end", m["name"]).UNIT == m["unit"]
    for m in b["per_layer"]:
        reader = core._reader("metrics", m["name"])
        assert (reader.UNIT, reader.LAYER, reader.MOVES) == (m["unit"], m["layer"], m["moves"])
    for w in b["workloads"]:
        cell = core.find("workloads", w["name"])
        assert cell["config"] == w["config"] and cell["why"] == w["why"]
        assert os.path.isfile(os.path.join(core.HERE, "modes", f"{cell['mode']}.py"))
        assert os.path.isfile(os.path.join(core.HERE, "counts", f"{w['config']}.py"))
    for c in b["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert core.find("configs", c["name"])["source"] == c["source"]


def test_each_per_layer_metric_cell_reports_what_it_moves():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in core.cell_metrics(b, cell, "end_to_end")}, (m["name"], cell)
    for cell in cells:
        e2e = {e["name"] for e in core.cell_metrics(b, cell, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert core.cell_metrics(b, cell, "per_layer")
    layers = {}
    for m in b["per_layer"]:
        assert layers.setdefault(m["name"].split(".")[0], m["layer"]) == m["layer"]


def test_a_dropped_workload_file_is_taken_up_without_editing(tmp_path, monkeypatch):
    """A new cell is a new workload file and a new BENCHMARK.json entry; no file of the harness changes."""
    checkout = tmp_path / "checkout"
    shutil.copytree(core.HERE, checkout / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    cell = core.find("workloads", "cifar10_unet.classify_b64")
    cell.pop("name")
    cell["experiment"] = dict(cell["experiment"], evaluation_per_stage=[2, 4], n_stages=2, n_keep_per_stage=[3, 1])
    cell["why"] = "a staged tournament: 3 of 10 classes kept after 2 evaluations"
    (checkout / "portbench" / "workloads" / "cifar10_unet.classify_staged.json").write_text(json.dumps(cell))
    b["workloads"].append({"name": "cifar10_unet.classify_staged", "config": "cifar10_unet",
                           "traffic": "classify_staged", "chips": 1, "why": cell["why"]})
    b["end_to_end"][0]["workloads"].append("cifar10_unet.classify_staged")
    (checkout / "BENCHMARK.json").write_text(json.dumps(b))
    before = {p: p.read_bytes() for p in (checkout / "portbench").rglob("*.py")}
    cell, config, e2e = tiny(monkeypatch, "cifar10_unet.classify_staged", root=str(checkout / "portbench"))
    assert [m["name"] for m in e2e] == ["classify_images_per_s", "setup_s"]
    cell["experiment"]["evaluation_per_stage"] = [2, 4]
    result = run(cell, config, e2e)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"classify_images_per_s", "setup_s"}
    assert {p: p.read_bytes() for p in (checkout / "portbench").rglob("*.py")} == before


FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "diffusion_classifier_tpu"}


def _top_level_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                yield arg.value.split(".")[0]
            elif isinstance(arg, ast.JoinedStr) and isinstance(arg.values[0], ast.Constant):
                yield arg.values[0].value.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = [os.path.join(d, n) for d, _, ns in os.walk(core.HERE) for n in ns if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        names = set(_top_level_imports(path))
        assert not names & FORBIDDEN, (path, names & FORBIDDEN)
        if os.sep + "reference" + os.sep in path:
            assert "diffusion_classifier_tpu_torch" not in names, path
    # the port's top-level name begins with the JAX package's: compared whole, it is allowed
    assert "diffusion_classifier_tpu_torch" not in FORBIDDEN
    code = ("import sys; sys.path.insert(0, %r); import portbench.core, portbench.modes.classify, "
            "portbench.modes.train, portbench.reference.dit, portbench.reference.unet, "
            "portbench.counts.cifar10_unet, portbench.counts.chexpert_dit_b4; "
            "import diffusion_classifier_tpu_torch.experiments.cifar10, "
            "diffusion_classifier_tpu_torch.experiments.chexpert_dit; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))" % (ROOT, FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_loaded_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "diffusion_classifier_tpu_torch_fake", sys)
    assert "diffusion_classifier_tpu" not in core.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "diffusion_classifier_tpu.ops", sys)
    assert core.loaded_forbidden() == ["diffusion_classifier_tpu"]


def _run_py(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "chexpert_dit_b4.classify_b16", "--seed",
         str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
    )


def test_run_without_a_card_fails_and_prints_no_result():
    out = _run_py(ROOT)
    assert out.returncode != 0
    assert not [line for line in out.stdout.splitlines() if line.startswith("{")]
    assert "CUDA" in out.stderr


def test_run_from_the_benchmark_alone_fails(tmp_path):
    shutil.copytree(core.HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = _run_py(tmp_path, {"PYTHONPATH": ""})
    assert out.returncode != 0
    assert not [line for line in out.stdout.splitlines() if line.startswith("{")]


@pytest.mark.gpu
def test_a_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "chexpert_dit_b4.latency_b1", "--seed", "7",
         "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.splitlines()[-1])
    assert result["correct"] and list(result)[-1] == "checks"
