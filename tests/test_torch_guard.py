"""The port stands alone: no module of it imports jax or loads a file of the JAX package."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "diffusion_classifier_tpu_torch")

_SCRIPT = """
import importlib, os, pkgutil, sys
import diffusion_classifier_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
root = os.path.join({repo!r}, "diffusion_classifier_tpu") + os.sep
stray = sorted(
    name for name, m in list(sys.modules.items())
    if os.path.abspath(getattr(m, "__file__", None) or os.sep).startswith(root)
)
assert "jax" not in sys.modules, "jax was imported"
assert not stray, stray
print(len(names))
"""


def test_every_port_module_imports_without_jax_or_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT.format(repo=REPO)],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    # every .py file is a module or a subpackage, the root __init__.py aside
    files = sum(n.endswith(".py") for _, _, names in os.walk(PORT) for n in names)
    assert int(proc.stdout.split()[-1]) == files - 1


_SCRIPTS = """
import glob, importlib.util, os, sys
root = os.path.join({repo!r}, "diffusion_classifier_tpu") + os.sep
paths = sorted(glob.glob(os.path.join({repo!r}, "experiments", "*", "*_torch.py")))
for i, path in enumerate(paths):
    spec = importlib.util.spec_from_file_location(f"script_{{i}}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
stray = sorted(
    name for name, m in list(sys.modules.items())
    if os.path.abspath(getattr(m, "__file__", None) or os.sep).startswith(root)
)
assert "jax" not in sys.modules, "jax was imported"
assert not stray, stray
print(len(paths))
"""


def test_port_experiment_scripts_import_without_jax_or_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPTS.format(repo=REPO)],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    # train, inference and OOD of the CheXpert DiT and UNet; train and inference of CIFAR-10;
    # train, inference and explain of the IPMSA UNet; train and inference of the IPMSA DiT and
    # of the ResNet baseline
    assert int(proc.stdout.split()[-1]) == 15


def test_no_port_source_loads_files_by_path():
    for folder, _, files in os.walk(PORT):
        for name in files:
            if name.endswith((".py", ".cu")):
                with open(os.path.join(folder, name)) as f:
                    assert "load_reference_module" not in f.read(), name


_LZ4 = """
import ctypes, os, sys
from diffusion_classifier_tpu_torch.utils import lz4io
frame = bytes.fromhex("04224d184040") + b"\\x00" + (5 | 0x80000000).to_bytes(4, "little") + b"hello" + bytes(4)
assert lz4io.decompress(frame) == b"hello"
with open("/proc/self/maps") as f:
    maps = f.read()
native = os.path.join({repo!r}, "native", "liblz4dec.so")
assert native not in maps, "the committed native/liblz4dec.so was loaded"
assert lz4io.library_path() in maps
assert lz4io.library_path().startswith(os.path.join({repo!r}, "build") + os.sep)
assert "jax" not in sys.modules and not any(
    os.path.abspath(getattr(m, "__file__", None) or os.sep).startswith(os.path.join({repo!r}, "diffusion_classifier_tpu") + os.sep)
    for m in list(sys.modules.values()))
"""


def test_port_lz4_decoder_is_its_own_build():
    proc = subprocess.run(
        [sys.executable, "-c", _LZ4.format(repo=REPO)],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]


_PARALLEL = """
import sys
import torch.distributed
from diffusion_classifier_tpu_torch.parallel import collectives, mesh, sharding
root = {root!r}
stray = sorted(
    name for name, m in list(sys.modules.items())
    if (getattr(m, "__file__", None) or "").startswith(root)
)
assert "jax" not in sys.modules, "jax was imported"
assert not stray, stray
print(mesh.__name__, sharding.__name__, collectives.__name__)
"""


def test_parallel_modules_import_without_jax_or_the_jax_package():
    """The multi-process layer stands alone: ``parallel/{mesh,sharding,collectives}.py``."""
    root = os.path.join(REPO, "diffusion_classifier_tpu") + os.sep
    proc = subprocess.run(
        [sys.executable, "-c", _PARALLEL.format(root=root)],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.split() == [
        "diffusion_classifier_tpu_torch.parallel.mesh",
        "diffusion_classifier_tpu_torch.parallel.sharding",
        "diffusion_classifier_tpu_torch.parallel.collectives",
    ]


def test_transformers_is_imported_only_inside_build_t5_class_table():
    """Serving from a saved t5 table needs no ``transformers`` (the card's machine has none)."""
    import ast

    found = []
    for folder, _, files in os.walk(PORT):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(folder, name)
            with open(path) as f:
                tree = ast.parse(f.read())
            scopes = {}
            for node in ast.walk(tree):
                for child in ast.iter_child_nodes(node):
                    scopes[child] = node
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                if any(n.split(".")[0] == "transformers" for n in names):
                    scope = scopes.get(node)
                    while scope is not None and not isinstance(scope, ast.FunctionDef):
                        scope = scopes.get(scope)
                    found.append((os.path.relpath(path, REPO), getattr(scope, "name", None)))
    assert found == [(os.path.join("diffusion_classifier_tpu_torch", "models", "encoders.py"),
                      "build_t5_class_table")]
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, diffusion_classifier_tpu_torch.engine, "
         "diffusion_classifier_tpu_torch.experiments.cifar10; print('transformers' in sys.modules)"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert proc.returncode == 0 and proc.stdout.split() == ["False"], proc.stderr[-4000:]
