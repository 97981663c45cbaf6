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


def test_no_port_source_loads_files_by_path():
    for folder, _, files in os.walk(PORT):
        for name in files:
            if name.endswith((".py", ".cu")):
                with open(os.path.join(folder, name)) as f:
                    assert "load_reference_module" not in f.read(), name
