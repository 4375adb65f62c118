"""The port (its tools included) and chip_smoke.py import torch and never
JAX, and nothing of the JAX package: the machine with the card has no
JAX."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import voxtracer_torch
names = [m.name for m in pkgutil.walk_packages(voxtracer_torch.__path__,
                                               "voxtracer_torch.")]
for must in ("voxtracer_torch.tools.kernel_ab",
             "voxtracer_torch.kernels.skyline",
             "voxtracer_torch.app.interactive",
             "voxtracer_torch.world.active",
             "voxtracer_torch.world.occlusion",
             "voxtracer_torch.world.dense",
             "voxtracer_torch.utils.profiling",
             "voxtracer_torch.dist.mesh",
             "voxtracer_torch.dist.shard",
             "voxtracer_torch.dist.multihost",
             "voxtracer_torch.kernels.sunshadow",
             "voxtracer_torch.kernels.beam",
             "voxtracer_torch.kernels.bitdda",
             "voxtracer_torch.kernels.conemarch",
             "voxtracer_torch.world.bitgrid"):
    assert must in names, names
for name in names:
    importlib.import_module(name)
sys.path.insert(0, ".")
import chip_smoke  # noqa: F401
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "voxtracer."))
             or m == "voxtracer")
print(len(names), bad)
assert "jax" not in sys.modules, bad
assert not bad, bad
"""


def test_port_imports_no_jax():
    # the probe computes nothing; two threads, as the other port tests
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 20  # every module of the port was imported


def test_port_sources_name_no_jax_module():
    """No source of the port, chip_smoke.py or the A/B tool has an import
    statement of jax or of the JAX package, inside functions included
    (the probe above sees only what runs at import)."""
    import ast

    files = sorted((REPO / "voxtracer_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert REPO / "voxtracer_torch" / "tools" / "kernel_ab.py" in files
    assert REPO / "voxtracer_torch" / "kernels" / "skyline.py" in files
    assert REPO / "voxtracer_torch" / "app" / "interactive.py" in files
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            bad += [(path.name, m) for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "voxtracer")]
    assert not bad, bad
