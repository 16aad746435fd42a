"""The port stands alone: it imports neither JAX nor the JAX package, and
runs on the CPU only when asked to."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "ceph_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]

BLOCKED_RUN = r"""
import importlib.abc, sys

def blocked(name):
    return (name in ("jax", "ceph_tpu") or name.startswith("jax.")
            or name.startswith("ceph_tpu."))

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"blocked import of {name}")
        return None

for name in [m for m in sys.modules if blocked(m)]:
    del sys.modules[name]
sys.meta_path.insert(0, Refuse())

import numpy as np
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
ec = ErasureCodePluginRegistry().factory("jax_rs", {"k": "8", "m": "4"},
                                         device="cpu")
payload = np.random.default_rng(0).integers(0, 256, 9000, np.uint8).tobytes()
enc = ec.encode(list(range(12)), payload)
lost = [0, 5, 9, 11]
out = ec.decode(lost, {i: enc[i] for i in range(12) if i not in lost})
assert all(out[w] == enc[w] for w in lost)
try:
    import ceph_tpu.ec.gf
except ImportError:
    pass
else:
    raise SystemExit("the finder let ceph_tpu through")
assert not any(blocked(m) for m in sys.modules), "jax or ceph_tpu loaded"
print("isolated-ok")
"""


def test_port_runs_with_jax_and_ceph_tpu_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", BLOCKED_RUN], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "isolated-ok" in res.stdout


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_or_ceph_tpu_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "ceph_tpu"), f"{path}: {mod}"


def test_codec_without_device_raises_without_cuda(monkeypatch):
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ErasureCodePluginRegistry().factory("jax_rs", {"k": "4", "m": "2"})
