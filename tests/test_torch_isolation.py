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

BLOCKER = r"""
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

"""

CHECK = r"""
try:
    import ceph_tpu.ec.gf
except ImportError:
    pass
else:
    raise SystemExit("the finder let ceph_tpu through")
assert not any(blocked(m) for m in sys.modules), "jax or ceph_tpu loaded"
print("isolated-ok")
"""

BLOCKED_RUN = BLOCKER + r"""
import numpy as np
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
ec = ErasureCodePluginRegistry().factory("jax_rs", {"k": "8", "m": "4"},
                                         device="cpu")
payload = np.random.default_rng(0).integers(0, 256, 9000, np.uint8).tobytes()
enc = ec.encode(list(range(12)), payload)
lost = [0, 5, 9, 11]
out = ec.decode(lost, {i: enc[i] for i in range(12) if i not in lost})
assert all(out[w] == enc[w] for w in lost)
""" + CHECK

# The CLAY repair path of the port: the codec, its probed operator and the
# batched repair through the grouped applier (plain versions on the CPU).
BLOCKED_CLAY_RUN = BLOCKER + r"""
import numpy as np
import ceph_tpu_torch.ec.plugins.clay
import ceph_tpu_torch.parallel.clay_sharding as cs
import ceph_tpu_torch.parallel.lrc_sharding
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.ec.repair_operator import clay_repair_operator
ec = ErasureCodePluginRegistry().factory("clay", {"k": "8", "m": "4",
                                                  "d": "11"}, device="cpu")
data = np.random.default_rng(0).integers(0, 256, (2, 8, 64 * 16), np.uint8)
chunks = ec.encode_chunks_batch(data)
R, helpers, planes = clay_repair_operator(ec, 3)
flat = np.stack([chunks[:, h].reshape(2, 64, 16)[:, planes] for h in helpers],
                axis=1).reshape(2, -1, 16)
assert np.array_equal(cs.batched_clay_plane_repair(ec, R, flat), chunks[:, 3])
assert ec._engine.grouped_applier(R) is not None
""" + CHECK


# The port's perf lab: its experiments on the CPU (plain versions) and its
# kernels' wrappers (lab_copy, lab_bits, B1's tile).
BLOCKED_LAB_RUN = BLOCKER + r"""
import os
os.environ["PERF_LAB_STRIPES"] = "64"
import ceph_tpu_torch.testing
from ceph_tpu_torch.testing import perf_lab
for name in ("roof_copy", "enc_cmp_expand", "enc_u8_split2", "unpack_only",
             "roof_matmul", "enc_tile_4096"):
    assert perf_lab.run_experiment(name, device="cpu")["bit_identical"]
""" + CHECK


# The OSD path of the port: ECBackend writes, a degraded read, a batched
# scrub through the device CRC, and the resident write-back path, on the
# CPU.
BLOCKED_OSD_RUN = BLOCKER + r"""
import asyncio
import numpy as np
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.osd.ec_backend import ECBackend, LocalShard
from ceph_tpu_torch.store import CollectionId, GHObject, MemStore, Transaction

async def run(resident):
    codec = ErasureCodePluginRegistry().factory("jax_rs", {"k": "4", "m": "2"},
                                                device="cpu")
    store = MemStore()
    shards = {}
    for i in range(6):
        cid = CollectionId(1, 0, shard=i)
        await store.queue_transactions(Transaction().create_collection(cid))
        shards[i] = LocalShard(store, cid, pool=1, shard=i)
    be = ECBackend(codec, shards, stripe_unit=128, resident=resident,
                   resident_writeback=resident)
    datas = {f"o{i}": bytes([i + 1]) * 4096 for i in range(4)}
    await asyncio.gather(*(be.write(o, d) for o, d in datas.items()))
    await be.flush_resident()
    if resident:
        await be.resident.evict(target=0)
    for s in (0, 3):
        await store.queue_transactions(Transaction().remove(
            CollectionId(1, 0, shard=s), GHObject(1, "o1", shard=s)))
    assert await be.read("o1") == datas["o1"]
    rep = await be.scrub_batch(["o0", "o2", "o3"])
    assert all(r["clean"] for r in rep["reports"].values())

asyncio.run(run(False))
asyncio.run(run(True))
""" + CHECK


def _run_blocked(script):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "isolated-ok" in res.stdout


def test_port_runs_with_jax_and_ceph_tpu_blocked():
    _run_blocked(BLOCKED_RUN)


def test_clay_repair_runs_with_jax_and_ceph_tpu_blocked():
    _run_blocked(BLOCKED_CLAY_RUN)


def test_perf_lab_runs_with_jax_and_ceph_tpu_blocked():
    _run_blocked(BLOCKED_LAB_RUN)


def test_osd_path_runs_with_jax_and_ceph_tpu_blocked():
    _run_blocked(BLOCKED_OSD_RUN)


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


@pytest.mark.parametrize("plugin,profile", [
    ("clay", {"k": "4", "m": "2"}),
    ("lrc", {"k": "4", "m": "2", "l": "3"}),
    ("shec", {"k": "4", "m": "3", "c": "2"}),
])
def test_repair_codecs_without_device_raise_without_cuda(monkeypatch, plugin,
                                                         profile):
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ErasureCodePluginRegistry().factory(plugin, profile)


def test_device_shard_cache_without_device_raises_without_cuda(monkeypatch):
    from ceph_tpu_torch.store import DeviceShardCache

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        DeviceShardCache()
    assert DeviceShardCache(device="cpu").device == torch.device("cpu")


def test_ec_backend_over_a_codec_without_device_raises_without_cuda(
        monkeypatch):
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.osd.ec_backend import ECBackend

    codec = ErasureCodePluginRegistry().factory("jax_rs", {"k": "2", "m": "1"},
                                                device="cpu")

    class NoDevice:
        """The codec's surface without its ``device``."""

        def __getattr__(self, name):
            if name == "device":
                raise AttributeError(name)
            return getattr(codec, name)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    shards = {i: None for i in range(3)}
    with pytest.raises(RuntimeError):
        ECBackend(NoDevice(), shards, stripe_unit=128)
    assert ECBackend(codec, shards, stripe_unit=128).device == \
        torch.device("cpu")


def test_device_shard_cache_sharding_raises_naming_a10():
    from ceph_tpu_torch.store import DeviceShardCache

    with pytest.raises(NotImplementedError, match="A10"):
        DeviceShardCache(device="cpu", sharding=object())
    cache = DeviceShardCache(device="cpu")
    cache.set_sharding(None)
    with pytest.raises(NotImplementedError, match="A10"):
        cache.set_sharding(object())
