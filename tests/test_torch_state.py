"""Matrices carried across from a JAX codec build a port codec that encodes
and decodes exactly as the port's own codec and the JAX codec do; a JAX
grouped plan carried across serves its repair operator exactly."""

import numpy as np
import pytest

from ceph_tpu.ec.pallas_kernels import (
    GroupedPlan,
    PallasGroupedApply,
    PallasShardApply,
)
from ceph_tpu.ec.registry import ErasureCodePluginRegistry as JaxRegistry
from ceph_tpu.ec.repair_operator import clay_repair_operator
from ceph_tpu_torch.ec.engine import BitplaneEngine
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.ec.state import (
    codec_from_reference_arrays,
    install_grouped_reference,
)

LOST = (0, 2)


def reference_arrays(jec) -> dict:
    """The numpy arrays that define a JAX codec's output."""
    k, n = jec.get_data_chunk_count(), jec.get_chunk_count()
    lost = LOST[: n - k]
    survivors, D = jec.decode_selection(
        [i for i in range(n) if i not in lost], lost)
    arrays = {"decode": {(survivors, lost): D}}
    if jec.full_bm is None:
        arrays["generator"] = jec.generator
        parity = jec.generator[k:]
    else:
        arrays["full_bm"] = jec.full_bm
        parity = jec.full_bm[k * jec.w:]
    arrays["bm32"] = PallasShardApply(parity).bm32
    return arrays


@pytest.mark.parametrize("plugin,profile", [
    ("jax_rs", {"k": "8", "m": "4", "technique": "reed_sol_van"}),
    ("jax_rs", {"k": "10", "m": "4", "technique": "cauchy_good"}),
    ("jax_rs", {"k": "4", "m": "2", "technique": "reed_sol_van", "w": "32"}),
    ("xor", {"k": "3", "m": "1"}),
])
def test_carried_codec_matches_own_and_jax(plugin, profile):
    jec = JaxRegistry().factory(plugin, profile)
    carried = codec_from_reference_arrays(plugin, profile,
                                          reference_arrays(jec), device="cpu")
    own = ErasureCodePluginRegistry().factory(plugin, profile, device="cpu")
    n = own.get_chunk_count()
    payload = np.random.default_rng(n).integers(
        0, 256, 7000, dtype=np.uint8).tobytes()
    enc = carried.encode(list(range(n)), payload)
    assert enc == own.encode(list(range(n)), payload)
    assert enc == jec.encode(list(range(n)), payload)
    lost = list(LOST)[: n - own.get_data_chunk_count()]
    avail = {i: enc[i] for i in range(n) if i not in lost}
    dec = carried.decode(lost, avail)
    assert dec == own.decode(lost, avail) == jec.decode(lost, avail)
    assert all(dec[w] == enc[w] for w in lost)


def test_carried_kernel_constants_are_used():
    profile = {"k": "4", "m": "2"}
    jec = JaxRegistry().factory("jax_rs", profile)
    arrays = reference_arrays(jec)
    ec = codec_from_reference_arrays("jax_rs", profile, arrays, device="cpu")
    applier = ec._engine.applier(arrays["generator"][4:])
    assert applier is ec._engine.applier(jec.generator[4:])
    assert applier.mout == 2 and applier.kin == 4


def test_carried_arrays_are_checked():
    profile = {"k": "4", "m": "2"}
    jec = JaxRegistry().factory("jax_rs", profile)
    arrays = reference_arrays(jec)
    with pytest.raises(ValueError):
        codec_from_reference_arrays(
            "jax_rs", profile, dict(arrays, generator=jec.generator[:5]),
            device="cpu")
    other = PallasShardApply(jec.generator[:2]).bm32   # not the parity rows
    with pytest.raises(ValueError):
        codec_from_reference_arrays("jax_rs", profile,
                                    dict(arrays, bm32=other), device="cpu")


def _generator_arrays(jcode) -> dict:
    """A generator codec's carried arrays (jax_rs, xor, shec)."""
    k = jcode.get_data_chunk_count()
    return {"generator": jcode.generator,
            "bm32": PallasShardApply(jcode.generator[k:]).bm32}


def composite_arrays(plugin, jec) -> dict:
    """The arrays that define a JAX lrc / clay / shec codec's output."""
    if plugin == "lrc":
        return {"layers": [_generator_arrays(l.code) for l in jec.layers]}
    if plugin == "clay":
        return {"mds": _generator_arrays(jec.mds), "pair": jec.pair.P}
    return _generator_arrays(jec)


@pytest.mark.parametrize("plugin,profile", [
    ("shec", {"k": "6", "m": "4", "c": "3"}),
    ("lrc", {"k": "8", "m": "4", "l": "3"}),
    ("clay", {"k": "6", "m": "3", "d": "8"}),
    ("clay", {"k": "4", "m": "2", "scalar_mds": "shec"}),
])
def test_carried_composite_codec_matches_own_and_jax(plugin, profile):
    jec = JaxRegistry().factory(plugin, profile)
    carried = codec_from_reference_arrays(
        plugin, profile, composite_arrays(plugin, jec), device="cpu")
    own = ErasureCodePluginRegistry().factory(plugin, profile, device="cpu")
    n, k = own.get_chunk_count(), own.get_data_chunk_count()
    payload = np.random.default_rng(n).integers(
        0, 256, k * own.get_chunk_size(1) - 3, dtype=np.uint8).tobytes()
    enc = carried.encode(list(range(n)), payload)
    assert enc == own.encode(list(range(n)), payload)
    assert enc == jec.encode(list(range(n)), payload)
    lost = [1, n - 1]
    avail = {i: enc[i] for i in range(n) if i not in lost}
    dec = carried.decode(lost, avail)
    assert dec == jec.decode(lost, avail)
    assert all(dec[w] == enc[w] for w in lost)


def test_carried_composite_arrays_are_checked():
    profile = {"k": "4", "m": "2", "d": "5"}
    jec = JaxRegistry().factory("clay", profile)
    arrays = composite_arrays("clay", jec)
    with pytest.raises(ValueError):           # a zero in the 2x2 transform
        codec_from_reference_arrays("clay", profile,
                                    dict(arrays, pair=np.eye(2, dtype=np.uint8)),
                                    device="cpu")
    lrc = JaxRegistry().factory("lrc", {"k": "4", "m": "2", "l": "3"})
    with pytest.raises(ValueError):           # one layer short
        codec_from_reference_arrays(
            "lrc", {"k": "4", "m": "2", "l": "3"},
            {"layers": composite_arrays("lrc", lrc)["layers"][:-1]},
            device="cpu")


def _clay_operator(lost):
    jec = JaxRegistry().factory("clay", {"k": "8", "m": "4", "d": "11"})
    return clay_repair_operator(jec, lost)[0]


def plan_arrays(plan) -> dict:
    return {"groups": plan.groups, "cols": plan.cols, "bms": plan.bms,
            "gather_rows": plan.gather_rows}


@pytest.mark.parametrize("lost", [0, 3])
def test_carried_grouped_plan_matches_jax(lost):
    R = _clay_operator(lost)
    jplan = GroupedPlan(R)
    eng = BitplaneEngine(device="cpu")
    applier = install_grouped_reference(eng, R, plan_arrays(jplan))
    assert eng.grouped_applier(R) is applier
    data = np.random.default_rng(lost).integers(0, 256, (176, 512), np.uint8)
    want = np.asarray(PallasGroupedApply(R, interpret=True, plan=jplan)(data))
    assert np.array_equal(eng.apply(R, data).numpy(), want)


def test_carried_grouped_plan_is_checked():
    R = _clay_operator(3)
    arrays = plan_arrays(GroupedPlan(R))
    eng = BitplaneEngine(device="cpu")
    bad = np.array(arrays["bms"])
    bad[0, 0, 8] ^= 1                  # breaks the lane expansion
    with pytest.raises(ValueError):
        install_grouped_reference(eng, R, dict(arrays, bms=bad))
    with pytest.raises(ValueError):    # a plan of another matrix
        install_grouped_reference(eng, _clay_operator(0), arrays)
    with pytest.raises(ValueError):
        install_grouped_reference(
            eng, R, dict(arrays, gather_rows=arrays["gather_rows"][::-1]))
