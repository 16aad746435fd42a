"""Matrices carried across from a JAX codec build a port codec that encodes
and decodes exactly as the port's own codec and the JAX codec do."""

import numpy as np
import pytest

from ceph_tpu.ec.pallas_kernels import PallasShardApply
from ceph_tpu.ec.registry import ErasureCodePluginRegistry as JaxRegistry
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.ec.state import codec_from_reference_arrays

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
