"""The port's mesh planes against the JAX package's, exact.

tests/test_sharding.py's cases on both packages: the JAX package on its
8 forced CPU devices (tests/conftest.py), the port on 8 slots forced
over the CPU, the same seeded numpy inputs to both.  ``sharded_encode``,
``distributed_ec_step`` (shard slices and repaired chunk),
``sharded_clay_repair``, ``sharded_lrc_repair``, the ``ShardedApplier``
outputs and ``shard_layout`` dicts must be byte-equal across the
packages; the port's shardings must place every block where JAX's do.
Then the port's mesh module alone: forced slots, placement traffic and
the collectives' semantics.  Tolerance 0.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

from ceph_tpu.ec import matrix as jmatrix
from ceph_tpu.ec import reference as jreference
from ceph_tpu.ec.registry import ErasureCodePluginRegistry as JRegistry
from ceph_tpu.parallel import clay_sharding as jclay
from ceph_tpu.parallel import ec_sharding as jes
from ceph_tpu.parallel import lrc_sharding as jlrc
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.parallel import clay_sharding, ec_sharding, lrc_sharding
from ceph_tpu_torch.parallel import mesh as M

NDEV = 8


def _rand(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.fixture(autouse=True)
def slots():
    assert len(jax.devices()) == NDEV, "conftest must provide 8 devices"
    with M.forced_device_count(NDEV, device="cpu") as got:
        yield got


def meshes(cs):
    return jes.make_ec_mesh(cs=cs), ec_sharding.make_ec_mesh(cs=cs)


def codecs(plugin, profile):
    return (JRegistry().factory(plugin, dict(profile)),
            ErasureCodePluginRegistry().factory(plugin, dict(profile),
                                                device="cpu"))


@pytest.mark.parametrize("cs", [1, 2, 4])
def test_sharded_encode_equals_the_reference(cs):
    jm, pm = meshes(cs)
    k, m = 8, 4
    G = jmatrix.generator_matrix("reed_sol_van", k, m)
    data = _rand((16, k, 256), seed=1)
    want = np.asarray(jes.sharded_encode(jm, G, data))
    got = ec_sharding.sharded_encode(pm, G, data)
    assert got.shape == (16, k + m, 256)
    assert np.array_equal(np.asarray(got), want)
    for b in range(16):
        assert np.array_equal(want[b], jreference.encode(G, data[b]))
    assert ec_sharding.shard_layout(got) == jes.shard_layout(
        jes.sharded_encode(jm, G, data))


@pytest.mark.parametrize("lost_chunk", [0, 7, 11])
def test_distributed_step_fanout_and_repair(lost_chunk):
    jm, pm = meshes(4)                # dp=2, cs=4
    k, m = 8, 4                       # k+m=12 divisible by cs=4
    G = jmatrix.generator_matrix("cauchy_good", k, m)
    B = 16                            # divisible by dp*cs=8
    data = _rand((B, k, 256), seed=2 + lost_chunk)
    j_shard, j_rep = jes.distributed_ec_step(jm, G, data, lost_chunk)
    p_shard, p_rep = ec_sharding.distributed_ec_step(pm, G, data,
                                                     lost_chunk)
    assert np.array_equal(np.asarray(p_shard), np.asarray(j_shard))
    assert np.array_equal(np.asarray(p_rep), np.asarray(j_rep))
    expect = np.stack([jreference.encode(G, data[b]) for b in range(B)])
    assert np.array_equal(np.asarray(p_shard), expect)
    assert np.array_equal(np.asarray(p_rep), expect[:, lost_chunk])
    # each slot holds the block JAX's device of the same id holds
    j_blocks = {s.device.id: np.asarray(s.data)
                for s in j_shard.addressable_shards}
    for s in p_shard.addressable_shards:
        assert np.array_equal(s.data.numpy(), j_blocks[s.device.id])


def test_mesh_validation():
    with pytest.raises(ValueError):
        ec_sharding.make_ec_mesh(cs=3)      # does not divide 8
    mesh = ec_sharding.make_ec_mesh(cs=2)
    G = jmatrix.generator_matrix("reed_sol_van", 4, 1)  # k+m=5
    with pytest.raises(ValueError):
        ec_sharding.distributed_ec_step(mesh, G, _rand((8, 4, 128)))
    with pytest.raises(ValueError):         # 12 stripes do not split 8 ways
        ec_sharding.sharded_encode(mesh, G, _rand((12, 4, 128)))


def test_sharded_clay_repair_equals_the_reference():
    """BASELINE config #4: CLAY d-helper sub-chunk repair over the mesh,
    the recovered chunks equal across the packages."""
    jm, pm = meshes(4)
    jec, pec = codecs("clay", {"k": "8", "m": "4", "d": "11"})
    sc = 16
    C = jec.sub_chunk_no * sc
    data = _rand((8, 8, C), seed=11)
    chunks = np.asarray(jec.encode_chunks_batch(data))
    assert np.array_equal(pec.encode_chunks_batch(data), chunks)
    for lost in (0, 3, 11):
        want = np.asarray(jclay.sharded_clay_repair(jm, jec, chunks, lost))
        got = clay_sharding.sharded_clay_repair(pm, pec, chunks, lost)
        assert np.array_equal(np.asarray(got), want)
        assert np.array_equal(want, chunks[:, lost])
    clay_sharding.sharded_clay_repair_check(pm)


def test_sharded_lrc_group_repair_equals_the_reference():
    """BASELINE config #5: LRC group-local all_gather repair."""
    jec, pec = codecs("lrc", lrc_sharding.LRC_CHECK_PROFILE)
    jm = jlrc.make_group_mesh(jax.devices(), 4)
    pm = lrc_sharding.make_group_mesh(M.local_devices("cpu"), 4)
    assert dict(pm.shape) == dict(jm.shape)
    C = jec.get_chunk_size(12 * 64)
    data = _rand((8, 12, C), seed=13)
    chunks = np.asarray(jec.encode_chunks_batch(data))
    for lost in (0, 6, 13):
        want = jlrc.sharded_lrc_repair(jm, jec, chunks, lost)
        got = lrc_sharding.sharded_lrc_repair(pm, pec, chunks, lost)
        assert np.array_equal(got, want)
        assert np.array_equal(want, chunks[:, lost])
    lrc_sharding.sharded_lrc_repair_check(M.local_devices("cpu"))
    with pytest.raises(ValueError):
        lrc_sharding.make_group_mesh(M.local_devices("cpu")[:6], 4)


@pytest.mark.parametrize("batch", [1, 3, 8, 13])
def test_sharded_applier_equals_the_reference(batch):
    jm, pm = meshes(2)
    G = jmatrix.generator_matrix("cauchy_good", 4, 2)
    data = _rand((batch, 4, 64), seed=batch)
    want = jes.ShardedApplier(jm, G[4:])(data)
    got = ec_sharding.ShardedApplier(pm, G[4:])(data)
    assert isinstance(got, np.ndarray)
    assert np.array_equal(got, want)
    padded = _rand((16, 4, 64), seed=batch)
    j_ap, p_ap = jes.ShardedApplier(jm, G[4:]), \
        ec_sharding.ShardedApplier(pm, G[4:])
    j_x, p_x = j_ap.place(padded), p_ap.place(padded)
    assert ec_sharding.shard_layout(p_x) == jes.shard_layout(j_x)
    assert np.array_equal(np.asarray(p_ap.run_placed(p_x)),
                          np.asarray(j_ap.run_placed(j_x)))


def test_sharded_applier_place_of_a_tensor_moves_nothing():
    """A device-resident batch on the slots' device is split into views:
    no host bytes, no device move, no copy between slots."""
    mesh = ec_sharding.make_ec_mesh(cs=1)
    ap = ec_sharding.ShardedApplier(mesh, np.array([[1, 2, 3, 4]], np.uint8))
    batch = torch.from_numpy(_rand((16, 4, 64), seed=5))
    M.reset_traffic()
    x = ap.place(batch)
    assert M.TRAFFIC == {"host": 0, "place": 0, "slot": 0}
    assert x.assemble() is batch
    assert all(s.data.data_ptr() == batch[2 * i].data_ptr()
               for i, s in enumerate(x.addressable_shards))
    ap.place(batch.numpy())
    assert M.TRAFFIC == {"host": 0, "place": 0, "slot": 0}  # CPU slots


@pytest.mark.parametrize("spec", [
    (("dp", "cs"), None, None), ("dp", "cs", None), ("dp", None),
    ("cs", "dp"), (None, ("cs", "dp")), ((), None)])
def test_shardings_place_blocks_as_jax_does(spec):
    """Every slot's index equals JAX's ``devices_indices_map`` for the
    device of the same id (replicas included)."""
    jm, pm = meshes(4)
    shape = (16, 24, 4)[:len(spec) + 1]
    j_map = JNamedSharding(jm, JP(*spec)).devices_indices_map(shape)
    want = {d.id: tuple((s.start or 0, shape[i] if s.stop is None
                         else s.stop) for i, s in enumerate(idx))
            for d, idx in j_map.items()}
    got = {slot.id: tuple((s.start, s.stop) for s in idx)
           for slot, idx in M.NamedSharding(pm, M.PartitionSpec(*spec))
           .indices(shape)}
    assert got == want


def test_collectives_follow_jax_semantics():
    """all_to_all and the tiled all_gather over 'cs' on per-slot blocks,
    against numpy, with the bytes between slots counted."""
    pm = ec_sharding.make_ec_mesh(cs=4)
    blocks = [torch.full((2, 8, 3), i, dtype=torch.uint8) for i in range(8)]
    M.reset_traffic()
    a2a = M.all_to_all(pm, "cs", blocks, split_axis=1, concat_axis=0)
    for dst in range(8):
        g, j = divmod(dst, 4)
        want = np.concatenate([np.full((2, 2, 3), 4 * g + s, np.uint8)
                               for s in range(4)])
        assert np.array_equal(a2a[dst].numpy(), want)
    assert M.TRAFFIC["slot"] == 8 * 3 * (2 * 2 * 3)
    gathered = M.all_gather(pm, "cs", blocks, dim=1)
    for dst in range(8):
        g = dst // 4
        assert np.array_equal(gathered[dst].numpy(), np.concatenate(
            [np.full((2, 8, 3), 4 * g + s, np.uint8) for s in range(4)],
            axis=1))


def test_forced_slots():
    """force_device_count is explicit, process-wide and idempotent; the
    context form restores what was there."""
    slots = M.local_devices()
    assert [s.id for s in slots] == list(range(NDEV))
    assert all(s.device == torch.device("cpu") and s.stream is None
               for s in slots)
    M.force_device_count(NDEV, device="cpu")
    assert M.local_devices() == slots          # the same slot objects
    with M.forced_device_count(2, device="cpu") as two:
        assert len(two) == 2 and M.local_devices() == two
    assert M.local_devices() == slots
    with pytest.raises(ValueError):
        M.force_device_count(0, device="cpu")


def test_checks_run_on_the_slots():
    pm = ec_sharding.make_ec_mesh(cs=4)
    from ceph_tpu_torch.parallel import (sharded_clay_repair_check,
                                         sharded_lrc_repair_check)
    sharded_clay_repair_check(pm)
    sharded_lrc_repair_check(pm)
