"""CLAY sub-chunk repair: the mesh repair, plane ranges, batched repair,
interconnect bytes.

Counterpart of ceph_tpu/parallel/clay_sharding.py.  CLAY k=8 m=4 d=11
single-chunk repair reads only sub_chunk_no/q of each of the d helper
chunks (reference ErasureCodeClay.cc:462-646, get_repair_subchunks
:366-380).  On a mesh the helper reads become collectives: each 'cs'-group
slot holds a slice of the chunk axis, extracts just the repair planes (1/q
of its bytes — the regenerating-code bandwidth saving rides the
interconnect), and an all_gather assembles the helper set per group.  The
repair schedule itself is a fixed GF(2^8)-linear map
(ceph_tpu_torch.ec.repair_operator), so the post-gather compute is ONE
engine apply of the sparse operator R per slot, which the engine sends to
the grouped kernel (``cuda_kernels.gf2_apply_grouped``, or the paired
kernel for operators whose group tables are large).
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch.ec.engine import default_engine
from ceph_tpu_torch.ec.repair_operator import clay_repair_operator
from ceph_tpu_torch.parallel.mesh import (NamedSharding, PartitionSpec as P,
                                          ShardedTensor, all_gather,
                                          device_put, index_on, per_slot,
                                          placed)


def sharded_clay_repair(mesh, ec, chunks, lost: int) -> ShardedTensor:
    """Repair chunk ``lost`` of a (B, k+m, C) encoded batch over the mesh.

    The chunk axis is sharded over 'cs' (each slot holds (k+m)/cs shard
    columns), the stripe batch over 'dp'.  ``chunks``: numpy or a tensor.
    Returns (B, C) recovered chunks, bit-identical to the single-device
    plugin repair.
    """
    B, n, C = chunks.shape
    cs = mesh.shape["cs"]
    if n % cs:
        raise ValueError(f"k+m={n} must be divisible by cs={cs}")
    if C % ec.sub_chunk_no:
        raise ValueError(f"C={C} not a multiple of {ec.sub_chunk_no}")
    R, helpers, planes = clay_repair_operator(ec, lost)
    sub = ec.sub_chunk_no
    d, pcnt = len(helpers), len(planes)

    spec = P("dp", "cs", None)
    dev = device_put(chunks, NamedSharding(mesh, spec))
    slots = mesh.slots()
    plane_idx = index_on(planes, slots)
    helper_idx = index_on(helpers, slots)

    def extract(slot, blk):  # (b, n/cs, C) per slot
        b = blk.shape[0]
        local = blk.reshape(b, n // cs, sub, C // sub)
        # Repair-plane extraction BEFORE the collective: only 1/q of
        # the helper bytes cross between slots.  (b, n/cs, P, sc)
        return local.index_select(2, plane_idx[slot.device])

    local = per_slot(extract, slots, dev.blocks())
    full = all_gather(mesh, "cs", local, dim=1)  # (b, n, P, sc)

    def repair(slot, f):
        b = f.shape[0]
        helper = f.index_select(1, helper_idx[slot.device])  # drops the lost
        flat = helper.reshape(b, d * pcnt, C // sub)
        # Engine dispatch: the grouped kernel on a GPU, its plain
        # version on the CPU.
        rec = default_engine(slot.device).apply(R, flat)  # (b, sub, sc)
        return rec.reshape(b, C)

    return placed(mesh, P("dp", None), per_slot(repair, slots, full),
                  (B, C))


def clay_plane_ranges(planes, sc: int) -> list[tuple[int, int]]:
    """Coalesce repair-plane indices into (offset, length) byte ranges
    inside ONE stripe's chunk bytes (the (sub_chunk_no, sc) layout).

    The repair engine reads survivor shards by these ranges instead of
    whole chunks — consecutive planes merge into one ranged read, so a
    q=4 profile issues at most sub_chunk_no/q reads per helper stripe
    and ships exactly 1/q of the helper's bytes."""
    runs: list[tuple[int, int]] = []
    start = prev = None
    for p in sorted(int(x) for x in planes):
        if prev is not None and p == prev + 1:
            prev = p
            continue
        if start is not None:
            runs.append((start * sc, (prev - start + 1) * sc))
        start = prev = p
    if start is not None:
        runs.append((start * sc, (prev - start + 1) * sc))
    return runs


def batched_clay_plane_repair_device(ec, R, helper_planes,
                                     out=None) -> torch.Tensor:
    """Recover a batch of lost chunks from pre-extracted helper planes, on
    the codec's device.

    ``helper_planes``: (b, d*P, sc) uint8 (a tensor on the codec's device,
    or numpy) — each row stacks the d helpers' P repair planes in
    helper-ascending order (the layout ``clay_repair_operator`` probed R
    against).  Returns a (b, C) tensor, bit-identical to the plugin
    repair.  ONE engine apply for the whole batch, read strided as it lies
    (no transpose to a (d*P, b*sc) layout), into ``out`` (a contiguous
    (b, C) tensor) when given."""
    eng = default_engine(ec.device)
    helper_planes = eng.tensor(helper_planes)
    if helper_planes.ndim != 3:
        raise ValueError(
            f"helper_planes shape {tuple(helper_planes.shape)} != (b, d*P, sc)"
        )
    b, _, sc = helper_planes.shape
    if out is not None:
        out = out.view(b, ec.sub_chunk_no, sc)
    rec = eng.apply(np.asarray(R, np.uint8), helper_planes, out)
    return rec.reshape(b, ec.sub_chunk_no * sc)


def batched_clay_plane_repair(ec, R, helper_planes) -> np.ndarray:
    """batched_clay_plane_repair_device with numpy in and out (the JAX
    function's contract): (b, d*P, sc) -> (b, C)."""
    return batched_clay_plane_repair_device(
        ec, R, np.asarray(helper_planes, np.uint8)).cpu().numpy()


def clay_repair_ici_bytes(ec, n_helpers: int, batch: int,
                          chunk_size: int) -> tuple[int, int]:
    """(moved, whole) modeled interconnect bytes for one sub-chunk
    repair launch of ``batch`` stripes.

    moved: what a plane-extracted gather ships — each of the d helpers
    contributes only its repair planes, 1/q of its bytes (the
    regenerating-code saving).  whole: the counterfactual a classic RS
    decode moves — k full survivor chunks to the repair site.  The ratio
    is q*k/d >= 2 for every supported CLAY profile.
    """
    moved = n_helpers * batch * (chunk_size // ec.q)
    whole = ec.k * batch * chunk_size
    return moved, whole


def sharded_clay_repair_check(mesh) -> None:
    """Dryrun/test probe: encode, repair over the mesh, verify bit-identity
    against the encoded chunk and the single-device plugin repair."""
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry

    ec = ErasureCodePluginRegistry().factory(
        "clay", {"k": "8", "m": "4", "d": "11"},
        device=mesh.slots()[0].device,
    )
    dp = mesh.shape["dp"]
    B = 2 * dp
    sc = 4
    C = ec.sub_chunk_no * sc
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, (B, ec.k, C), np.uint8)
    chunks = ec.encode_chunks_batch(data)
    lost = 3
    got = np.asarray(sharded_clay_repair(mesh, ec, chunks, lost))
    if not np.array_equal(got, chunks[:, lost]):
        raise AssertionError("sharded clay repair diverged from encode")
    # Cross-check one stripe against the plugin's host repair path.
    minimum = ec.minimum_to_decode(
        [lost], [i for i in range(ec.get_chunk_count()) if i != lost]
    )
    planes = ec._repair_planes(ec._node_of(lost))
    helper_bytes = {
        h: np.ascontiguousarray(
            chunks[0, h].reshape(ec.sub_chunk_no, sc)[planes]
        ).tobytes()
        for h in minimum
    }
    host = ec._repair([lost], helper_bytes, chunk_size=C)
    if host[lost] != chunks[0, lost].tobytes():
        raise AssertionError("plugin clay repair diverged from encode")
