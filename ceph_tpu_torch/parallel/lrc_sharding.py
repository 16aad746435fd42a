"""LRC group-local repair over the mesh, batched repair and interconnect
bytes.

Counterpart of ceph_tpu/parallel/lrc_sharding.py.  An lrc kml profile
places every chunk in a local group of l+1 members; a single lost chunk
repairs from its group alone (cheapest-layer decode, reference
ErasureCodeLrc.cc:566-735 minimum_to_decode + decode).  On a mesh each
group's chunks are split over a dedicated 'gs' sub-axis, so the repair
all_gather runs ONLY inside the group, never across groups — the locality
that makes LRC repair cheap rides the interconnect topology.

BASELINE.md names k=12 m=4 l=3; the kml form requires l | k+m (reference
ErasureCodeLrc.cc:305 and _parse_kml here), and 16 % 3 != 0, so the
nearest valid profile k=12 m=4 l=4 (archived in the corpus) is used.

The cheapest-layer decode is a fixed GF(2^8)-linear map of the group
members (ceph_tpu_torch.ec.repair_operator.lrc_repair_operator), so
post-gather compute is one engine apply per slot.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch.ec.engine import default_engine
from ceph_tpu_torch.ec.repair_operator import lrc_repair_operator
from ceph_tpu_torch.parallel.mesh import (Mesh, NamedSharding,
                                          PartitionSpec as P, all_gather,
                                          device_put, per_slot, upload)

# Profile used by sharded_lrc_repair_check (and the dryrun gate): 4 local
# groups of l+1 = 5 chunks.  Callers needing the device-count constraint
# use LRC_CHECK_GROUPS rather than re-deriving it.
LRC_CHECK_PROFILE = {"k": "12", "m": "4", "l": "4"}
LRC_CHECK_GROUPS = 4


def make_group_mesh(devices, groups: int) -> Mesh:
    """Mesh ('dp', 'grp', 'gs'): one 'grp' row per LRC local group, the
    group's chunks split over 'gs' devices."""
    devices = list(devices)
    n = len(devices)
    if n % groups:
        raise ValueError(f"{groups} LRC groups must divide {n} devices")
    gs = n // groups
    arr = np.array(devices, dtype=object).reshape(1, groups, gs)
    return Mesh(arr, ("dp", "grp", "gs"))


def sharded_lrc_repair(mesh, ec, chunks, lost: int) -> np.ndarray:
    """Repair chunk ``lost`` of a (B, n, C) encoded batch; group-local.
    ``chunks``: numpy or a tensor.

    Returns (B, C), bit-identical to the plugin's cheapest-layer decode.
    """
    slots = mesh.slots()
    if not isinstance(chunks, torch.Tensor):
        chunks = upload(np.asarray(chunks, np.uint8), slots[0].device)
    B, n, C = chunks.shape
    groups = mesh.shape["grp"]
    gs = mesh.shape["gs"]
    if n % groups:
        raise ValueError(f"chunk count {n} must split into {groups} groups")
    per_group = n // groups
    gpad = -(-per_group // gs) * gs  # pad so 'gs' divides the group slice
    g_lost = lost // per_group

    coeffs, minimum = lrc_repair_operator(ec, lost)
    # Lift the minimum-chunk coefficients onto the padded group slots.
    row = np.zeros((1, gpad), np.uint8)
    for j, cid in enumerate(minimum):
        if cid // per_group != g_lost:
            raise ValueError(
                f"minimum chunk {cid} outside lost group {g_lost}; "
                "profile is not group-local"
            )
        row[0, cid - g_lost * per_group] = coeffs[0, j]
    row = np.frombuffer(row.tobytes(), np.uint8).reshape(row.shape)

    padded = torch.zeros((B, groups, gpad, C), dtype=torch.uint8,
                         device=chunks.device)
    padded[:, :, :per_group] = chunks.reshape(B, groups, per_group, C)
    dev = device_put(
        padded.reshape(B, groups, gs, gpad // gs, C),
        NamedSharding(mesh, P("dp", "grp", "gs", None, None)),
    )

    # Group-local collective: gathers ONLY over each group's 'gs' slots;
    # other groups' chunks never move.
    grp = all_gather(mesh, "gs", [blk[:, 0, 0] for blk in dev.blocks()],
                     dim=1)  # (b, gpad, C)
    # Engine dispatch: the shard kernel on a GPU, its plain version on
    # the CPU.
    rec = per_slot(
        lambda slot, g: default_engine(slot.device).apply(row, g)[:, 0],
        slots, grp)  # (b, C)
    # Only the lost group's recovered chunks leave the mesh (the gs rows
    # are identical; take the first).
    return rec[mesh.groups("gs")[g_lost][0]].cpu().numpy()


def batched_lrc_group_repair(ec, coeffs, group_chunks) -> np.ndarray:
    """Recover a batch of lost chunks from their local-group members.

    ``group_chunks``: (b, L, C) uint8 — the ``minimum`` chunks of each
    stripe in ``lrc_repair_operator`` order.  Returns (b, C), bit-
    identical to the plugin's cheapest-layer decode.  ONE engine apply
    for the whole batch (only the local group was ever read; the k-L
    remote chunks never moved)."""
    group_chunks = np.asarray(group_chunks, np.uint8)
    if group_chunks.ndim != 3:
        raise ValueError(
            f"group_chunks shape {group_chunks.shape} != (b, L, C)"
        )
    rec = default_engine(ec.device).apply(
        np.asarray(coeffs, np.uint8), group_chunks)
    return rec.cpu().numpy().reshape(
        group_chunks.shape[0], group_chunks.shape[2])


def lrc_repair_ici_bytes(ec, n_helpers: int, batch: int,
                         chunk_size: int) -> tuple[int, int]:
    """(moved, whole) modeled interconnect bytes for one group-local
    repair launch of ``batch`` stripes.

    moved: a group-local gather ships only the lost chunk's l group
    members (``n_helpers`` = the minimum_to_decode set).  whole: the
    counterfactual a non-locality-aware decode moves — k full survivor
    chunks.  Ratio k/l >= 2 for every kml profile worth deploying
    (locality below that defeats LRC's point)."""
    moved = n_helpers * batch * chunk_size
    whole = ec.get_data_chunk_count() * batch * chunk_size
    return moved, whole


def sharded_lrc_repair_check(mesh_or_devices) -> None:
    """Dryrun/test probe: kml LRC repair over a group-local mesh."""
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry

    devices = (
        list(np.asarray(mesh_or_devices.devices).ravel())
        if isinstance(mesh_or_devices, Mesh)
        else list(mesh_or_devices)
    )
    ec = ErasureCodePluginRegistry().factory(
        "lrc", LRC_CHECK_PROFILE, device=devices[0].device)
    n = ec.get_chunk_count()
    groups = len(ec.layers) - 1  # one local layer per group
    assert groups == LRC_CHECK_GROUPS, "profile/constant drifted"
    if len(devices) % groups:
        raise ValueError(
            f"need a multiple of {groups} devices, got {len(devices)}"
        )
    mesh = make_group_mesh(devices, groups)
    C = ec.get_chunk_size(12 * 64)
    rng = np.random.default_rng(13)
    B = 4
    data = rng.integers(0, 256, (B, ec.get_data_chunk_count(), C), np.uint8)
    chunks = ec.encode_chunks_batch(data)
    for lost in (0, 6):
        got = sharded_lrc_repair(mesh, ec, chunks, lost)
        if not np.array_equal(got, np.asarray(chunks)[:, lost]):
            raise AssertionError(
                f"sharded lrc repair of chunk {lost} diverged"
            )
