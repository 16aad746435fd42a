"""LRC group-local repair: batched repair and interconnect bytes.

Counterpart of ceph_tpu/parallel/lrc_sharding.py, its single-device host
functions (``batched_lrc_group_repair``, ``lrc_repair_ici_bytes``).  The
group-local mesh repair (``make_group_mesh``, ``sharded_lrc_repair``)
waits for the port's multi-device planes (ROADMAP A10).

An lrc kml profile places every chunk in a local group of l+1 members; a
single lost chunk repairs from its group alone (cheapest-layer decode,
reference ErasureCodeLrc.cc:566-735 minimum_to_decode + decode).  That
decode is a fixed GF(2^8)-linear map of the group members
(ceph_tpu_torch.ec.repair_operator.lrc_repair_operator), so a batch of
repairs is one engine apply.
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.ec.engine import default_engine


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
