"""CLAY sub-chunk repair: plane ranges, batched repair, interconnect bytes.

Counterpart of ceph_tpu/parallel/clay_sharding.py, its single-device host
functions (``clay_plane_ranges``, ``batched_clay_plane_repair``,
``clay_repair_ici_bytes``).  The mesh repair (``sharded_clay_repair``)
is multi-device and waits for the port's multi-device planes (ROADMAP
A10).

CLAY k=8 m=4 d=11 single-chunk repair reads only sub_chunk_no/q of each of
the d helper chunks (reference ErasureCodeClay.cc:462-646,
get_repair_subchunks :366-380).  The repair schedule is a fixed GF(2^8)-
linear map (ceph_tpu_torch.ec.repair_operator), so a batch of repairs is
ONE engine apply of the sparse operator R, which the engine sends to the
grouped kernel (``cuda_kernels.gf2_apply_grouped``, or the paired kernel
for operators whose group tables are large).
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch.ec.engine import default_engine


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


def batched_clay_plane_repair_device(ec, R, helper_planes) -> torch.Tensor:
    """Recover a batch of lost chunks from pre-extracted helper planes, on
    the codec's device.

    ``helper_planes``: (b, d*P, sc) uint8 (a tensor on the codec's device,
    or numpy) — each row stacks the d helpers' P repair planes in
    helper-ascending order (the layout ``clay_repair_operator`` probed R
    against).  Returns a (b, C) tensor, bit-identical to the plugin
    repair.  ONE engine apply for the whole batch, read strided as it lies
    (no transpose to a (d*P, b*sc) layout)."""
    eng = default_engine(ec.device)
    helper_planes = eng.tensor(helper_planes)
    if helper_planes.ndim != 3:
        raise ValueError(
            f"helper_planes shape {tuple(helper_planes.shape)} != (b, d*P, sc)"
        )
    b, _, sc = helper_planes.shape
    rec = eng.apply(np.asarray(R, np.uint8), helper_planes)
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
