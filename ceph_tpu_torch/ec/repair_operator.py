"""Repair operators: single-chunk repair as one GF(2^8) matrix.

Port copy of ceph_tpu/ec/repair_operator.py: the same probes, run on a
port codec (on its device), returning the same numpy matrices.

CLAY repair (reference ErasureCodeClay.cc:462-646) and LRC local-layer
repair (reference ErasureCodeLrc.cc:566-735) are schedules of GF(2^8)
constant-multiplies and XORs over helper sub-chunks — i.e. *fixed
GF(2^8)-linear maps* of the helper bytes for a given (profile, lost chunk,
helper set).  Region ops never mix byte positions, so probing the host
plugin once with an identity payload along the byte axis recovers the full
coefficient matrix R in a single decode call:

    helper[sym, s] = 1 if s == sym else 0   =>   out[:, s] = R[:, sym=s]

On the device, repair is then ONE engine apply of R over the gathered
helper sub-chunks: a CLAY operator is sparse, so the engine sends it to the
grouped kernels (ceph_tpu_torch.parallel.clay_sharding).
"""

from __future__ import annotations

import numpy as np


def clay_repair_operator(ec, lost: int) -> tuple[np.ndarray, list[int], list[int]]:
    """Probe a clay codec's single-chunk repair into a matrix.

    Returns ``(R, helpers, planes)``:
    - helpers: the d helper chunk ids, ascending (the order the device
      layout concatenates them in);
    - planes: the repair sub-chunk (plane) indices read from each helper;
    - R: (sub_chunk_no, d*len(planes)) GF(2^8) matrix with
      ``recovered_plane[z] = XOR_sym gf_mul(R[z, sym], helper_flat[sym])``
      where helper_flat stacks each helper's repair planes in order.
    """
    n = ec.get_chunk_count()
    available = [i for i in range(n) if i != lost]
    minimum = ec.minimum_to_decode([lost], available)
    helpers = sorted(minimum)
    lost_node = ec._node_of(lost)
    planes = ec._repair_planes(lost_node)
    n_sym = len(helpers) * len(planes)
    sc = n_sym  # probe width: one byte column per input symbol
    chunks: dict[int, bytes] = {}
    for h_idx, chunk_id in enumerate(helpers):
        block = np.zeros((len(planes), sc), np.uint8)
        for p in range(len(planes)):
            block[p, h_idx * len(planes) + p] = 1
        chunks[chunk_id] = block.tobytes()
    out = ec._repair([lost], chunks, chunk_size=ec.sub_chunk_no * sc)
    R = np.frombuffer(out[lost], np.uint8).reshape(ec.sub_chunk_no, sc)
    return np.ascontiguousarray(R), helpers, planes


def lrc_repair_operator(ec, lost: int) -> tuple[np.ndarray, list[int]]:
    """Probe an lrc codec's cheapest-layer repair of one lost chunk.

    Returns ``(coeffs, minimum)``: minimum is the chunk ids read (the
    local group for a kml profile), and coeffs is (1, len(minimum)) with
    ``recovered = XOR_j gf_mul(coeffs[0, j], chunk[minimum[j]])``.
    """
    n = ec.get_chunk_count()
    available = [i for i in range(n) if i != lost]
    minimum = sorted(ec.minimum_to_decode([lost], available))
    sc = len(minimum)
    avail = {
        chunk_id: np.eye(sc, dtype=np.uint8)[j]
        for j, chunk_id in enumerate(minimum)
    }
    out = ec.decode_chunks(avail, [lost])
    return np.asarray(out[lost], np.uint8)[None, :], minimum
