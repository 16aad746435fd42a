"""CPU reference encoder/decoder — the bit-exactness oracle.

Port copy of ceph_tpu/ec/reference.py: same numpy code, kept here so the port
imports nothing of the JAX package.

Plays the role Ceph's non-regression corpus plays
(reference qa/workunits/erasure-code/encode-decode-non-regression.sh:19-30):
every device path (XLA bitplane matmul, Pallas kernels, sharded repair) must
reproduce these bytes exactly. Pure numpy, exact integer math.
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.ec import bitmatrix as bm
from ceph_tpu_torch.ec.gf import gf_inv_matrix, gf_matmul


def encode(generator: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Systematic encode: (k+m, k) generator x (k, C) data -> (k+m, C) chunks.

    Semantics of ErasureCode::encode driving encode_chunks
    (reference src/erasure-code/ErasureCode.cc encode/encode_chunks): data
    chunks are passed through, parity rows are GF matrix-vector products.
    """
    k = generator.shape[1]
    data = np.asarray(data, np.uint8)
    if data.shape[0] != k:
        raise ValueError(f"data must have k={k} rows, got {data.shape[0]}")
    parity = gf_matmul(generator[k:], data)
    return np.concatenate([data, parity], axis=0)


def decode_matrix(
    generator: np.ndarray,
    survivors: list[int],
    wanted: list[int],
) -> np.ndarray:
    """Coefficient matrix mapping k survivor chunks -> wanted chunks.

    ``survivors`` must hold exactly k distinct available chunk ids (the
    output of minimum_to_decode); ``wanted`` is any set of chunk ids.
    Analog of the decode-matrix build inside jerasure_matrix_decode
    (reference ErasureCodeJerasure.cc:170).
    """
    k = generator.shape[1]
    if len(survivors) != k:
        raise ValueError(f"need exactly k={k} survivors, got {len(survivors)}")
    sub = generator[list(survivors)]
    inv = gf_inv_matrix(sub)  # survivors -> original data
    return gf_matmul(generator[list(wanted)], inv)


def decode(
    generator: np.ndarray,
    chunks: dict[int, np.ndarray],
    wanted: list[int],
) -> dict[int, np.ndarray]:
    """Reconstruct ``wanted`` chunk ids from >=k available chunks."""
    k = generator.shape[1]
    avail = sorted(chunks)
    if len(avail) < k:
        raise ValueError(f"need >=k={k} chunks, have {len(avail)}")
    survivors = avail[:k]
    D = decode_matrix(generator, survivors, wanted)
    stacked = np.stack([np.asarray(chunks[i], np.uint8) for i in survivors])
    out = gf_matmul(D, stacked)
    return {w: out[i] for i, w in enumerate(wanted)}


def encode_bitplane(generator: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Encode via the GF(2) bitplane-matmul formulation (numpy).

    Algorithmically identical to the device engine's plain path: unpack ->
    integer matmul
    -> mod 2 -> pack. Used to validate the formulation without a device.
    """
    k = generator.shape[1]
    B = bm.gf_matrix_to_bitmatrix(generator[k:])
    bits = bm.bytes_to_bitplanes(np.asarray(data, np.uint8))
    pbits = (B.astype(np.int32) @ bits.astype(np.int32)) & 1
    parity = bm.bitplanes_to_bytes(pbits.astype(np.uint8))
    return np.concatenate([np.asarray(data, np.uint8), parity], axis=0)
