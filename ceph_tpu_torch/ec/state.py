"""Carry a codec's matrices across from the JAX package.

For a storage codec the state that defines its output is its matrices:
the generator (GF(2^8) codes) or the full GF(2) bitmatrix (packet codes),
the lane-expanded bitmatrix its kernel applies, and the decode matrices it
has built.  ``codec_from_reference_arrays`` takes those as numpy arrays,
as read off a ``ceph_tpu`` codec, and builds the port's codec to apply
exactly them, so both sides provably apply the same matrices.

This module imports nothing of the JAX package: the caller reads the
arrays (``reference_arrays`` in the port's tests shows which).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from ceph_tpu_torch.ec.cuda_kernels import ShardApply
from ceph_tpu_torch.ec.engine import BitplaneEngine
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry


def codec_from_reference_arrays(plugin: str, profile: Mapping[str, str],
                                arrays: Mapping, device=None):
    """A port codec of ``plugin``/``profile`` that applies the given arrays.

    ``arrays`` holds:

    - ``"generator"``: (k+m, k) uint8, for GF(2^8) codes;
    - ``"full_bm"``: ((k+m)*w, k*w) uint8, for packet codes;
    - ``"bm32"`` (optional): the lane-expanded int8 bitmatrix of the parity
      rows (``PallasShardApply.bm32``, zero-padded columns allowed).  The
      encode kernel's constants are built from it, after checking that it
      is the lane expansion of a GF(2) bitmatrix;
    - ``"decode"`` (optional): {(survivors, wanted): decode matrix}.

    The profile is parsed as usual (it validates k, m, technique and w);
    then the carried arrays replace the codec's own, after a shape check.
    The codec gets an engine of its own, so the carried kernel constants
    serve only it.
    """
    ec = ErasureCodePluginRegistry().factory(plugin, profile, device=device)
    engine = ec._engine = BitplaneEngine(ec.device)
    k, n = ec.get_data_chunk_count(), ec.get_chunk_count()
    if ec.full_bm is None:
        gen = np.asarray(arrays["generator"], np.uint8)
        if gen.shape != (n, k):
            raise ValueError(f"generator {gen.shape}, codec needs {(n, k)}")
        ec.generator = gen
        parity = gen[k:]
    else:
        full = np.asarray(arrays["full_bm"], np.uint8)
        if full.shape != ec.full_bm.shape:
            raise ValueError(f"full_bm {full.shape}, codec needs "
                             f"{ec.full_bm.shape}")
        ec.full_bm = full
        parity = full[k * ec.w:]
    if "bm32" in arrays:
        applier = ShardApply.from_lane_bitmatrix(arrays["bm32"],
                                                 parity.shape[1])
        if not np.array_equal(applier.consts.bitmatrix,
                              ShardApply(parity).consts.bitmatrix):
            raise ValueError("bm32 does not belong to the carried matrix")
        engine.install_applier(parity, applier)
    for (survivors, wanted), D in arrays.get("decode", {}).items():
        ec._decode_matrix_cache.put(
            (tuple(int(s) for s in survivors), tuple(int(w) for w in wanted)),
            np.asarray(D, np.uint8))
    return ec
