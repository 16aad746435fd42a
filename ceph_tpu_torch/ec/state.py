"""Carry a codec's matrices across from the JAX package.

For a storage codec the state that defines its output is its matrices:
the generator (GF(2^8) codes) or the full GF(2) bitmatrix (packet codes),
the lane-expanded bitmatrix its kernel applies, the decode matrices it
has built, and for the composite codecs the matrices of their parts (each
LRC layer's codec; CLAY's inner MDS codec and its 2x2 pairwise transform).
A sparse repair operator's state is its grouped plan.  The functions here
take those as numpy arrays, as read off a ``ceph_tpu`` codec or plan, and
build the port's codec or applier to apply exactly them, so both sides
provably apply the same matrices.

This module imports nothing of the JAX package: the caller reads the
arrays (``reference_arrays`` in the port's tests shows which).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from ceph_tpu_torch.ec.cuda_kernels import (
    GroupedApply,
    GroupedPlan,
    ShardApply,
)
from ceph_tpu_torch.ec.engine import BitplaneEngine
from ceph_tpu_torch.ec.plugins.clay import _PairwiseTransform
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry


def codec_from_reference_arrays(plugin: str, profile: Mapping[str, str],
                                arrays: Mapping, device=None):
    """A port codec of ``plugin``/``profile`` that applies the given arrays.

    For jax_rs, xor and shec, ``arrays`` holds:

    - ``"generator"``: (k+m, k) uint8, for GF(2^8) codes;
    - ``"full_bm"``: ((k+m)*w, k*w) uint8, for packet codes;
    - ``"bm32"`` (optional): the lane-expanded int8 bitmatrix of the parity
      rows (``PallasShardApply.bm32``, zero-padded columns allowed).  The
      encode kernel's constants are built from it, after checking that it
      is the lane expansion of a GF(2) bitmatrix;
    - ``"decode"`` (optional, jax_rs and xor): {(survivors, wanted):
      decode matrix}.

    For lrc, ``"layers"``: one such mapping per layer, in layer order.
    For clay, ``"mds"``: one such mapping for the inner MDS codec, and
    ``"pair"``: the 2x2 pairwise transform ``P``.

    The profile is parsed as usual (it validates k, m, technique and w);
    then the carried arrays replace the codec's own, after a shape check.
    Each carried codec gets an engine of its own, so the carried kernel
    constants serve only it.
    """
    ec = ErasureCodePluginRegistry().factory(plugin, profile, device=device)
    if plugin == "lrc":
        layers = list(arrays["layers"])
        if len(layers) != len(ec.layers):
            raise ValueError(f"{len(layers)} layer arrays for "
                             f"{len(ec.layers)} layers")
        for layer, layer_arrays in zip(ec.layers, layers):
            _carry(layer.code, layer_arrays)
    elif plugin == "clay":
        _carry(ec.mds, arrays["mds"])
        ec.pair = _PairwiseTransform(np.asarray(arrays["pair"], np.uint8),
                                     ec.device)
    else:
        _carry(ec, arrays)
    return ec


def _carry(ec, arrays: Mapping) -> None:
    """Replace a generator codec's matrices (jax_rs, xor or shec) by the
    carried ones."""
    engine = ec._engine = BitplaneEngine(ec.device)
    k, n = ec.get_data_chunk_count(), ec.get_chunk_count()
    full_bm = getattr(ec, "full_bm", None)
    if full_bm is None:
        gen = np.asarray(arrays["generator"], np.uint8)
        if gen.shape != (n, k):
            raise ValueError(f"generator {gen.shape}, codec needs {(n, k)}")
        ec.generator = gen
        parity = gen[k:]
        if hasattr(ec, "parity"):               # shec keeps both
            ec.parity = parity
            ec._select_cache.clear()
    else:
        full = np.asarray(arrays["full_bm"], np.uint8)
        if full.shape != full_bm.shape:
            raise ValueError(f"full_bm {full.shape}, codec needs "
                             f"{full_bm.shape}")
        ec.full_bm = full
        parity = full[k * ec.w:]
    if "bm32" in arrays:
        applier = ShardApply.from_lane_bitmatrix(arrays["bm32"],
                                                 parity.shape[1])
        if not np.array_equal(applier.consts.bitmatrix,
                              ShardApply(parity).consts.bitmatrix):
            raise ValueError("bm32 does not belong to the carried matrix")
        engine.install_applier(parity, applier)
    decode = arrays.get("decode", {})
    if decode and not hasattr(ec, "_decode_matrix_cache"):
        raise ValueError(f"{type(ec).__name__} keeps no decode matrices")
    for (survivors, wanted), D in decode.items():
        ec._decode_matrix_cache.put(
            (tuple(int(s) for s in survivors), tuple(int(w) for w in wanted)),
            np.asarray(D, np.uint8))


def install_grouped_reference(engine: BitplaneEngine, coeff: np.ndarray,
                              arrays: Mapping) -> GroupedApply:
    """Build the port's GroupedApply from a JAX ``GroupedPlan``'s arrays
    and make ``engine`` serve ``coeff`` with it.

    ``arrays`` holds the plan's ``"groups"``, ``"cols"``, ``"bms"`` (the
    lane-expanded int8 group bitmatrices) and ``"gather_rows"``.  Raises
    unless each ``bms[g]`` is the lane expansion of a GF(2) bitmatrix
    (``GroupedPlan.from_reference``), the plan is one the engine would
    group, and the matrix the plan applies is ``coeff``."""
    coeff = np.asarray(coeff, np.uint8)
    plan = GroupedPlan.from_reference(
        coeff.shape[0], coeff.shape[1], arrays["groups"], arrays["cols"],
        arrays["bms"], arrays["gather_rows"])
    if not plan.profitable:
        raise ValueError("the carried plan is not one the engine groups")
    if not np.array_equal(plan.coefficients(), coeff):
        raise ValueError("the carried plan does not apply this matrix")
    applier = GroupedApply(plan=plan)
    engine.install_grouped(coeff, applier)
    return applier
