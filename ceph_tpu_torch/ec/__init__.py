"""Erasure coding on PyTorch + CUDA (counterpart of ceph_tpu.ec).

- ``gf``, ``matrix``, ``bitmatrix``, ``bitsched``, ``reference`` — numpy
  copies of the JAX package's GF(2^8) math and CPU oracle.
- ``cuda_kernels`` — the GF(2) region-apply kernels (csrc/gf2_apply.cu,
  and csrc/gf2_grouped.cu for sparse repair operators) and their plain
  PyTorch versions.
- ``engine`` — BitplaneEngine: per-matrix caches and the apply entries.
- ``plugins`` — jax_rs, xor, lrc, shec and clay codecs, registered in
  ``registry``.
- ``repair_operator`` — single-chunk repair (CLAY, LRC) as one matrix.
"""

from ceph_tpu_torch.ec.interface import ErasureCodeInterface  # noqa: F401
from ceph_tpu_torch.ec.registry import (  # noqa: F401
    ErasureCodePluginRegistry,
    instance,
)
