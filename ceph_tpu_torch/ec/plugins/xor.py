"""xor — minimal k+1 XOR code, the ErasureCodeExample analog.

Counterpart of ceph_tpu/ec/plugins/xor.py: a jax_rs codec whose one parity
row is all ones, so its parity is the XOR of the data chunks (the m=1
region_xor fast path of the reference's isa plugin).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from ceph_tpu_torch.ec.plugins.jax_rs import ErasureCodeJaxRS
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry


class ErasureCodeXor(ErasureCodeJaxRS):
    def parse(self, profile: Mapping[str, str]) -> None:
        self.k = self.to_int(profile, "k", 2)
        self.m = self.to_int(profile, "m", 1)
        if self.m != 1:
            raise ValueError("xor plugin requires m=1")
        if self.k < 1:
            raise ValueError("xor plugin requires k >= 1")
        self.technique = "xor"
        full = np.zeros((self.k + 1, self.k), dtype=np.uint8)
        full[: self.k] = np.eye(self.k, dtype=np.uint8)
        full[self.k] = 1  # GF(2^8) sum of all data chunks == XOR
        self.generator = full
        self._decode_matrix_cache.clear()


def __erasure_code_init__(registry: ErasureCodePluginRegistry) -> None:
    registry.add("xor", ErasureCodeXor)
