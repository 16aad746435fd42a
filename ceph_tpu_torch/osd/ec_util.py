"""EC stripe geometry and stripe (de)composition.

Counterpart of ceph_tpu/osd/ec_util.py:

- StripeInfo: the logical<->chunk offset math of ECUtil::stripe_info_t
  (reference osd/ECUtil.h:28-65).
- stripe (de)composition driving batched device encode/decode — the role
  of ECUtil::encode/decode, with stripes batched into one kernel launch.
  The helpers take numpy arrays or torch tensors and keep the kind they
  were given, so a device batch stays on its device.

HashInfo (per-shard cumulative crc32c) is not ported yet: it needs the
port's crc32c, which comes with the checksum slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def _permute(x, order: tuple[int, ...]):
    """Axis permutation of a numpy array or a tensor (a view either way)."""
    if isinstance(x, torch.Tensor):
        return x.permute(*order)
    return x.transpose(order)


@dataclass(frozen=True)
class StripeInfo:
    """Geometry of one EC pool: k chunks of chunk_size bytes per stripe."""

    k: int
    chunk_size: int

    @property
    def stripe_width(self) -> int:
        return self.k * self.chunk_size

    # -- logical (object) offsets <-> chunk offsets ----------------------
    def logical_to_prev_chunk_offset(self, offset: int) -> int:
        return (offset // self.stripe_width) * self.chunk_size

    def logical_to_next_chunk_offset(self, offset: int) -> int:
        return -(-offset // self.stripe_width) * self.chunk_size

    def logical_to_prev_stripe_offset(self, offset: int) -> int:
        return offset - (offset % self.stripe_width)

    def logical_to_next_stripe_offset(self, offset: int) -> int:
        return -(-offset // self.stripe_width) * self.stripe_width

    def aligned_logical_offset_to_chunk_offset(self, offset: int) -> int:
        if offset % self.stripe_width:
            raise ValueError(f"offset {offset} not stripe aligned")
        return offset // self.k

    def aligned_chunk_offset_to_logical_offset(self, offset: int) -> int:
        if offset % self.chunk_size:
            raise ValueError(f"offset {offset} not chunk aligned")
        return offset * self.k

    def offset_len_to_stripe_bounds(self, offset: int, length: int):
        """Expand [offset, offset+len) to stripe-aligned bounds."""
        start = self.logical_to_prev_stripe_offset(offset)
        end = self.logical_to_next_stripe_offset(offset + length)
        return start, end - start

    # -- stripe batching -------------------------------------------------
    def split_stripes(self, data):
        """Stripe-aligned logical bytes -> (num_stripes, k, chunk_size),
        the batch layout the engine consumes.  Bytes and numpy give a
        numpy view; a uint8 tensor gives a tensor view on its device."""
        if isinstance(data, torch.Tensor):
            arr = data.reshape(-1)
        elif isinstance(data, (bytes, bytearray, memoryview)):
            arr = np.frombuffer(data, np.uint8)
        else:
            arr = np.asarray(data, np.uint8).reshape(-1)
        if arr.shape[0] % self.stripe_width:
            raise ValueError(
                f"{arr.shape[0]} bytes not a multiple of stripe width "
                f"{self.stripe_width}"
            )
        return arr.reshape(-1, self.k, self.chunk_size)

    def merge_stripes(self, stripes):
        """(num_stripes, k, chunk_size) -> flat logical bytes."""
        if isinstance(stripes, torch.Tensor):
            return stripes.contiguous().reshape(-1)
        return np.ascontiguousarray(stripes, np.uint8).reshape(-1)

    def shard_bytes(self, chunks) -> list:
        """(num_stripes, n, chunk_size) encoded batch -> per-shard
        contiguous byte streams (what each shard OSD persists)."""
        if isinstance(chunks, torch.Tensor):
            return [chunks[:, i].contiguous().reshape(-1)
                    for i in range(chunks.shape[1])]
        return [np.ascontiguousarray(chunks[:, i]).reshape(-1)
                for i in range(chunks.shape[1])]

    def shard_streams(self, chunks):
        """(num_stripes, n, chunk_size) encoded batch -> (n, num_stripes
        * chunk_size) per-shard byte streams as one array or tensor."""
        b, n, c = chunks.shape
        return _permute(chunks, (1, 0, 2)).reshape(n, b * c)

    def stack_shard_streams(self, streams, nstripes: int):
        """Inverse of shard_streams for the k data shards: (k, nstripes
        * chunk_size) streams -> flat logical bytes of nstripes stripes."""
        k = streams.shape[0]
        return _permute(streams.reshape(k, nstripes, self.chunk_size),
                        (1, 0, 2)).reshape(-1)
