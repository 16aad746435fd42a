"""Sharded EC execution over the port's mesh (``parallel.mesh``).

Counterpart of ceph_tpu/parallel/ec_sharding.py.  Axes:
- ``dp``  — stripe-batch data parallelism (declustered placement analog:
            independent stripes on independent devices).
- ``cs``  — chunk sharding: the k+m chunks of one stripe live on distinct
            devices/failure domains (the shard_t axis of
            reference osd/osd_types.h / ECUtil.h:28-65 — positions are NOT
            interchangeable).

The full step = every slot encodes its own stripe block -> chunks fan out
across 'cs' with an all_to_all (the interconnect analog of the per-shard
MOSDECSubOpWrite fan-out, reference osd/ECBackend.cc:2090-2106) -> each
slot holds one chunk slice of every stripe in its cs-group.  Repair =
all_gather of shard slices within the group + decode-matrix apply
(objects_read_and_reconstruct / get_min_avail_to_read_shards semantics,
reference ECBackend.cc:2364,1613).

Each ``shard_map`` body of the JAX module is written out as its phases:
a per-slot compute (``mesh.per_slot``: the slot's engine, on the slot's
stream), a collective (``mesh.all_to_all`` / ``mesh.all_gather``), the
next per-slot compute.  A slot's engine is ``default_engine`` of its
device, so on a GPU every slot's apply launches the port's kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch.ec import reference
from ceph_tpu_torch.ec.engine import default_engine
from ceph_tpu_torch.parallel.mesh import (Mesh, NamedSharding,
                                          PartitionSpec as P, ShardedTensor,
                                          all_gather, all_to_all,
                                          device_put, index_on,
                                          local_devices, per_slot, placed)


def make_ec_mesh(devices=None, cs: int = 1) -> Mesh:
    """Mesh with ('dp', 'cs') axes; cs must divide the device count.
    ``devices`` None: ``local_devices()`` (CUDA, raising without it)."""
    devices = list(devices if devices is not None else local_devices())
    n = len(devices)
    if n % cs:
        raise ValueError(f"cs={cs} must divide device count {n}")
    arr = np.array(devices, dtype=object).reshape(n // cs, cs)
    return Mesh(arr, ("dp", "cs"))


def _frozen(coeff) -> np.ndarray:
    """A read-only copy over bytes: every slot's engine resolves its
    applier once, by identity (``engine._immutable``)."""
    coeff = np.asarray(coeff, np.uint8)
    return np.frombuffer(coeff.tobytes(), np.uint8).reshape(coeff.shape)


def sharded_encode(mesh: Mesh, generator: np.ndarray, data) -> ShardedTensor:
    """Encode a stripe batch sharded over every mesh device.

    data: (B, k, C) uint8 (numpy or a tensor), B divisible by the total
    device count.  Returns (B, k+m, C), batch-sharded the same way.
    """
    k = generator.shape[1]
    parity_coeff = _frozen(generator[k:])
    batch_spec = P(("dp", "cs"), None, None)
    data = device_put(data, NamedSharding(mesh, batch_spec))

    def local(slot, d_blk):
        # Engine dispatch: the shard kernel on a GPU, its plain version
        # on the CPU.
        parity = default_engine(slot.device).apply(parity_coeff, d_blk)
        return torch.cat([d_blk, parity], dim=1)

    blocks = per_slot(local, mesh.slots(), data.blocks())
    return placed(mesh, batch_spec, blocks,
                   (data.shape[0], generator.shape[0], data.shape[2]))


class ShardedApplier:
    """Build-once dp×cs mesh applier for one GF coefficient matrix.

    The daemon-side entry of the distributed EC data plane: ECBackend
    encode/decode batches dispatch through this when a device mesh is
    configured, instead of the single-device codec path.  Stripe batches
    shard over EVERY mesh device (('dp', 'cs') data parallelism — chunk
    positions stay intact inside each stripe, so outputs are
    bit-identical to the single-device path); each slot's applier is
    resolved once per (mesh, matrix), so steady-state calls only launch.
    """

    def __init__(self, mesh: Mesh, coeff: np.ndarray):
        self.mesh = mesh
        self.total = int(np.prod(list(mesh.shape.values())))
        self.coeff = _frozen(coeff)
        self._spec = P(("dp", "cs"), None, None)

    def _step(self, x: ShardedTensor) -> ShardedTensor:
        coeff = self.coeff
        blocks = per_slot(
            lambda slot, blk: default_engine(slot.device).apply(coeff, blk),
            [s.device for s in x.addressable_shards], x.blocks())
        return placed(self.mesh, self._spec, blocks,
                       (x.shape[0], coeff.shape[0], x.shape[2]))

    def __call__(self, data: np.ndarray) -> np.ndarray:
        """(B, rows_in, C) uint8 -> (B, rows_out, C); B is padded up to
        a whole number of device blocks and sliced back."""
        data = np.asarray(data, np.uint8)
        B = data.shape[0]
        pad = (-B) % self.total
        if pad:
            data = np.concatenate(
                [data, np.zeros((pad,) + data.shape[1:], np.uint8)])
        x = device_put(data, self.sharding())
        out = np.asarray(self._step(x))
        return out[:B] if pad else out

    def place(self, data) -> ShardedTensor:
        """Place a padded batch (B a multiple of ``total``) with the
        batch-sharded spec.  Host input uploads once; device input
        (resident tensors) splits on device with NO host round trip —
        into views when the slots share its device — the zero-copy feed
        the mesh coalescer relies on."""
        if isinstance(data, np.ndarray):
            data = np.asarray(data, np.uint8)
        return device_put(data, self.sharding())

    def run_placed(self, x: ShardedTensor) -> ShardedTensor:
        """Apply to an already-placed batch, returning the device-
        resident result (same batch sharding) — callers assemble/offload."""
        return self._step(x)

    def sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, self._spec)


def shard_layout(x) -> dict[int, int]:
    """device id -> leading-axis rows this device holds.  Read off the
    REAL addressable shards of a placed/launched array, so counters
    built from it prove (not assume) how the batch axis split."""
    return {
        int(s.device.id): int(s.data.shape[0])
        for s in x.addressable_shards
    }


def distributed_ec_step(
    mesh: Mesh, generator: np.ndarray, data, lost_chunk: int = 0
):
    """Full distributed EC step: encode + chunk fan-out + repair.

    data: (B, k, C) uint8, B divisible by dp*cs and k+m divisible by cs.

    Returns ``(shard_slices, repaired)``:
    - shard_slices: (B, k+m, C) — chunk axis sharded over 'cs' (each device
      holds its (k+m)/cs chunk columns for every stripe of its cs-group);
    - repaired: (B, C) — chunk ``lost_chunk`` reconstructed from survivors,
      bit-identical to the encoded chunk.
    """
    k, n = generator.shape[1], generator.shape[0]
    cs = mesh.shape["cs"]
    if n % cs:
        raise ValueError(f"k+m={n} must be divisible by cs={cs}")
    parity_coeff = _frozen(generator[k:])

    survivors = [i for i in range(n) if i != lost_chunk][:k]
    D = _frozen(reference.decode_matrix(generator, survivors, [lost_chunk]))

    batch_spec = P(("dp", "cs"), None, None)
    data = device_put(data, NamedSharding(mesh, batch_spec))
    B, _, C = data.shape
    slots = mesh.slots()

    def encode(slot, d_blk):  # (b, k, C) per slot, b = B/(dp*cs)
        parity = default_engine(slot.device).apply(parity_coeff, d_blk)
        return torch.cat([d_blk, parity], dim=1)  # (b, n, C)

    chunks = per_slot(encode, slots, data.blocks())
    # Chunk fan-out: slot j of the cs-group ends up with chunk columns
    # [j*n/cs, (j+1)*n/cs) of all cs*b group stripes, source-major.
    shard = all_to_all(mesh, "cs", chunks, split_axis=1, concat_axis=0)
    # Repair read fan-in: regather every slice within the group.
    full = all_gather(mesh, "cs", shard, dim=1)  # (cs*b, n, C)

    surv_idx = index_on(survivors, slots)

    def repair(slot, f):
        surv = f.index_select(1, surv_idx[slot.device])  # (cs*b, k, C)
        return default_engine(slot.device).apply(D, surv)[:, 0]  # (cs*b, C)

    repaired = per_slot(repair, slots, full)
    return (placed(mesh, P("dp", "cs", None), shard, (B, n, C)),
            placed(mesh, P("dp", None), repaired, (B, C)))
