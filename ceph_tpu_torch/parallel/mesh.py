"""The port's device mesh: slots, named meshes, batch shardings, placed
batches and the collectives between slots.

Counterpart of what the JAX package takes from ``jax.sharding`` and
``jax.devices()`` (``Mesh``, ``NamedSharding``, ``PartitionSpec``, a
sharded ``jax.Array`` and its ``addressable_shards``) and of the
``jax.lax`` collectives its ``shard_map`` bodies call (``all_to_all``,
the tiled ``all_gather``).

The design is single-controller, as the JAX planes are: one process
drives every slot.  A slot (``MeshDevice``) is a device of the mesh with
a stream of its own; each ``shard_map`` body becomes explicit phases, a
per-slot compute (``per_slot``: each slot's work enqueued on its stream,
joined to the caller's stream by events both ways), then a collective
on the caller's stream (tensor copies between slots: a peer copy between
two GPUs, a device-local copy between two slots of one card), then the
next per-slot compute.  No process group is involved, so the host
coalescer stays one object shared by every co-located OSD.

``local_devices()`` gives the real CUDA devices; ``force_device_count(n)``
(the counterpart of ``--xla_force_host_platform_device_count``) makes it
give ``n`` slots over one device from then on, each with its own stream:
tests run 8 slots on the CPU, and the card runs 8 slots over one GPU.
"""

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict

import numpy as np
import torch

from ceph_tpu_torch.ec.engine import resolve_device

# Bytes that crossed between devices or slots, by kind: ``host`` uploaded
# by ``device_put`` from host memory, ``place`` moved device to device by
# ``device_put``, ``slot`` copied between two slots by a collective (a
# slot's own piece, and a view, count nothing).
TRAFFIC = {"host": 0, "place": 0, "slot": 0}
_TRAFFIC_LOCK = threading.Lock()


def reset_traffic() -> None:
    with _TRAFFIC_LOCK:
        for key in TRAFFIC:
            TRAFFIC[key] = 0


def _count(kind: str, nbytes: int) -> None:
    with _TRAFFIC_LOCK:
        TRAFFIC[kind] += int(nbytes)


class MeshDevice:
    """One slot of a mesh: its id (the mesh-wide device id that
    ``shard_layout`` reports), the torch device it runs on, and its own
    stream there (None on the CPU)."""

    __slots__ = ("id", "device", "stream")

    def __init__(self, id: int, device: torch.device, stream=None):
        self.id = int(id)
        self.device = torch.device(device)
        self.stream = stream

    def __repr__(self) -> str:
        return f"MeshDevice(id={self.id}, device={self.device})"


def _slot(id: int, device: torch.device) -> MeshDevice:
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    return MeshDevice(id, device, stream)


_REAL: dict[torch.device, MeshDevice] = {}
_FORCED: tuple | None = None        # (n, device, slots)


def force_device_count(n: int | None, device=None) -> None:
    """From now on ``local_devices()`` gives ``n`` slots over ``device``
    (CUDA when None, raising without it), ids 0..n-1, each with its own
    stream; ``None`` drops the setting.  Explicit and process-wide, like
    the XLA flag it stands for."""
    global _FORCED
    if n is None:
        _FORCED = None
        return
    if int(n) < 1:
        raise ValueError(f"device count {n} must be positive")
    dev = resolve_device(device)
    if _FORCED is not None and _FORCED[:2] == (int(n), dev):
        return      # the same slots, streams included
    _FORCED = (int(n), dev, [_slot(i, dev) for i in range(int(n))])


@contextlib.contextmanager
def forced_device_count(n: int, device=None):
    """``force_device_count(n, device)`` for the body of a ``with``,
    yielding the slots; the setting before it (its slots included) comes
    back after."""
    global _FORCED
    before = _FORCED
    force_device_count(n, device)
    try:
        yield local_devices(device)
    finally:
        _FORCED = before


def local_devices(device=None) -> list[MeshDevice]:
    """The slots of this process: the forced slots when
    ``force_device_count`` set them over ``device`` (or ``device`` is
    None); else every real CUDA device (``device`` None or CUDA; raising
    when there is none), or the one CPU device when asked for."""
    if _FORCED is not None:
        n, dev, slots = _FORCED
        if device is None or resolve_device(device) == dev:
            return list(slots)
    dev = resolve_device(device)
    devs = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if dev.type == "cuda" else [dev])
    out = []
    for d in devs:
        slot = _REAL.get(d)
        if slot is None:
            slot = _REAL.setdefault(
                d, _slot(d.index if d.type == "cuda" else 0, d))
        out.append(slot)
    return out


class Mesh:
    """Slots laid out on named axes (``jax.sharding.Mesh``): ``devices``
    is an object array of ``MeshDevice``s, ``shape`` maps each axis name
    to its size."""

    def __init__(self, devices, axis_names):
        devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes "
                             f"{self.axis_names}")
        self.devices = devices

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def slots(self) -> list[MeshDevice]:
        """Every slot, in row-major mesh order."""
        return list(self.devices.flat)

    def groups(self, axis: str) -> list[list[int]]:
        """Flat slot indices of each group along ``axis`` (the other
        coordinates fixed), in axis order: the members of one
        collective."""
        a = self.axis_names.index(axis)
        flat = np.arange(self.size).reshape(self.devices.shape)
        return np.moveaxis(flat, a, -1).reshape(
            -1, self.devices.shape[a]).tolist()

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)})"


class PartitionSpec(tuple):
    """Per dimension: None (not split), an axis name, or a tuple of axis
    names (split over their product, the first axis major)."""

    def __new__(cls, *parts):
        return tuple.__new__(cls, parts)


def _axes(part) -> tuple:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


class NamedSharding:
    """A mesh and a PartitionSpec: which block of an array each slot
    holds.  Slots that differ only on axes the spec does not name hold
    the same block (replicas)."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec
        for part in spec:
            for ax in _axes(part):
                if ax not in mesh.axis_names:
                    raise ValueError(f"axis {ax!r} not in {mesh}")

    @property
    def device_set(self) -> set:
        return set(self.mesh.slots())

    def indices(self, shape) -> list[tuple[MeshDevice, tuple]]:
        """(slot, index) for every slot in mesh order; ``index`` is a
        tuple of slices into an array of ``shape``."""
        shape = tuple(int(s) for s in shape)
        sizes = self.mesh.shape
        out = []
        for coords in np.ndindex(*self.mesh.devices.shape):
            pos = dict(zip(self.mesh.axis_names, coords))
            index = []
            for d, dim in enumerate(shape):
                part = self.spec[d] if d < len(self.spec) else None
                axes = _axes(part)
                nshard, at = 1, 0
                for ax in axes:
                    nshard *= sizes[ax]
                    at = at * sizes[ax] + pos[ax]
                if dim % nshard:
                    raise ValueError(f"dimension {d} of {shape} does not "
                                     f"split {nshard} ways")
                step = dim // nshard
                index.append(slice(at * step, (at + 1) * step))
            out.append((self.mesh.devices[coords], tuple(index)))
        return out


def _key(index: tuple) -> tuple:
    return tuple((s.start, s.stop) for s in index)


class Shard:
    """One slot's block of a placed array: its slot (``device``, as a
    jax shard's ``.device``), its tensor and its index."""

    __slots__ = ("device", "data", "index")

    def __init__(self, device: MeshDevice, data: torch.Tensor, index: tuple):
        self.device = device
        self.data = data
        self.index = index


class ShardedTensor:
    """An array placed over a mesh: one block per slot, each a tensor on
    the slot's device (a sharded ``jax.Array``).  ``base``, when set, is
    one tensor every block is a view of."""

    def __init__(self, shards: list[Shard], shape, sharding: NamedSharding,
                 dtype=torch.uint8, base: torch.Tensor | None = None):
        self.addressable_shards = list(shards)
        self.shape = tuple(int(s) for s in shape)
        self.sharding = sharding
        self.dtype = dtype
        self.base = base

    def blocks(self) -> list[torch.Tensor]:
        return [s.data for s in self.addressable_shards]

    def assemble(self, device=None) -> torch.Tensor:
        """The whole array as one tensor on ``device`` (the first slot's
        when None), on the caller's stream: ``base`` itself when the
        blocks are views of it there, else one copy of each distinct
        block."""
        target = (self.addressable_shards[0].device.device if device is None
                  else resolve_device(device))
        if self.base is not None and self.base.device == target:
            return self.base
        out = torch.empty(self.shape, dtype=self.dtype, device=target)
        seen = set()
        for sh in self.addressable_shards:
            key = _key(sh.index)
            if key in seen:
                continue
            seen.add(key)
            out[sh.index].copy_(sh.data, non_blocking=True)
        return out

    def __array__(self, dtype=None, copy=None):
        arr = self.assemble().cpu().numpy()
        return arr if dtype is None else arr.astype(dtype)


def upload(x, device) -> torch.Tensor:
    """``x`` (numpy or a tensor) as a tensor on ``device``, host bytes
    counted under ``TRAFFIC["host"]``."""
    if not isinstance(x, torch.Tensor):
        host = np.ascontiguousarray(np.asarray(x))
        if not host.flags.writeable:
            host = host.copy()
        x = torch.from_numpy(host)
    device = torch.device(device)
    if x.device != device:
        _count("host" if x.device.type == "cpu" else "place", x.nbytes)
        x = x.to(device)
    return x


def placed(mesh: Mesh, spec: PartitionSpec, blocks: list,
           shape) -> ShardedTensor:
    """Per-slot results (one tensor per slot, mesh order) as an array
    placed with ``spec``: a ``shard_map``'s ``out_specs``."""
    sharding = NamedSharding(mesh, spec)
    return ShardedTensor(
        [Shard(slot, blk, index) for (slot, index), blk
         in zip(sharding.indices(shape), blocks)], shape, sharding)


def device_put(x, sharding: NamedSharding) -> ShardedTensor:
    """Place ``x`` (numpy or a tensor) with ``sharding``.  A tensor whose
    slots all lie on its own device is split into views (nothing is
    copied); a tensor on another device moves device to device; host
    bytes upload once (once per slot when the slots span devices)."""
    indices = sharding.indices(x.shape)
    devices = {slot.device for slot, _ in indices}
    if not isinstance(x, torch.Tensor):
        x = upload(x, next(iter(devices)) if len(devices) == 1 else "cpu")
    base = x if devices == {x.device} else None
    shards = []
    for slot, index in indices:
        piece = x[index]
        if piece.device != slot.device:
            kind = "host" if piece.device.type == "cpu" else "place"
            _count(kind, piece.nbytes)
            piece = piece.to(slot.device, non_blocking=kind == "place")
        shards.append(Shard(slot, piece, index))
    return ShardedTensor(shards, x.shape, sharding, x.dtype, base)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)


def per_slot(fn, slots: list[MeshDevice], *blocks) -> list:
    """``fn(slot, *args)`` for each slot, ``args`` its entries of
    ``blocks``: each slot's work is enqueued on its stream (one slot after
    another from this thread; the streams run together), after the
    caller's stream, and the caller's stream then waits for every slot.
    Inputs are marked used on the slot's stream and outputs on the
    caller's, so the caching allocator reuses neither early."""
    callers = {}
    for s in slots:
        if s.stream is not None:
            c = callers.get(s.device)
            if c is None:
                c = callers[s.device] = torch.cuda.current_stream(s.device)
            s.stream.wait_stream(c)
    outs = []
    for i, s in enumerate(slots):
        args = [b[i] for b in blocks]
        if s.stream is None:
            outs.append(fn(s, *args))
            continue
        for t in _tensors(args):
            if t.device.type == "cuda":
                t.record_stream(s.stream)
        with torch.cuda.stream(s.stream):
            outs.append(fn(s, *args))
    for s, out in zip(slots, outs):
        if s.stream is not None:
            c = callers[s.device]
            c.wait_stream(s.stream)
            for t in _tensors(out):
                t.record_stream(c)
    return outs


def index_on(values, slots: list[MeshDevice]) -> dict:
    """``values`` as an int64 index tensor on each slots' device, made on
    the caller's stream before the slots run (an upload inside a slot's
    work would wait for its stream)."""
    return {s.device: torch.tensor(list(values), dtype=torch.long,
                                   device=s.device) for s in slots}


def _move(piece: torch.Tensor, src: MeshDevice,
          dst: MeshDevice) -> torch.Tensor:
    """``piece`` of slot ``src`` as slot ``dst`` receives it: itself on
    the same slot; else counted as slot traffic, moved when the device
    differs (the copy into the receiver's buffer does the rest)."""
    if src is dst:
        return piece
    _count("slot", piece.nbytes)
    if piece.device != dst.device:
        piece = piece.to(dst.device, non_blocking=True)
    return piece


def all_to_all(mesh: Mesh, axis: str, blocks: list, split_axis: int,
               concat_axis: int) -> list[torch.Tensor]:
    """``jax.lax.all_to_all`` over ``axis``: in each group, the slot at
    position j receives part j (of as many equal parts of ``split_axis``
    as the group has slots) of every member's block, concatenated along
    ``concat_axis`` in member order."""
    slots = mesh.slots()
    out: list = [None] * len(slots)
    for group in mesh.groups(axis):
        parts = {src: blocks[src].chunk(len(group), dim=split_axis)
                 for src in group}
        for j, dst in enumerate(group):
            out[dst] = torch.cat(
                [_move(parts[src][j], slots[src], slots[dst])
                 for src in group], dim=concat_axis)
    return out


def all_gather(mesh: Mesh, axis: str, blocks: list,
               dim: int) -> list[torch.Tensor]:
    """The tiled ``jax.lax.all_gather`` over ``axis``: every slot of a
    group receives its members' blocks concatenated along ``dim``."""
    slots = mesh.slots()
    out: list = [None] * len(slots)
    for group in mesh.groups(axis):
        for dst in group:
            out[dst] = torch.cat(
                [_move(blocks[src], slots[src], slots[dst])
                 for src in group], dim=dim)
    return out
