"""RadosStriper: RAID-0 striping of large logical objects over RADOS.

Counterpart of ceph_tpu/client/striper.py: the same module over the
port's imports.

The libradosstriper role (reference src/libradosstriper/
RadosStriperImpl.h:30) with the Striper layout math of osdc/Striper.h:26:
a logical object is block-cyclically split over ``stripe_count`` backing
objects of up to ``object_size`` bytes, ``stripe_unit`` bytes at a time;
backing objects are named ``<name>.%016x`` and the logical size lives in
an xattr of the first one — the same on-disk convention as the reference,
so striped layouts are structurally comparable.
"""

from __future__ import annotations

from ceph_tpu_torch.client.rados import IoCtx, ObjectOperation, RadosError

SIZE_XATTR = "striper.size"


class StripeLayout:
    def __init__(self, stripe_unit: int = 64 * 1024, stripe_count: int = 4,
                 object_size: int = 4 * 1024 * 1024):
        if object_size % stripe_unit:
            raise ValueError("object_size must be a stripe_unit multiple")
        self.su = stripe_unit
        self.sc = stripe_count
        self.os = object_size
        self.stripes_per_object = object_size // stripe_unit

    def map_extent(self, off: int, length: int):
        """Yield (objectno, obj_off, length) per touched stripe fragment
        (Striper::file_to_extents semantics)."""
        pos = off
        end = off + length
        while pos < end:
            blockno = pos // self.su           # global stripe-unit index
            stripeno = blockno // self.sc
            stripepos = blockno % self.sc      # which object column
            objectsetno = stripeno // self.stripes_per_object
            objectno = objectsetno * self.sc + stripepos
            block_off = pos % self.su
            obj_off = (stripeno % self.stripes_per_object) * self.su \
                + block_off
            run = min(self.su - block_off, end - pos)
            yield objectno, obj_off, run
            pos += run


class RadosStriper:
    def __init__(self, ioctx: IoCtx, layout: StripeLayout | None = None):
        self.ioctx = ioctx
        self.layout = layout or StripeLayout()

    @staticmethod
    def _obj(name: str, objectno: int) -> str:
        return f"{name}.{objectno:016x}"

    async def _size(self, name: str) -> int:
        try:
            raw = await self.ioctx.get_xattr(self._obj(name, 0), SIZE_XATTR)
            return int(raw)
        except RadosError as e:
            if e.rc == -2:
                raise RadosError(-2, f"no striped object {name!r}") from e
            raise

    async def write(self, name: str, data: bytes, offset: int = 0) -> None:
        """Striped write + logical-size bump."""
        frags: dict[int, ObjectOperation] = {}
        pos = 0
        for objectno, obj_off, run in self.layout.map_extent(
            offset, len(data)
        ):
            op = frags.setdefault(objectno, ObjectOperation())
            op.write(data[pos:pos + run], obj_off)
            pos += run
        try:
            old = await self._size(name)
        except RadosError:
            old = 0
        new_size = max(old, offset + len(data))
        size_op = frags.setdefault(0, ObjectOperation())
        size_op.set_xattr(SIZE_XATTR, str(new_size).encode())
        for objectno, op in sorted(frags.items()):
            await self.ioctx.operate(self._obj(name, objectno), op)

    async def read(self, name: str, length: int | None = None,
                   offset: int = 0) -> bytes:
        size = await self._size(name)
        if length is None:
            length = max(0, size - offset)
        length = max(0, min(length, size - offset))
        if length == 0:
            return b""
        out = bytearray(length)
        pos = 0
        for objectno, obj_off, run in self.layout.map_extent(
            offset, length
        ):
            try:
                frag = await self.ioctx.read(
                    self._obj(name, objectno), run, obj_off
                )
            except RadosError as e:
                if e.rc != -2:
                    raise
                frag = b""
            frag = frag.ljust(run, b"\0")      # sparse regions read as 0
            out[pos:pos + run] = frag
            pos += run
        return bytes(out)

    async def stat(self, name: str) -> dict:
        return {"size": await self._size(name)}

    async def truncate(self, name: str, size: int) -> None:
        """Shrink: zero the dropped range so a later re-extension reads
        holes, not stale bytes (reads clamp to the logical size either
        way)."""
        old = await self._size(name)
        if size < old:
            for objectno, obj_off, run in self.layout.map_extent(
                size, old - size
            ):
                try:
                    await self.ioctx.write(
                        self._obj(name, objectno), b"\0" * run, obj_off
                    )
                except RadosError as e:
                    if e.rc != -2:
                        raise
        await self.ioctx.set_xattr(
            self._obj(name, 0), SIZE_XATTR, str(size).encode()
        )

    async def remove(self, name: str) -> None:
        """Remove every backing object. Enumerated from the pool, not
        derived from the logical size — truncation shrinks the size
        without deleting backing objects."""
        await self._size(name)              # ENOENT if never written
        prefix = f"{name}."
        backing = [
            obj for obj in await self.ioctx.list_objects()
            if obj.startswith(prefix) and len(obj) == len(name) + 17
        ]
        # first object last: its size xattr marks existence
        first = self._obj(name, 0)
        for obj in sorted(backing, key=lambda o: o == first):
            try:
                await self.ioctx.remove(obj)
            except RadosError as e:
                if e.rc != -2:
                    raise
