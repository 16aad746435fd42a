"""RadosModel: model-based randomized op testing with an oracle.

Counterpart of ceph_tpu/testing/rados_model.py: the same module over the
port's imports.

The reference's ceph_test_rados (src/test/osd/RadosModel.h:105 TestOp
generator) performs random op sequences against a pool while an
in-memory model predicts every outcome; QA runs it under OSD thrashing.
Same here: a seeded generator issues writes/appends/reads/removes/
truncates/xattr/omap ops through the real client stack, mirrors each
mutation into a Python oracle, checks every read against it, and
``verify_all`` sweeps the final pool state object by object.
"""

from __future__ import annotations

import random

from ceph_tpu_torch.client.rados import IoCtx, ObjectOperation, RadosError


class ModelObject:
    def __init__(self):
        self.data = bytearray()
        self.xattrs: dict[str, bytes] = {}
        self.omap: dict[str, bytes] = {}


class RadosModel:
    OPS = (
        "write", "write", "write_full", "append", "read", "read",
        "truncate", "remove", "setxattr", "getxattr", "omap_set",
        "omap_get", "stat", "multi",
    )

    def __init__(self, ioctx: IoCtx, seed: int = 0, n_objects: int = 16,
                 max_size: int = 1 << 16, ec: bool = False,
                 snaps: bool = False):
        self.ioctx = ioctx
        self.rng = random.Random(seed)
        self.names = [f"model-obj-{i}" for i in range(n_objects)]
        self.max_size = max_size
        self.ec = ec                      # EC pools: no omap, no snaps
        self.model: dict[str, ModelObject] = {}
        self.ops_done = 0
        self.checks = 0
        # snapshot oracle: snapid -> frozen {name: bytes} pool image at
        # snap time (the reference runs ceph_test_rados with snap ops
        # mixed in the same way)
        self.snaps_enabled = snaps and not ec
        self.snap_images: dict[int, dict[str, bytes]] = {}

    # -- op generation -----------------------------------------------------
    def _blob(self, n: int) -> bytes:
        return self.rng.randbytes(n)

    def _pick(self) -> str:
        return self.rng.choice(self.names)

    async def step(self) -> None:
        ops = self.OPS
        if self.snaps_enabled:
            ops = ops + ("snap_create", "snap_read", "snap_read",
                         "snap_remove")
        op = self.rng.choice(ops)
        if self.ec and op.startswith("omap"):
            op = "write"
        name = self._pick()
        handler = getattr(self, f"_op_{op}")
        await handler(name)
        self.ops_done += 1

    async def run(self, n_ops: int) -> None:
        for _ in range(n_ops):
            await self.step()

    # -- ops ---------------------------------------------------------------
    async def _op_write(self, name: str) -> None:
        off = self.rng.randrange(self.max_size // 2)
        data = self._blob(self.rng.randrange(1, self.max_size // 4))
        await self.ioctx.write(name, data, off)
        m = self.model.setdefault(name, ModelObject())
        end = off + len(data)
        if len(m.data) < end:
            m.data.extend(b"\0" * (end - len(m.data)))
        m.data[off:end] = data

    async def _op_write_full(self, name: str) -> None:
        data = self._blob(self.rng.randrange(1, self.max_size))
        await self.ioctx.write_full(name, data)
        m = self.model.setdefault(name, ModelObject())
        m.data = bytearray(data)
        # writefull replaces the object but keeps nothing else? the op
        # interpreter's remove+write drops xattrs/omap too
        m.xattrs.clear()
        m.omap.clear()

    async def _op_append(self, name: str) -> None:
        data = self._blob(self.rng.randrange(1, self.max_size // 8))
        await self.ioctx.append(name, data)
        m = self.model.setdefault(name, ModelObject())
        m.data.extend(data)

    async def _op_truncate(self, name: str) -> None:
        size = self.rng.randrange(self.max_size)
        await self.ioctx.truncate(name, size)
        m = self.model.setdefault(name, ModelObject())
        if len(m.data) > size:
            del m.data[size:]
        else:
            m.data.extend(b"\0" * (size - len(m.data)))

    async def _op_read(self, name: str) -> None:
        m = self.model.get(name)
        try:
            data = await self.ioctx.read(name)
        except RadosError as e:
            assert e.rc == -2, f"read {name}: unexpected rc {e.rc}"
            assert m is None, f"read {name}: ENOENT but model has it"
            return
        assert m is not None, f"read {name}: data but model lacks it"
        assert data == bytes(m.data), (
            f"read {name}: mismatch ({len(data)} vs {len(m.data)} bytes)"
        )
        self.checks += 1

    async def _op_stat(self, name: str) -> None:
        m = self.model.get(name)
        try:
            st = await self.ioctx.stat(name)
        except RadosError as e:
            assert e.rc == -2 and m is None, f"stat {name}: {e.rc}, {m}"
            return
        assert m is not None, f"stat {name}: exists but model lacks it"
        assert st["size"] == len(m.data), \
            f"stat {name}: {st['size']} != {len(m.data)}"
        self.checks += 1

    async def _op_remove(self, name: str) -> None:
        try:
            await self.ioctx.remove(name)
        except RadosError as e:
            assert e.rc == -2, f"remove {name}: rc {e.rc}"
            assert name not in self.model
            return
        assert name in self.model, f"remove {name}: model lacked it"
        del self.model[name]

    async def _op_setxattr(self, name: str) -> None:
        key = f"x{self.rng.randrange(4)}"
        val = self._blob(16)
        await self.ioctx.set_xattr(name, key, val)
        m = self.model.setdefault(name, ModelObject())
        m.xattrs[key] = val

    async def _op_getxattr(self, name: str) -> None:
        m = self.model.get(name)
        key = f"x{self.rng.randrange(4)}"
        try:
            val = await self.ioctx.get_xattr(name, key)
        except RadosError as e:
            assert e.rc == -2, f"getxattr {name}: rc {e.rc}"
            assert m is None or key not in m.xattrs
            return
        assert m is not None and m.xattrs.get(key) == val
        self.checks += 1

    async def _op_omap_set(self, name: str) -> None:
        kv = {f"k{self.rng.randrange(6)}": self._blob(8)
              for _ in range(self.rng.randrange(1, 4))}
        await self.ioctx.set_omap(name, kv)
        m = self.model.setdefault(name, ModelObject())
        m.omap.update(kv)

    async def _op_omap_get(self, name: str) -> None:
        m = self.model.get(name)
        if m is None:
            if not self.ec:
                # reference do_osd_ops: omap reads on a missing object
                # are -ENOENT
                try:
                    await self.ioctx.get_omap(name)
                    raise AssertionError(
                        f"omap_get on absent {name} must ENOENT")
                except RadosError as e:
                    assert e.rc == -2, e
                self.checks += 1
            return
        kv = await self.ioctx.get_omap(name)
        assert kv == m.omap, f"omap {name}: {kv} != {m.omap}"
        self.checks += 1

    async def _op_multi(self, name: str) -> None:
        """Atomic batch: write + xattr in one op."""
        data = self._blob(self.rng.randrange(1, 4096))
        key = f"x{self.rng.randrange(4)}"
        val = self._blob(8)
        op = ObjectOperation().write_full(data).set_xattr(key, val)
        await self.ioctx.operate(name, op)
        m = self.model.setdefault(name, ModelObject())
        m.data = bytearray(data)
        m.xattrs = {key: val}
        m.omap.clear()

    # -- snapshot ops ------------------------------------------------------
    async def _op_snap_create(self, name: str) -> None:
        if len(self.snap_images) >= 6:
            return                       # bounded live snaps
        snapid = await self.ioctx.selfmanaged_snap_create()
        self.snap_images[snapid] = {
            n: bytes(m.data) for n, m in self.model.items()
        }

    async def _op_snap_remove(self, name: str) -> None:
        if not self.snap_images:
            return
        snapid = self.rng.choice(sorted(self.snap_images))
        await self.ioctx.selfmanaged_snap_remove(snapid)
        del self.snap_images[snapid]

    async def _op_snap_read(self, name: str) -> None:
        """Read an object as of a random live snap; the frozen oracle
        image predicts the exact bytes (or ENOENT)."""
        if not self.snap_images:
            return
        snapid = self.rng.choice(sorted(self.snap_images))
        image = self.snap_images[snapid]
        self.ioctx.snap_set_read(snapid)
        try:
            data = await self.ioctx.read(name)
        except RadosError as e:
            assert e.rc == -2, f"snapread {name}@{snapid}: rc {e.rc}"
            assert name not in image, (
                f"snapread {name}@{snapid}: ENOENT but snap image has it"
            )
            return
        finally:
            self.ioctx.snap_set_read(None)
        assert name in image, (
            f"snapread {name}@{snapid}: data but snap image lacks it"
        )
        assert data == image[name], (
            f"snapread {name}@{snapid}: mismatch "
            f"({len(data)} vs {len(image[name])} bytes)"
        )
        self.checks += 1

    # -- final sweep -------------------------------------------------------
    async def verify_all(self) -> int:
        """Compare the whole pool against the oracle (the final scan the
        reference runs after thrashing stops)."""
        listed = set(await self.ioctx.list_objects())
        model_names = set(self.model)
        extra = listed - model_names - {n for n in listed
                                        if not n.startswith("model-obj-")}
        missing = model_names - listed
        assert not extra, f"pool has unmodeled objects: {sorted(extra)}"
        assert not missing, f"pool lost objects: {sorted(missing)}"
        verified = 0
        for name, m in sorted(self.model.items()):
            data = await self.ioctx.read(name)
            assert data == bytes(m.data), f"verify {name}: data mismatch"
            if not self.ec:
                kv = await self.ioctx.get_omap(name)
                assert kv == m.omap, f"verify {name}: omap mismatch"
            for key, val in m.xattrs.items():
                got = await self.ioctx.get_xattr(name, key)
                assert got == val, f"verify {name}: xattr {key} mismatch"
            verified += 1
        return verified
