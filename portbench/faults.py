"""Breaks planted under the timed path, to show that ``correct`` catches
them: the control (a cheaper parity in place of the configuration's
code) and one fault of each kind a cell can have.  Each is a context
manager that patches a class of the port for its duration; the
benchmark's own runs install none."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(cls, attr: str, make):
    orig = getattr(cls, attr)
    setattr(cls, attr, make(orig))
    try:
        yield
    finally:
        setattr(cls, attr, orig)


def _xor_rows(out, k: int):
    """Every parity row of an encode's (..., k+m, C) output replaced by
    the XOR of its data rows."""
    x = out[..., 0, :].clone()
    for i in range(1, k):
        x ^= out[..., i, :]
    out[..., k:, :] = x.unsqueeze(-2)
    return out


@contextlib.contextmanager
def xor_parity():
    """The control: the encoder computes RAID-5 parity (the XOR of the
    data) in all m parity shards, where the configuration's code is
    Reed-Solomon: still one launch per encode, and every healthy read
    still right, but no longer 'any m of k+m shards may be lost'."""
    from ceph_tpu_torch.ec.plugins.jax_rs import ErasureCodeJaxRS as C

    def chunks(orig):
        def f(self, data):
            return _xor_rows(orig(self, data), self.k)
        return f

    def words(orig):
        def f(self, words, out=None):
            parity = orig(self, words, out)
            x = words[0].clone()
            for i in range(1, self.k):
                x ^= words[i]
            parity[:] = x
            return parity
        return f

    with _patched(C, "encode_chunks_device", chunks), \
            _patched(C, "encode_shards_device", chunks), \
            _patched(C, "encode_words_device", words):
        yield


@contextlib.contextmanager
def half_batch():
    """Half of each encode batch left out: the parity of the second half
    of the stripes (or of the shard streams) is left zero."""
    from ceph_tpu_torch.ec.plugins.jax_rs import ErasureCodeJaxRS as C

    def chunks(orig):
        def f(self, data):
            out = orig(self, data)
            if out.dim() == 3:
                out[out.shape[0] // 2:, self.k:, :] = 0
            else:
                out[self.k:, out.shape[-1] // 2:] = 0
            return out
        return f

    def words(orig):
        def f(self, words, out=None):
            parity = orig(self, words, out)
            parity[:, parity.shape[-1] // 2:] = 0
            return parity
        return f

    with _patched(C, "encode_chunks_device", chunks), \
            _patched(C, "encode_shards_device", chunks), \
            _patched(C, "encode_words_device", words):
        yield


@contextlib.contextmanager
def half_decode():
    """Half of each decode batch left out: the rebuilt chunks of the
    second half of the stripes are left zero."""
    from ceph_tpu_torch.ec.plugins.jax_rs import ErasureCodeJaxRS as C

    def dev(orig):
        def f(self, D, stacked):
            out = orig(self, D, stacked)
            if out.dim() == 3:
                out[out.shape[0] // 2:] = 0
            else:
                out[..., out.shape[-1] // 2:] = 0
            return out
        return f

    def words(orig):
        def f(self, available, want):
            out = orig(self, available, want)
            out[..., out.shape[-1] // 2:] = 0
            return out
        return f

    with _patched(C, "_apply_decode", dev), \
            _patched(C, "decode_words_device", words):
        yield


@contextlib.contextmanager
def unchanged_write():
    """A step that returns its state unchanged: every other write_full
    is acknowledged without being sent."""
    from ceph_tpu_torch.client.rados import IoCtx

    def make(orig):
        n = [0]

        async def f(self, oid, data):
            n[0] += 1
            if n[0] % 2:
                return None
            return await orig(self, oid, data)
        return f

    with _patched(IoCtx, "write_full", make):
        yield


@contextlib.contextmanager
def dropped_exchange():
    """The exchange between daemons left out: a primary's shard write to
    a peer OSD is acknowledged without being sent."""
    from ceph_tpu_torch.osd.daemon import NetworkShard

    def make(orig):
        async def f(self, oid, offset, data, attrs, log=None):
            return None
        return f

    with _patched(NetworkShard, "write_shard", make):
        yield


@contextlib.contextmanager
def altered_read():
    """An answer altered where it is produced: one byte of every object
    read through librados flipped."""
    from ceph_tpu_torch.client.rados import IoCtx

    def make(orig):
        async def f(self, oid, *args, **kw):
            data = await orig(self, oid, *args, **kw)
            if data:
                data = bytes([data[0] ^ 0x01]) + data[1:]
            return data
        return f

    with _patched(IoCtx, "read", make):
        yield


FAULTS = {
    "unchanged_write": unchanged_write,
    "half_batch": half_batch,
    "half_decode": half_decode,
    "dropped_exchange": dropped_exchange,
    "altered_read": altered_read,
}
