"""Compact self-describing binary codec for control-plane types.

The denc/encoding role (reference src/include/denc.h:52, encoding.h):
versioned, deterministic encode/decode of every wire type. The reference
hand-writes encode/decode per type over bufferlists; here one recursive
tagged codec covers the control plane (bulk data stays in numpy/device
arrays and never passes through it).

Wire grammar (all ints little-endian):
  value   := tag:u8 body
  N       -> None                      T/F -> bool
  i       -> i64                       I   -> big int (u32 len + sign byte + magnitude)
  f       -> f64
  s/b     -> u32 len + utf8/bytes
  l       -> u32 count + values        d   -> u32 count + (key value)*

Port copy of ceph_tpu/msg/codec.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import struct

_PACK_I64 = struct.Struct("<q")
_PACK_F64 = struct.Struct("<d")
_PACK_U32 = struct.Struct("<I")

_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


def _encode_into(out: bytearray, v) -> None:
    if v is None:
        out += b"N"
    elif v is True:
        out += b"T"
    elif v is False:
        out += b"F"
    elif isinstance(v, int):
        if _I64_MIN <= v <= _I64_MAX:
            out += b"i"
            out += _PACK_I64.pack(v)
        else:
            mag = abs(v)
            raw = mag.to_bytes((mag.bit_length() + 7) // 8, "little")
            out += b"I"
            out += _PACK_U32.pack(len(raw))
            out += b"-" if v < 0 else b"+"
            out += raw
    elif isinstance(v, float):
        out += b"f"
        out += _PACK_F64.pack(v)
    elif isinstance(v, str):
        raw = v.encode()
        out += b"s"
        out += _PACK_U32.pack(len(raw))
        out += raw
    elif isinstance(v, (bytes, bytearray, memoryview)):
        raw = bytes(v)
        out += b"b"
        out += _PACK_U32.pack(len(raw))
        out += raw
    elif isinstance(v, (list, tuple)):
        out += b"l"
        out += _PACK_U32.pack(len(v))
        for item in v:
            _encode_into(out, item)
    elif isinstance(v, dict):
        out += b"d"
        out += _PACK_U32.pack(len(v))
        for key, item in v.items():
            _encode_into(out, key)
            _encode_into(out, item)
    else:
        raise TypeError(f"codec: unsupported type {type(v).__name__}")


def encode(v) -> bytes:
    out = bytearray()
    _encode_into(out, v)
    return bytes(out)


def _decode_at(buf: memoryview, pos: int):
    tag = buf[pos]
    pos += 1
    if tag == 0x4E:                                   # N
        return None, pos
    if tag == 0x54:                                   # T
        return True, pos
    if tag == 0x46:                                   # F
        return False, pos
    if tag == 0x69:                                   # i
        return _PACK_I64.unpack_from(buf, pos)[0], pos + 8
    if tag == 0x49:                                   # I
        (n,) = _PACK_U32.unpack_from(buf, pos)
        pos += 4
        sign = buf[pos]
        pos += 1
        mag = int.from_bytes(bytes(buf[pos:pos + n]), "little")
        return (-mag if sign == 0x2D else mag), pos + n
    if tag == 0x66:                                   # f
        return _PACK_F64.unpack_from(buf, pos)[0], pos + 8
    if tag == 0x73:                                   # s
        (n,) = _PACK_U32.unpack_from(buf, pos)
        pos += 4
        return bytes(buf[pos:pos + n]).decode(), pos + n
    if tag == 0x62:                                   # b
        (n,) = _PACK_U32.unpack_from(buf, pos)
        pos += 4
        return bytes(buf[pos:pos + n]), pos + n
    if tag == 0x6C:                                   # l
        (n,) = _PACK_U32.unpack_from(buf, pos)
        pos += 4
        items = []
        for _ in range(n):
            item, pos = _decode_at(buf, pos)
            items.append(item)
        return items, pos
    if tag == 0x64:                                   # d
        (n,) = _PACK_U32.unpack_from(buf, pos)
        pos += 4
        d = {}
        for _ in range(n):
            key, pos = _decode_at(buf, pos)
            val, pos = _decode_at(buf, pos)
            d[key] = val
        return d, pos
    raise ValueError(f"codec: bad tag {tag:#x} at offset {pos - 1}")


def decode(raw: bytes):
    view = memoryview(raw)
    value, pos = _decode_at(view, 0)
    if pos != len(view):
        raise ValueError(f"codec: {len(view) - pos} trailing bytes")
    return value
