"""The subset of msgpack that a checkpoint payload uses, packed and unpacked
without the ``msgpack`` package.

The subset: maps with str keys, str, bin, ints from -2**63 to 2**64 - 1,
and arrays of ints (a payload is a map of maps of these). ``packb`` gives
the bytes of ``msgpack.packb(obj, use_bin_type=True)`` (the smallest
encoding of each value, the format's rule); ``unpackb`` reads them back as
``msgpack.unpackb(buf, raw=False)`` does, except that a bin comes back as a
read-only ``memoryview`` into ``buf`` (equal to the ``bytes`` msgpack gives,
and no copy of a leaf's data). Anything outside the subset raises
``ValueError``, on either side.
"""

from __future__ import annotations

import struct

__all__ = ["packb", "unpackb"]


def _pack_int(v: int, out: list) -> None:
    if 0 <= v < 0x80:
        out.append(bytes((v,)))
    elif -32 <= v < 0:
        out.append(bytes((v & 0xFF,)))
    elif 0 <= v <= 0xFF:
        out.append(b"\xcc" + struct.pack(">B", v))
    elif 0 <= v <= 0xFFFF:
        out.append(b"\xcd" + struct.pack(">H", v))
    elif 0 <= v <= 0xFFFFFFFF:
        out.append(b"\xce" + struct.pack(">I", v))
    elif 0 <= v <= 0xFFFFFFFFFFFFFFFF:
        out.append(b"\xcf" + struct.pack(">Q", v))
    elif -0x80 <= v < 0:
        out.append(b"\xd0" + struct.pack(">b", v))
    elif -0x8000 <= v < 0:
        out.append(b"\xd1" + struct.pack(">h", v))
    elif -0x80000000 <= v < 0:
        out.append(b"\xd2" + struct.pack(">i", v))
    elif -0x8000000000000000 <= v < 0:
        out.append(b"\xd3" + struct.pack(">q", v))
    else:
        raise ValueError(f"msgpack subset: int {v} does not fit 64 bits")


def _pack_len(n: int, fix: int, fix_max: int, heads: tuple, out: list, what: str) -> None:
    """A length header: the fix form below ``fix_max``, else the 8/16/32-bit
    forms in ``heads`` (None where the format has no such form)."""
    if fix is not None and n < fix_max:
        out.append(bytes((fix | n,)))
        return
    for head, fmt, top in zip(heads, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if head is not None and n <= top:
            out.append(head + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack subset: {what} of length {n} is too long")


def _pack(obj, out: list) -> None:
    if isinstance(obj, bool) or not isinstance(obj, (dict, str, bytes, int, list)):
        raise ValueError(f"msgpack subset: cannot pack {type(obj).__name__}")
    if isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), 0xA0, 32, (b"\xd9", b"\xda", b"\xdb"), out, "str")
        out.append(b)
    elif isinstance(obj, bytes):
        _pack_len(len(obj), None, 0, (b"\xc4", b"\xc5", b"\xc6"), out, "bin")
        out.append(obj)
    elif isinstance(obj, list):
        _pack_len(len(obj), 0x90, 16, (None, b"\xdc", b"\xdd"), out, "array")
        for v in obj:
            if isinstance(v, bool) or not isinstance(v, int):
                raise ValueError(f"msgpack subset: arrays hold ints, not {type(v).__name__}")
            _pack_int(v, out)
    else:
        _pack_len(len(obj), 0x80, 16, (None, b"\xde", b"\xdf"), out, "map")
        for k, v in obj.items():
            if not isinstance(k, str):
                raise ValueError(f"msgpack subset: map keys are str, not {type(k).__name__}")
            _pack(k, out)
            _pack(v, out)


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for a value of the subset."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


# fixed-width heads: code -> (struct format, byte count)
_UINTS = {0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8)}
_INTS = {0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8)}
_STR_LEN = {0xD9: (">B", 1), 0xDA: (">H", 2), 0xDB: (">I", 4)}
_BIN_LEN = {0xC4: (">B", 1), 0xC5: (">H", 2), 0xC6: (">I", 4)}
_ARRAY_LEN = {0xDC: (">H", 2), 0xDD: (">I", 4)}
_MAP_LEN = {0xDE: (">H", 2), 0xDF: (">I", 4)}


class _Reader:
    def __init__(self, buf):
        self.mv = memoryview(buf).toreadonly()
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.mv):
            raise ValueError("msgpack subset: truncated input")
        out = self.mv[self.pos:end]
        self.pos = end
        return out

    def fixed(self, fmt_n) -> int:
        fmt, n = fmt_n
        return struct.unpack(fmt, self.take(n))[0]

    def value(self):
        code = self.take(1)[0]
        if code < 0x80:
            return code
        if code >= 0xE0:
            return code - 0x100
        if code in _UINTS:
            return self.fixed(_UINTS[code])
        if code in _INTS:
            return self.fixed(_INTS[code])
        if 0xA0 <= code <= 0xBF or code in _STR_LEN:
            n = code & 0x1F if code <= 0xBF else self.fixed(_STR_LEN[code])
            return str(self.take(n), "utf-8")
        if code in _BIN_LEN:
            return self.take(self.fixed(_BIN_LEN[code]))
        if 0x90 <= code <= 0x9F or code in _ARRAY_LEN:
            n = code & 0x0F if code <= 0x9F else self.fixed(_ARRAY_LEN[code])
            out = [self.value() for _ in range(n)]
            if not all(isinstance(v, int) for v in out):
                raise ValueError("msgpack subset: arrays hold ints")
            return out
        if 0x80 <= code <= 0x8F or code in _MAP_LEN:
            n = code & 0x0F if code <= 0x8F else self.fixed(_MAP_LEN[code])
            out = {}
            for _ in range(n):
                k = self.value()
                if not isinstance(k, str):
                    raise ValueError("msgpack subset: map keys are str")
                out[k] = self.value()
            return out
        raise ValueError(f"msgpack subset: type byte 0x{code:02x} is outside the subset")


def unpackb(buf):
    """The object ``packb`` (or ``msgpack.packb``) wrote into ``buf``;
    trailing bytes are an error, as in ``msgpack.unpackb``."""
    r = _Reader(buf)
    obj = r.value()
    if r.pos != len(r.mv):
        raise ValueError(f"msgpack subset: {len(r.mv) - r.pos} bytes of extra data")
    return obj
