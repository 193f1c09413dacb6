"""Protobuf wire format: the encode and decode helpers that the port's
codecs share (``onnx_proto`` for ONNX, ``tf_proto`` for the SavedModel).

Numpy only: no ``google.protobuf``.  ``enc_*`` give one field's bytes;
``Writer`` collects a message as a list of parts, so that a large payload
(a graph's constants) is copied once, when the file is joined, and not
once for every message it is nested in.  ``Reader`` walks a buffer and
``fields`` yields a message's fields; over a ``memoryview`` their
length-delimited values are views, not copies.
"""

from __future__ import annotations

import struct

VARINT, I64, LEN, I32 = 0, 1, 2, 5


def enc_varint(v: int) -> bytes:
    if v < 0:
        v &= (1 << 64) - 1  # two's-complement 64-bit, per protobuf int64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def enc_key(fieldno: int, wire: int) -> bytes:
    return enc_varint((fieldno << 3) | wire)


def enc_int(fieldno: int, v: int) -> bytes:
    return enc_key(fieldno, VARINT) + enc_varint(int(v))


def enc_float(fieldno: int, v: float) -> bytes:
    return enc_key(fieldno, I32) + struct.pack("<f", float(v))


def enc_bytes(fieldno: int, v: bytes) -> bytes:
    return enc_key(fieldno, LEN) + enc_varint(len(v)) + v


def enc_str(fieldno: int, v: str) -> bytes:
    return enc_bytes(fieldno, v.encode("utf-8"))


class Writer:
    """A message as a list of byte parts and their total length."""

    def __init__(self):
        self.parts: list = []
        self.n = 0

    def raw(self, b) -> "Writer":
        self.parts.append(b)
        self.n += len(b)
        return self

    def int(self, fieldno: int, v: int) -> "Writer":
        return self.raw(enc_int(fieldno, v))

    def float(self, fieldno: int, v: float) -> "Writer":
        return self.raw(enc_float(fieldno, v))

    def fixed32(self, fieldno: int, v: int) -> "Writer":
        return self.raw(enc_key(fieldno, I32) + struct.pack("<I", v))

    def bytes(self, fieldno: int, v) -> "Writer":
        self.raw(enc_key(fieldno, LEN) + enc_varint(len(v)))
        return self.raw(v)

    def str(self, fieldno: int, v: str) -> "Writer":
        return self.bytes(fieldno, v.encode("utf-8"))

    def msg(self, fieldno: int, sub: "Writer") -> "Writer":
        self.raw(enc_key(fieldno, LEN) + enc_varint(sub.n))
        self.parts.extend(sub.parts)
        self.n += sub.n
        return self

    def packed(self, fieldno: int, vs) -> "Writer":
        body = b"".join(enc_varint(int(v)) for v in vs)
        return self.bytes(fieldno, body)

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


class Reader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def eof(self) -> bool:
        return self.pos >= len(self.buf)

    def varint(self) -> int:
        v, shift = 0, 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7

    def svarint(self) -> int:
        v = self.varint()
        return v - (1 << 64) if v >= (1 << 63) else v

    def key(self) -> tuple[int, int]:
        k = self.varint()
        return k >> 3, k & 7

    def bytes_(self):
        n = self.varint()
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def f32(self) -> float:
        v = struct.unpack_from("<f", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def skip(self, wire: int) -> None:
        if wire == VARINT:
            self.varint()
        elif wire == I64:
            self.pos += 8
        elif wire == LEN:
            n = self.varint()   # NB: must evaluate BEFORE the += reads pos
            self.pos += n
        elif wire == I32:
            self.pos += 4
        else:
            raise ValueError(f"bad wire type {wire}")


def fields(buf):
    """Each field of a message in order: (number, wire type, value), the
    value an int for a varint, the bytes (a view, over a ``memoryview``)
    of a length-delimited or fixed-width field."""
    r = Reader(buf)
    while not r.eof():
        f, w = r.key()
        if w == VARINT:
            yield f, w, r.varint()
        elif w == LEN:
            yield f, w, r.bytes_()
        elif w in (I32, I64):
            n = 4 if w == I32 else 8
            r.pos += n
            yield f, w, r.buf[r.pos - n:r.pos]
        else:
            raise ValueError(f"bad wire type {w}")


def varints(buf) -> list[int]:
    """A packed repeated field's varints."""
    r, out = Reader(buf), []
    while not r.eof():
        out.append(r.varint())
    return out
