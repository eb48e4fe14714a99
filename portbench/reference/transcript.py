"""The proof's transcript as the verifier reads it: the tag-length-value
codec, typed pulls, and the Fiat-Shamir challenge over the prefix read
so far (shake-256 of a domain prefix and the transcript's bytes)."""

from __future__ import annotations

import hashlib
import struct
from typing import List

MAGIC = b"STPU1"
_FE = 16


class Malformed(Exception):
    """The bytes are not a well-formed transcript."""


def _take(buf: bytes, pos: int, n: int) -> bytes:
    if pos + n > len(buf):
        raise Malformed(f"truncated at offset {pos}")
    return buf[pos:pos + n]


def _decode(buf: bytes, pos: int):
    tag = _take(buf, pos, 1)[0]
    pos += 1
    if tag == 1:                                   # bytes
        (n,) = struct.unpack(">I", _take(buf, pos, 4))
        return bytes(_take(buf, pos + 4, n)), pos + 4 + n
    if tag == 2:                                   # one element
        return int.from_bytes(_take(buf, pos, _FE), "big"), pos + _FE
    if tag in (3, 4):                              # tuple / list of elements
        width = 1 if tag == 3 else 4
        n = int.from_bytes(_take(buf, pos, width), "big")
        pos += width
        body = _take(buf, pos, n * _FE)
        vals = [int.from_bytes(body[i * _FE:(i + 1) * _FE], "big") for i in range(n)]
        return (tuple(vals) if tag == 3 else vals), pos + n * _FE
    if tag == 5:                                   # list of byte strings
        (n,) = struct.unpack(">H", _take(buf, pos, 2))
        pos += 2
        out = []
        for _ in range(n):
            (m,) = struct.unpack(">H", _take(buf, pos, 2))
            out.append(bytes(_take(buf, pos + 2, m)))
            pos += 2 + m
        return out, pos
    raise Malformed(f"bad tag {tag} at offset {pos - 1}")


class Transcript:
    """The verifier's side of a serialized proof."""

    def __init__(self, data: bytes, prefix: bytes = b""):
        if data[:len(MAGIC)] != MAGIC:
            raise Malformed("bad magic")
        self.data = data
        self.prefix = prefix
        self.objects: List[object] = []
        self.ends: List[int] = [len(MAGIC)]
        pos = len(MAGIC)
        while pos < len(data):
            obj, pos = _decode(data, pos)
            self.objects.append(obj)
            self.ends.append(pos)
        self.read = 0

    def pull(self, kind):
        if self.read >= len(self.objects):
            raise Malformed("pull past the end")
        obj = self.objects[self.read]
        self.read += 1
        if not isinstance(obj, kind):
            raise Malformed(f"object {self.read - 1} is {type(obj).__name__}, not {kind.__name__}")
        return obj

    def challenge(self, num_bytes: int = 32) -> bytes:
        """The challenge the prover drew after the objects read so far."""
        return hashlib.shake_256(self.prefix + self.data[:self.ends[self.read]]).digest(num_bytes)

    def exhausted(self) -> bool:
        return self.read == len(self.objects)
