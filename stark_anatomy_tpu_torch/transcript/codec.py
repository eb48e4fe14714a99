"""Deterministic binary codec for transcript objects.

The reference serializes transcripts with ``pickle`` (ip.py:18-30); the
Fiat-Shamir challenge is a hash of those bytes, making pickle part of the
protocol.  Here the codec is an explicit, versioned tag-length-value format:
deterministic, safe to deserialize, and fast.  The challenge derivation
contract (hash of the serialized transcript prefix) is unchanged.

Supported transcript object types:
  bytes                      -- Merkle roots / digests
  int                        -- a field element (canonical, 16-byte big-endian)
  tuple[int, ...]            -- revealed leaf groups (e.g. FRI (a,b,c))
  list[int]                  -- codewords
  list[bytes]                -- Merkle authentication paths

An empty list encodes as an empty list[int].  ``encode_felt_lists``,
``encode_felt_tuples`` and ``encode_bytes_lists`` give a batch's objects'
bytes at once, from canonical limb rows and digest arrays (numpy), byte
for byte ``encode_obj`` of each (ProofStream.push_encoded takes them).
"""

from __future__ import annotations

import struct
from typing import List, Sequence, Tuple, Union

import numpy as np

from ..errors import MalformedProof
from ..field.limbs import LIMB_BITS

TranscriptObject = Union[bytes, int, Tuple[int, ...], List[int], List[bytes]]

MAGIC = b"STPU1"
_FE_BYTES = 16

_TAG_BYTES = 1
_TAG_FELT = 2
_TAG_FELT_TUPLE = 3
_TAG_FELT_LIST = 4
_TAG_BYTES_LIST = 5


def encode_obj(obj: TranscriptObject) -> bytes:
    if isinstance(obj, bytes):
        return struct.pack(">BI", _TAG_BYTES, len(obj)) + obj
    if isinstance(obj, int):
        return struct.pack(">B", _TAG_FELT) + obj.to_bytes(_FE_BYTES, "big")
    if isinstance(obj, tuple):
        assert all(isinstance(v, int) for v in obj)
        body = b"".join(v.to_bytes(_FE_BYTES, "big") for v in obj)
        return struct.pack(">BB", _TAG_FELT_TUPLE, len(obj)) + body
    if isinstance(obj, list):
        if obj and isinstance(obj[0], bytes):
            assert all(isinstance(v, bytes) for v in obj)
            body = b"".join(struct.pack(">H", len(v)) + v for v in obj)
            return struct.pack(">BH", _TAG_BYTES_LIST, len(obj)) + body
        assert all(isinstance(v, int) for v in obj)
        body = b"".join(v.to_bytes(_FE_BYTES, "big") for v in obj)
        return struct.pack(">BI", _TAG_FELT_LIST, len(obj)) + body
    raise TypeError(f"cannot encode transcript object of type {type(obj)}")


def _felt_bytes(rows: np.ndarray) -> np.ndarray:
    """Canonical element-major limb rows (..., NLIMBS) -> each element's
    _FE_BYTES big-endian bytes (..., _FE_BYTES) uint8."""
    assert LIMB_BITS == 16
    return np.ascontiguousarray(rows, dtype="<u2").view(np.uint8)[..., ::-1]


def encode_felt_lists(rows: np.ndarray) -> np.ndarray:
    """(B, k, NLIMBS) rows -> (B, 5 + 16 k) uint8: row b is encode_obj of
    the list of row b's k elements."""
    B, k = rows.shape[:2]
    out = np.empty((B, 5 + _FE_BYTES * k), dtype=np.uint8)
    out[:, :5] = np.frombuffer(struct.pack(">BI", _TAG_FELT_LIST, k), dtype=np.uint8)
    out[:, 5:] = _felt_bytes(rows).reshape(B, -1)
    return out


def encode_felt_tuples(rows: np.ndarray) -> np.ndarray:
    """(..., m, NLIMBS) rows -> (..., 2 + 16 m) uint8: encode_obj of each
    m-tuple of elements."""
    m = rows.shape[-2]
    out = np.empty(rows.shape[:-2] + (2 + _FE_BYTES * m,), dtype=np.uint8)
    out[..., :2] = (_TAG_FELT_TUPLE, m)
    out[..., 2:] = _felt_bytes(rows).reshape(rows.shape[:-2] + (-1,))
    return out


def encode_bytes_lists(items: np.ndarray, counts: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """B lists of equal-length byte strings, the rows of ``items`` (M, w)
    uint8 in list order, list b of ``counts[b]`` -> (data, ends): data the
    lists' encode_obj bytes one after another, ends[b] the end of list b's
    in data."""
    counts = np.asarray(counts, dtype=np.int64)
    M, w = items.shape
    assert counts.sum() == M and (counts < 1 << 16).all() and w < 1 << 16
    head = np.where(counts > 0, 3, 5)             # an empty list is an empty list[int]
    sizes = head + counts * (2 + w)
    ends = np.cumsum(sizes)
    starts = ends - sizes
    out = np.zeros(int(ends[-1]) if len(ends) else 0, dtype=np.uint8)
    out[starts] = np.where(counts > 0, _TAG_BYTES_LIST, _TAG_FELT_LIST)
    out[starts + 1] = counts >> 8
    out[starts + 2] = counts & 0xFF
    body = np.ones(out.size, dtype=bool)
    hdr = starts[:, None] + np.arange(5)
    body[hdr[np.arange(5) < head[:, None]]] = False
    records = np.empty((M, 2 + w), dtype=np.uint8)
    records[:, :2] = (w >> 8, w & 0xFF)
    records[:, 2:] = items
    out[body] = records.reshape(-1)
    return out, ends


def _need(buf: bytes, pos: int, n: int) -> None:
    if pos + n > len(buf):
        raise MalformedProof(
            f"truncated transcript: need {n} bytes at offset {pos}, "
            f"have {len(buf) - pos}"
        )


def decode_obj(buf: bytes, pos: int):
    """Decode one object; raises MalformedProof (never IndexError or
    struct.error) on truncated or corrupt input."""
    _need(buf, pos, 1)
    tag = buf[pos]
    pos += 1
    if tag == _TAG_BYTES:
        _need(buf, pos, 4)
        (n,) = struct.unpack_from(">I", buf, pos)
        pos += 4
        _need(buf, pos, n)
        return bytes(buf[pos : pos + n]), pos + n
    if tag == _TAG_FELT:
        _need(buf, pos, _FE_BYTES)
        v = int.from_bytes(buf[pos : pos + _FE_BYTES], "big")
        return v, pos + _FE_BYTES
    if tag == _TAG_FELT_TUPLE:
        _need(buf, pos, 1)
        n = buf[pos]
        pos += 1
        _need(buf, pos, n * _FE_BYTES)
        vals = tuple(
            int.from_bytes(buf[pos + i * _FE_BYTES : pos + (i + 1) * _FE_BYTES], "big")
            for i in range(n)
        )
        return vals, pos + n * _FE_BYTES
    if tag == _TAG_FELT_LIST:
        _need(buf, pos, 4)
        (n,) = struct.unpack_from(">I", buf, pos)
        pos += 4
        _need(buf, pos, n * _FE_BYTES)
        vals = [
            int.from_bytes(buf[pos + i * _FE_BYTES : pos + (i + 1) * _FE_BYTES], "big")
            for i in range(n)
        ]
        return vals, pos + n * _FE_BYTES
    if tag == _TAG_BYTES_LIST:
        _need(buf, pos, 2)
        (n,) = struct.unpack_from(">H", buf, pos)
        pos += 2
        out = []
        for _ in range(n):
            _need(buf, pos, 2)
            (m,) = struct.unpack_from(">H", buf, pos)
            pos += 2
            _need(buf, pos, m)
            out.append(bytes(buf[pos : pos + m]))
            pos += m
        return out, pos
    raise MalformedProof(f"bad transcript tag {tag} at offset {pos - 1}")


def serialize(objects: List[TranscriptObject]) -> bytes:
    return MAGIC + b"".join(encode_obj(o) for o in objects)


def deserialize(data: bytes) -> List[TranscriptObject]:
    if data[: len(MAGIC)] != MAGIC:
        raise MalformedProof("bad proof magic")
    pos = len(MAGIC)
    out = []
    while pos < len(data):
        obj, pos = decode_obj(data, pos)
        out.append(obj)
    return out
