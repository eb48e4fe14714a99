"""N1: the host blake2s hasher of the Merkle trees, over numpy arrays.

The port of stark_anatomy_tpu/native/__init__.py (build and load) and
native/blake2b_batch.py (the numpy wrappers) for the blake2s commitment
scheme (commit/hashing.py).  The library is csrc/blake2s_host.cpp, built
at first use by one call of the host C++ compiler into ``_build/``
(utils/build.py) and loaded with ctypes.  There is no fallback: if the
library does not build or load, the call raises.

The ``*_plain`` functions compute the same digests with hashlib, one call
per message; the tests hold the library against them.
"""

from __future__ import annotations

import ctypes
import os
from hashlib import blake2s
from typing import Sequence

import numpy as np

from ..utils.build import Job, build_all, host_compiler
from .hashing import DIGEST_LEN

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "blake2s_host.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall")

_lib = None


def build() -> str:
    """Compile csrc/blake2s_host.cpp unless it was built already; returns
    the path of the shared library."""
    paths, _ = build_all([Job("stark_blake2s", host_compiler(), CXX_FLAGS, SOURCE)])
    return paths["stark_blake2s"]


def load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        ptr, u64 = ctypes.c_void_p, ctypes.c_uint64
        lib.stark_hash_batch_s.argtypes = [ptr, ptr, u64, ptr]
        for name in ("stark_merkle_level_s", "stark_leaves_from_limbs_s",
                     "stark_leaves_from_limb_pairs_s"):
            getattr(lib, name).argtypes = [ptr, u64, ptr]
        _lib = lib
    return _lib


def _digests(count: int) -> np.ndarray:
    return np.empty((count, DIGEST_LEN), dtype=np.uint8)


def hash_encodings(encodings: Sequence[bytes]) -> np.ndarray:
    """blake2s over each byte string -> (n, DIGEST_LEN) uint8 digests."""
    n = len(encodings)
    offsets = np.zeros(n + 1, dtype=np.uint64)
    np.cumsum([len(e) for e in encodings], out=offsets[1:])
    buf = np.frombuffer(b"".join(encodings) or b"\0", dtype=np.uint8)
    out = _digests(n)
    load().stark_hash_batch_s(buf.ctypes.data, offsets.ctypes.data, n, out.ctypes.data)
    return out


def merkle_level(digests: np.ndarray) -> np.ndarray:
    """(n, DIGEST_LEN) digests -> (n/2, DIGEST_LEN) parent digests."""
    d = np.ascontiguousarray(digests, dtype=np.uint8)
    out = _digests(d.shape[0] // 2)
    load().stark_merkle_level_s(d.ctypes.data, d.shape[0], out.ctypes.data)
    return out


def leaves_from_limb_pairs(limbs: np.ndarray) -> np.ndarray:
    """Canonical (n, 8) limb rows -> (n/2, DIGEST_LEN) PAIRED leaf digests:
    leaf i hashes LE16(v_i) || LE16(v_{i+n/2})."""
    arr = np.ascontiguousarray(limbs, dtype=np.uint32)
    out = _digests(arr.shape[0] // 2)
    load().stark_leaves_from_limb_pairs_s(arr.ctypes.data, arr.shape[0], out.ctypes.data)
    return out


def leaves_from_limbs(limbs: np.ndarray) -> np.ndarray:
    """Canonical (n, 8) limb rows -> (n, DIGEST_LEN) leaf digests of each
    element's 16-byte little-endian encoding."""
    arr = np.ascontiguousarray(limbs, dtype=np.uint32)
    out = _digests(arr.shape[0])
    load().stark_leaves_from_limbs_s(arr.ctypes.data, arr.shape[0], out.ctypes.data)
    return out


# ---------------------------------------------------------------------------
# plain versions (hashlib)
# ---------------------------------------------------------------------------

def _hash_chunks(data: bytes, width: int) -> np.ndarray:
    """blake2s over consecutive ``width``-byte chunks -> (k, DIGEST_LEN)."""
    k = len(data) // width
    out = b"".join(blake2s(data[i * width : (i + 1) * width]).digest() for i in range(k))
    return np.frombuffer(out, dtype=np.uint8).reshape(k, DIGEST_LEN)


def hash_encodings_plain(encodings: Sequence[bytes]) -> np.ndarray:
    out = b"".join(blake2s(e).digest() for e in encodings)
    return np.frombuffer(out, dtype=np.uint8).reshape(len(encodings), DIGEST_LEN)


def merkle_level_plain(digests: np.ndarray) -> np.ndarray:
    return _hash_chunks(np.ascontiguousarray(digests).tobytes(), 2 * DIGEST_LEN)


def leaves_from_limb_pairs_plain(limbs: np.ndarray) -> np.ndarray:
    half = limbs.shape[0] // 2
    enc = np.concatenate([limbs[:half], limbs[half : 2 * half]], axis=1).astype("<u2")
    return _hash_chunks(enc.tobytes(), 4 * limbs.shape[1])


def leaves_from_limbs_plain(limbs: np.ndarray) -> np.ndarray:
    return _hash_chunks(np.asarray(limbs).astype("<u2").tobytes(), 2 * limbs.shape[1])
