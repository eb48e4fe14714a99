"""Multi-limb representation of the 128-bit STARK field.

Field elements are 8 little-endian 16-bit limbs on a limb axis:

    x = sum_k limbs[..., k] << (16*k),   0 <= limbs[..., k] < 2^16.

This is the JAX package's layout (stark_anatomy_tpu/field/limbs.py), kept
at the port's public functions so the two packages compare array for
array.  The port stores the limbs as torch.int32; the CUDA kernels
(csrc/field.cu) pack them into four 32-bit words in registers.

Device arrays produced by the conversions in utils/convert.py are in
**Montgomery form** (x*R mod p with R = 2^128); every kernel assumes this.

This module is pure numpy (host side).
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np

from .scalar import P

LIMB_BITS = 16
NLIMBS = 8
MASK = (1 << LIMB_BITS) - 1
R = (1 << (LIMB_BITS * NLIMBS)) % P          # 2^128 mod p  (= Montgomery one)
R2 = pow(1 << (LIMB_BITS * NLIMBS), 2, P)     # 2^256 mod p
# -p^{-1} mod 2^128, the Montgomery reduction constant.
NPRIME = (-pow(P, -1, 1 << (LIMB_BITS * NLIMBS))) % (1 << (LIMB_BITS * NLIMBS))


def int_to_limbs(x: int) -> List[int]:
    """Split a canonical integer in [0, 2^128) into 8 little-endian 16-bit limbs."""
    assert 0 <= x < (1 << (LIMB_BITS * NLIMBS))
    return [(x >> (LIMB_BITS * k)) & MASK for k in range(NLIMBS)]


def limbs_to_int(limbs: Sequence[int]) -> int:
    acc = 0
    for k in range(NLIMBS - 1, -1, -1):
        acc = (acc << LIMB_BITS) | int(limbs[k])
    return acc


def ints_to_array(values: Iterable[int], montgomery: bool = True) -> np.ndarray:
    """Pack canonical ints into a (n, NLIMBS) uint32 array.

    With ``montgomery=True`` (the default) the values are pre-multiplied by
    R so the resulting array is in the device's Montgomery encoding.
    """
    vals = [v % P for v in values]
    if montgomery:
        vals = [v * R % P for v in vals]
    out = np.empty((len(vals), NLIMBS), dtype=np.uint32)
    for i, v in enumerate(vals):
        out[i] = int_to_limbs(v)
    return out


def array_to_ints(arr: np.ndarray, montgomery: bool = True) -> List[int]:
    """Unpack a (..., NLIMBS) uint32 array back to canonical ints."""
    a = np.asarray(arr)
    flat = a.reshape(-1, NLIMBS)
    rinv = pow(R, -1, P) if montgomery else 1
    out = []
    for row in flat:
        v = limbs_to_int(row)
        out.append(v * rinv % P if montgomery else v)
    return out


# Precomputed numpy limb constants (canonical, i.e. non-Montgomery limbs of
# already-Montgomery-encoded values where noted).
P_LIMBS = np.array(int_to_limbs(P), dtype=np.uint32)
NPRIME_LIMBS = np.array(int_to_limbs(NPRIME), dtype=np.uint32)
ONE_MONT_LIMBS = np.array(int_to_limbs(R), dtype=np.uint32)          # mont(1)
R2_LIMBS = np.array(int_to_limbs(R2), dtype=np.uint32)                # mont(R)
ZERO_LIMBS = np.zeros(NLIMBS, dtype=np.uint32)
