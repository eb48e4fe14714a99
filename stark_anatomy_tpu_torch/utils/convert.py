"""Host <-> device conversion of field-element tensors.

The port of stark_anatomy_tpu/utils/convert.py.  Device layout is
LIMB-FIRST (..., NLIMBS, n) int32 in Montgomery form; the host side is
canonical Python ints (transcripts) or element-major canonical numpy limb
rows (Merkle leaves).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..field import ops as F
from ..field.limbs import LIMB_BITS, NLIMBS, R
from ..field.scalar import P

ELEMENT_BYTES = NLIMBS * LIMB_BITS // 8       # an element's canonical little-endian bytes


def device_from_ints(values: Sequence[int], device) -> torch.Tensor:
    """Canonical ints -> Montgomery limb tensor (NLIMBS, n) on ``device``:
    each value's Montgomery form as ELEMENT_BYTES little-endian bytes, the
    whole list read as 16-bit limbs at once."""
    data = b"".join((v % P * R % P).to_bytes(ELEMENT_BYTES, "little") for v in values)
    limbs = np.frombuffer(data, dtype="<u2").reshape(len(values), NLIMBS)
    return torch.from_numpy(np.ascontiguousarray(limbs.T, dtype=np.int32)).to(device)


def ints_from_device(arr: torch.Tensor) -> List[int]:
    """Montgomery limb tensor (..., NLIMBS, n) -> canonical ints, flattened
    in element order."""
    canon = F.from_mont(arr).cpu().numpy()
    flat = np.moveaxis(canon, -2, 0).reshape(NLIMBS, -1)
    acc = flat[NLIMBS - 1].astype(object)
    for k in range(NLIMBS - 2, -1, -1):
        acc = (acc << LIMB_BITS) | flat[k].astype(object)
    return [int(v) for v in acc]


def canonical_np(arr: torch.Tensor) -> np.ndarray:
    """Montgomery tensor (..., NLIMBS, n) -> canonical ELEMENT-MAJOR numpy
    limb array (..., n, NLIMBS) uint32: the row-per-element layout the
    Merkle leaves hash."""
    return limb_rows_np(F.from_mont(arr))


def limb_rows_np(canon: torch.Tensor) -> np.ndarray:
    """Canonical limb tensor (..., NLIMBS, n) -> element-major numpy rows
    (..., n, NLIMBS) uint32, as ``canonical_np`` gives them."""
    rows = canon.cpu().numpy().astype(np.uint32)
    return np.ascontiguousarray(np.moveaxis(rows, -2, -1))


def ints_from_rows(rows: np.ndarray) -> List[int]:
    """Canonical element-major limb rows (k, NLIMBS) -> Python ints, read
    from one byte string (``int_from_row`` of each row)."""
    data = np.ascontiguousarray(rows, dtype="<u2").tobytes()
    return [int.from_bytes(data[i:i + ELEMENT_BYTES], "little")
            for i in range(0, len(data), ELEMENT_BYTES)]


def int_from_row(row: np.ndarray) -> int:
    """One canonical element-major limb row (NLIMBS,) -> Python int."""
    acc = 0
    for k in range(NLIMBS - 1, -1, -1):
        acc = (acc << LIMB_BITS) | int(row[k])
    return acc


def rows_from_ints(values: Sequence[int]) -> np.ndarray:
    """Canonical ints -> element-major limb rows (len, NLIMBS) uint32, read
    from one byte string."""
    data = b"".join(v.to_bytes(ELEMENT_BYTES, "little") for v in values)
    return np.frombuffer(data, dtype="<u2").reshape(-1, NLIMBS).astype(np.uint32)


def gather_limbs(rows, indices) -> np.ndarray:
    """Canonical element-major limb rows (..., NLIMBS) at an index array
    (...) of a layer: held on the card or as a forest's blocks (its
    ``limbs_at``: one gather), as a host int list, or as element-major
    numpy rows, (n, NLIMBS) or stacked (B, n, NLIMBS), whose proof b reads
    its own rows at indices[b]."""
    if hasattr(rows, "limbs_at"):
        return rows.limbs_at(indices)
    idx = np.asarray(indices, dtype=np.int64)
    if isinstance(rows, list):
        return rows_from_ints([rows[i] for i in idx.reshape(-1).tolist()]).reshape(idx.shape + (NLIMBS,))
    if rows.ndim == 3:
        return rows[np.arange(len(rows)).reshape((-1,) + (1,) * (idx.ndim - 1)), idx]
    return rows[idx]


def gather_rows(rows, indices) -> List[int]:
    """Canonical ints at ``indices`` of a layer, as ``gather_limbs`` reads
    it (the port of stark_anatomy_tpu/commit/device_merkle.py:
    gather_rows)."""
    return ints_from_rows(gather_limbs(rows, list(indices)))
