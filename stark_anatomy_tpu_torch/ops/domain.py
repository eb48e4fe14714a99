"""Evaluation-domain tables: root-of-unity powers and coset powers.  The
port of stark_anatomy_tpu/ops/domain.py.

Power tables are built on the tensor's device by doubling,
powers[2^k + i] = powers[2^k] * powers[i]: log2(n) Montgomery multiplies
instead of n host big-int products.  Tables are cached per (size, device)
in the limb layout (NLIMBS, n).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from ..field import ops as F
from ..field.scalar import Field, P

mont_const = F.mont_const


def power_table(base: int, n: int, device) -> torch.Tensor:
    """[base^0, ..., base^(n-1)]: (NLIMBS, n), Montgomery form."""
    assert n >= 1
    table = F.mont_one(1, (), device).contiguous()
    step = mont_const(base, device)
    while table.shape[-1] < n:
        table = torch.cat([table, F.mont_mul(table, step)], dim=-1)
        step = F.mont_mul(step, step)                  # base^(2*size)
    return table[..., :n].contiguous()


class _Domain:
    """Lazy per-(size, device) tables: ``fwd_powers`` and ``inv_powers``
    (omega_n^{+-i}) and ``n_inv`` (1/n as a constant)."""

    def __init__(self, n: int, device: torch.device):
        self.n = n
        self.device = device
        omega = Field.main().primitive_nth_root(n).value
        self.omega = omega
        self.omega_inv = pow(omega, P - 2, P)
        self._vals: dict = {}

    def __getitem__(self, key: str):
        if key not in self._vals:
            n, dev = self.n, self.device
            if key == "fwd_powers":
                v = power_table(self.omega, n, dev)
            elif key == "inv_powers":
                v = power_table(self.omega_inv, n, dev)
            elif key == "n_inv":
                v = mont_const(pow(n, P - 2, P), dev)
            else:
                raise KeyError(key)
            self._vals[key] = v
        return self._vals[key]


class DomainCache:
    """Per-process cache of NTT domain tables keyed by (size, device)."""

    def __init__(self):
        self._cache: Dict[Tuple[int, torch.device], _Domain] = {}

    def get(self, n: int, device) -> _Domain:
        key = (n, torch.device(device))
        if key not in self._cache:
            self._cache[key] = _Domain(n, key[1])
        return self._cache[key]


DOMAINS = DomainCache()


@functools.lru_cache(maxsize=128)
def coset_table(offset: int, n: int, device, inverse: bool = False) -> torch.Tensor:
    """Table offset^{+-i} (NLIMBS, n), Montgomery form."""
    base = pow(offset, P - 2, P) if inverse else offset
    return power_table(base, n, device)


def coset_power_tables(offset: int, n: int, device):
    """(offset^i, offset^-i) tables (NLIMBS, n), Montgomery form."""
    return coset_table(offset, n, device, False), coset_table(offset, n, device, True)


def bit_reversal_permutation(n: int) -> np.ndarray:
    """Index array mapping natural order to bit-reversed order (uint32)."""
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev
