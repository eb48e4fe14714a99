"""Per-limb-row modular arithmetic in plain PyTorch.

The port of stark_anatomy_tpu/field/limb_arith.py.  These helpers work on
Python lists of NLIMBS equal-shape ``int64`` tensors ("rows") holding
16-bit limbs, least significant first.  They are the arithmetic of the
plain versions of the field kernels (field/kernels.py), which run when a
tensor lies on the CPU and are the yardstick the CUDA kernels are held
against on the card.

``int64`` rather than the storage type ``int32``: limb sums and the
two-limb borrow trick need a bit above 16, and on the CPU torch's uint32
lacks ``+``, ``>>`` and comparisons.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from .limbs import LIMB_BITS, MASK, NLIMBS, int_to_limbs
from .scalar import P

P_LIMBS = int_to_limbs(P)


def add_rows(ar: List[torch.Tensor], br: List[torch.Tensor]) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Raw limb addition; returns (limbs, carry-out)."""
    out, carry = [], None
    for k in range(NLIMBS):
        acc = ar[k] + br[k]
        if carry is not None:
            acc = acc + carry
        out.append(acc & MASK)
        carry = acc >> LIMB_BITS
    return out, carry


def sub_rows(ar: List[torch.Tensor], br: List) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Raw limb subtraction; returns (limbs, borrow-out: 1 if ar < br).
    ``br`` may hold Python ints (a constant such as p)."""
    out, borrow = [], None
    for k in range(NLIMBS):
        tmp = ar[k] + (1 << LIMB_BITS) - br[k]
        if borrow is not None:
            tmp = tmp - borrow
        out.append(tmp & MASK)
        borrow = 1 - (tmp >> LIMB_BITS)
    return out, borrow


def cond_sub_p_rows(r: List[torch.Tensor], overflow: torch.Tensor) -> List[torch.Tensor]:
    """Reduce r (< 2p, possibly with a 2^128 overflow bit) into [0, p)."""
    d, borrow = sub_rows(r, P_LIMBS)
    ge = (overflow != 0) | (borrow == 0)
    return [torch.where(ge, d[k], r[k]) for k in range(NLIMBS)]


def add_mod_rows(ar: List[torch.Tensor], br: List[torch.Tensor]) -> List[torch.Tensor]:
    """Modular addition of two values in [0, p)."""
    s, carry = add_rows(ar, br)
    return cond_sub_p_rows(s, carry)


def sub_mod_rows(ar: List[torch.Tensor], br: List[torch.Tensor]) -> List[torch.Tensor]:
    """Modular subtraction of two values in [0, p) (adds p back on
    underflow)."""
    d, borrow = sub_rows(ar, br)
    dp = []
    carry = None
    for k in range(NLIMBS):
        acc = d[k] + P_LIMBS[k]
        if carry is not None:
            acc = acc + carry
        dp.append(acc & MASK)
        carry = acc >> LIMB_BITS
    neg = borrow != 0
    return [torch.where(neg, dp[k], d[k]) for k in range(NLIMBS)]


def carry_rows(cols: List[torch.Tensor]) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Carry-propagate a list of (lazy) column sums; returns (16-bit limb
    rows, carry-out)."""
    limbs, carry = [], None
    for c in cols:
        acc = c if carry is None else c + carry
        limbs.append(acc & MASK)
        carry = acc >> LIMB_BITS
    return limbs, carry
