"""Field arithmetic over limb tensors: the port of stark_anatomy_tpu/field/ops.py.

LAYOUT: every field tensor is int32 of shape (..., NLIMBS, n), 16-bit
limbs on the second-to-last axis, Montgomery form (x*2^128 mod p).

``mont_mul``, ``mont_pow``, ``add`` and ``sub`` go to the hand-written
kernels (field/kernels.py): on a CUDA tensor they launch H0 and H1, on a
CPU tensor the kernels' plain versions run.  Everything else here is
PyTorch glue over those four.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import kernels as K
from .limbs import NLIMBS, ONE_MONT_LIMBS, R, int_to_limbs
from .scalar import P

_CONSTS: Dict[tuple, torch.Tensor] = {}


def limb_const(limbs, device) -> torch.Tensor:
    """(NLIMBS, 1) int32 tensor of the given limbs, cached per device."""
    device = torch.device(device)
    key = (tuple(int(v) for v in limbs), device)
    if key not in _CONSTS:
        _CONSTS[key] = torch.tensor(key[0], dtype=torch.int32, device=device).view(NLIMBS, 1)
    return _CONSTS[key]


def mont_const(value: int, device) -> torch.Tensor:
    """Host int -> (NLIMBS, 1) Montgomery-form broadcastable constant."""
    return limb_const(int_to_limbs(value % P * R % P), device)


def _fit(a: torch.Tensor, b: torch.Tensor):
    """(a, b, layout): the operands in a form the kernels take, with the
    kernels' layout of them, worked out once for the call.  A CUDA operand
    that neither matches the output shape nor broadcasts a whole axis is
    expanded and made contiguous here.  CPU operands go to the plain
    versions as they are, with no layout."""
    if a.device.type == "cpu":
        return a, b, None
    shape, sa, sb = K.binary_layout(a, b)
    lead, n = tuple(shape[:-2]), shape[-1]
    if sa is None:
        a = a.to(torch.int32).expand(shape).contiguous()
        sa = K.operand_strides(a, lead, n)
    if sb is None:
        b = b.to(torch.int32).expand(shape).contiguous()
        sb = K.operand_strides(b, lead, n)
    return a, b, (shape, sa, sb)


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^{-1} mod p."""
    return K.mont_mul(*_fit(a, b))


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field addition (encoding-agnostic: works in Montgomery form too)."""
    return K.add_mod(*_fit(a, b))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field subtraction."""
    return K.sub_mod(*_fit(a, b))


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(torch.zeros_like(a), a)


def field_sum(terms: torch.Tensor) -> torch.Tensor:
    """Modular sum over the LEADING axis, as a pairwise tree of adds (field
    addition is exact, so the order does not change the value)."""
    while terms.shape[0] > 1:
        half = terms.shape[0] // 2
        summed = add(terms[:half], terms[half : 2 * half])
        if terms.shape[0] % 2:
            summed = torch.cat([summed, terms[2 * half :]])
        terms = summed
    return terms[0]


def weighted_sum(terms: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """sum_k weights[k] * terms[k] over the leading axis (Montgomery)."""
    return field_sum(mont_mul(terms, weights))


def mont_one(n: int = 1, batch=(), device="cpu") -> torch.Tensor:
    """Montgomery-form ones of shape (*batch, NLIMBS, n)."""
    return limb_const(ONE_MONT_LIMBS, device).expand(tuple(batch) + (NLIMBS, n))


def mont_zero(n: int = 1, batch=(), device="cpu") -> torch.Tensor:
    return torch.zeros(tuple(batch) + (NLIMBS, n), dtype=torch.int32, device=device)


def to_mont(a: torch.Tensor) -> torch.Tensor:
    """Canonical limbs -> Montgomery form (multiply by R^2, reduce)."""
    return mont_mul(a, limb_const(int_to_limbs(R * R % P), a.device))


def from_mont(a: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> canonical limbs (multiply by 1, reduce)."""
    return mont_mul(a, limb_const(int_to_limbs(1), a.device))


def mont_pow(x: torch.Tensor, exponent: int) -> torch.Tensor:
    """x^exponent for a host integer exponent in [0, 2^128): one launch of
    the H0 ladder, which squares and multiplies from the top bit down (the
    value is the JAX scan's: both compute x^e exactly)."""
    if exponent == 0:
        return mont_one(x.shape[-1], x.shape[:-2], x.device).clone()
    if x.device.type != "cpu":
        x = x.to(torch.int32).contiguous()
    return K.mont_pow(x, exponent)


def inv(x: torch.Tensor) -> torch.Tensor:
    """Batched field inversion by Fermat: x^(p-2).  0 maps to 0."""
    return mont_pow(x, P - 2)


def batch_inv(x: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse over the last axis by Montgomery's trick, as a
    product tree: log2(n) levels of pairwise products up, ONE Fermat
    inversion of the (..., NLIMBS, 1) roots, log2(n) levels back down.
    Zeros map to zero, as in Fermat (stark_anatomy_tpu/field/ops.py:
    batch_inv): they are masked to one for the products and zeroed at the
    end."""
    n = x.shape[-1]
    if n == 0:
        return x.clone()
    zero = is_zero(x).unsqueeze(-2)                                # (..., 1, n)
    one = mont_one(1, (), x.device)
    level = torch.where(zero, one, x).contiguous()
    levels = []
    while level.shape[-1] > 1:
        if level.shape[-1] % 2:
            level = torch.cat([level, one.expand(level.shape[:-1] + (1,))], dim=-1)
        levels.append(level)
        level = mont_mul(level[..., 0::2].contiguous(), level[..., 1::2].contiguous())
    inv_level = inv(level)
    for below in reversed(levels):
        # drop the inverse of a padding one, if the level above had one
        inv_level = inv_level[..., : below.shape[-1] // 2]
        left = below[..., 0::2].contiguous()
        right = below[..., 1::2].contiguous()
        # 1/left = inv(parent) * right,  1/right = inv(parent) * left
        pair = torch.stack([mont_mul(inv_level, right), mont_mul(inv_level, left)], dim=-1)
        inv_level = pair.flatten(-2)
    out = inv_level[..., :n]
    return torch.where(zero, torch.zeros_like(out), out)


def mul_by_int(a: torch.Tensor, c: int) -> torch.Tensor:
    """Multiply Montgomery-form a by a canonical integer constant c."""
    return mont_mul(a, mont_const(c, a.device))


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise field equality -> bool tensor with the limb axis reduced."""
    return (a == b).all(dim=-2)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=-2)
