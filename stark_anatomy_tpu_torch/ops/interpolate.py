"""Generic-domain interpolation and evaluation: the port of
stark_anatomy_tpu/ops/interpolate.py.

The protocols interpolate only over (prefixes of) smooth domains, by NTTs
(protocols/fast_stark.py).  These functions cover the reference's
generic fast_evaluate / fast_interpolate (ntt.py:82-130) for arbitrary
distinct points; nothing on a prover's path calls them.

Interpolation is Lagrange by synthetic division: with Z = zerofier(points)
and w_i = v_i / Z'(x_i), the interpolant is f = sum_i w_i * Z/(x - x_i).
All n synthetic divisions run together over the points axis, one
coefficient a step: the JAX package's lax.scan (K17) becomes a loop of
n - 1 steps, each one H0 and one H1 launch over the n points, and the sum
over the points a tree of log2(n) H1 launches.  Glue over the field
kernels; a one-thread-per-point kernel for the divisions is later work.

Tensors are limb-first (NLIMBS, n), Montgomery form (field/ops.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import ops as F
from ..field.limbs import NLIMBS
from .ntt import evaluate_domain_horner, zerofier


def _synthetic_divide_all(z_coeffs: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Quotients Z/(x - x_i) for every i at once.

    z_coeffs: (NLIMBS, n + 1) monic; points: (NLIMBS, n).  Returns
    (n, NLIMBS, n): ascending coefficient index on axis 0, the points on
    the last.  Synthetic division from the top coefficient down:
    q_{n-1} = z_n;  q_{k-1} = z_k + x_i * q_k."""
    n = points.shape[-1]
    q = z_coeffs[:, n:n + 1].expand(points.shape)                  # q_{n-1}
    qs = [q]
    for k in range(n - 1, 0, -1):
        q = F.add(z_coeffs[:, k:k + 1], F.mont_mul(points, q))
        qs.append(q)
    return torch.stack(qs[::-1])


def _tree_sum_last(terms: torch.Tensor) -> torch.Tensor:
    """Modular sum over the last axis by halving (log-depth adds)."""
    while terms.shape[-1] > 1:
        k = terms.shape[-1]
        if k % 2 == 1:
            terms = torch.cat([terms, torch.zeros_like(terms[..., :1])], dim=-1)
            k += 1
        terms = F.add(terms[..., : k // 2], terms[..., k // 2:])
    return terms[..., 0]


def _derivative(coeffs: torch.Tensor) -> torch.Tensor:
    """d/dx of a coefficient tensor: (k + 1) * c_{k+1}."""
    n = coeffs.shape[-1] - 1
    kplus1 = np.arange(1, n + 1, dtype=np.int64)
    k_limbs = np.zeros((NLIMBS, n), dtype=np.int32)
    k_limbs[0] = kplus1 & 0xFFFF
    k_limbs[1] = kplus1 >> 16
    k_mont = F.to_mont(torch.from_numpy(k_limbs).to(coeffs.device))
    return F.mont_mul(coeffs[..., 1:], k_mont)


def interpolate_generic(points: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Coefficients of the unique polynomial of degree < n through
    (points[i], values[i]).  Both (NLIMBS, n) Montgomery tensors; returns
    (NLIMBS, n).  The analog of fast_interpolate (ntt.py:102-130)."""
    n = points.shape[-1]
    if n == 1:
        return values
    z = zerofier(points)                                           # (NLIMBS, n + 1)
    dz_at = evaluate_domain_horner(_derivative(z), points)
    w = F.mont_mul(values, F.batch_inv(dz_at))                     # (NLIMBS, n)
    qs = _synthetic_divide_all(z, points)                          # (n, NLIMBS, n)
    coeffs = _tree_sum_last(F.mont_mul(w.unsqueeze(0), qs))        # (n, NLIMBS)
    return coeffs.movedim(0, -1).contiguous()                      # (NLIMBS, n)


def evaluate_generic(coeffs: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Multi-point evaluation at arbitrary points (reference: fast_evaluate,
    ntt.py:82-100)."""
    return evaluate_domain_horner(coeffs, points)
