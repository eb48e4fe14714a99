"""The NTT: one radix-2 transform, one launch of H3 on the card.

The port of stark_anatomy_tpu/ops/ntt.py and ops/stage_ntt.py.  The JAX
package keeps two lowerings (a scan over radix-2 stages and a staged
four-step transform) that are bit-exact with each other
(ops/stage_ntt.py:24-25), so only the output values matter: here one
iterative radix-2 Cooley-Tukey transform serves every size, with the
optional pre-scale (a coset table, for an LDE), post-scale (an inverse
coset table, for interpolation) and 1/n folded into the inverse.

:func:`ntt` hands the domain's tables to the H3 wrapper
(field/kernels.py:ntt): on a CUDA tensor one launch runs the whole
transform in one thread block per row (n <= 8192), on a CPU tensor its
plain version ``kernels.ntt_plain`` runs the stages in PyTorch.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..field import kernels as K
from ..field import ops as F
from .domain import DOMAINS, coset_table

# crossover below which zerofiers are built with host big-int
# accumulation (stark_anatomy_tpu/ops/ntt.py:HOST_ZEROFIER_MAX)
HOST_ZEROFIER_MAX = 2048


def ntt(
    values: torch.Tensor,
    inverse: bool = False,
    scale_pre: Optional[torch.Tensor] = None,
    scale_post: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Forward NTT: coefficients -> evaluations on <omega_n>, natural order.

    With ``inverse=True``: evaluations -> coefficients, including the 1/n
    scaling.  ``scale_pre`` multiplies the input, ``scale_post`` the output
    (both (NLIMBS, n) tables or broadcastable).  Batched over leading axes.
    """
    n = values.shape[-1]
    assert n >= 1 and n & (n - 1) == 0, "NTT length must be a power of two"
    dom = DOMAINS.get(n, values.device)
    powers = dom["inv_powers"] if inverse else dom["fwd_powers"]
    n_inv = dom["n_inv"] if inverse and n > 1 else None
    if values.device.type != "cpu":
        values = values.to(torch.int32).contiguous()
    return K.ntt(values, powers, n_inv, scale_pre, scale_post)


def intt(values: torch.Tensor) -> torch.Tensor:
    return ntt(values, inverse=True)


def _pad_coeffs(coeffs: torch.Tensor, order: int) -> torch.Tensor:
    n = coeffs.shape[-1]
    assert n <= order, f"cannot fit {n} coefficients in NTT of size {order}"
    if n == order:
        return coeffs
    return torch.nn.functional.pad(coeffs, (0, order - n))


def coset_evaluate(coeffs: torch.Tensor, offset: int, order: int) -> torch.Tensor:
    """Low-degree extension: evaluate on the coset offset * <omega_order>
    (scale by offset^i, then a length-``order`` NTT)."""
    padded = _pad_coeffs(coeffs, order)
    return ntt(padded, scale_pre=coset_table(offset, order, coeffs.device))


def coset_interpolate(values: torch.Tensor, offset: int) -> torch.Tensor:
    """Inverse of coset_evaluate at the same order."""
    n = values.shape[-1]
    inv_tab = coset_table(offset, n, values.device, inverse=True)
    return ntt(values, inverse=True, scale_post=inv_tab)


def evaluate_domain_horner(coeffs: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Evaluate polynomials at arbitrary points (Horner over coefficients).

    coeffs (..., NLIMBS, K), points (..., NLIMBS, n) -> (..., NLIMBS, n).
    """
    cols = coeffs.movedim(-1, 0).contiguous()              # (K, ..., NLIMBS)
    acc = torch.zeros_like(points)
    for k in range(cols.shape[0] - 1, -1, -1):
        acc = F.add(F.mont_mul(acc, points), cols[k].unsqueeze(-1))
    return acc
