"""The NTT: one radix-2 transform over the field kernels.

The port of stark_anatomy_tpu/ops/ntt.py and ops/stage_ntt.py.  The JAX
package keeps two lowerings (a scan over radix-2 stages and a staged
four-step transform) that are bit-exact with each other
(ops/stage_ntt.py:24-25), so only the output values matter: here one
iterative radix-2 Cooley-Tukey transform serves every size, with the
optional pre-scale (a coset table, for an LDE), post-scale (an inverse
coset table, for interpolation) and 1/n folded into the inverse.

Each stage is PyTorch index glue around the kernels: the even and odd
halves of every butterfly block are gathered into contiguous tensors,
t = v * w (H0), then u + t and u - t (H1), and the halves are
interleaved back.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from ..field import ops as F
from ..field.limbs import NLIMBS
from .domain import DOMAINS, coset_table

# crossover below which zerofiers are built with host big-int
# accumulation (stark_anatomy_tpu/ops/ntt.py:HOST_ZEROFIER_MAX)
HOST_ZEROFIER_MAX = 2048

_TWIDDLES: Dict[Tuple[int, bool, torch.device], List[torch.Tensor]] = {}


def _stage_twiddles(n: int, inverse: bool, device: torch.device) -> List[torch.Tensor]:
    """Per stage (half-block m = 1, 2, ..., n/2) the (NLIMBS, n/2) table of
    w^(j * n/(2m)) for position j of every block, tiled over the blocks."""
    key = (n, inverse, device)
    if key not in _TWIDDLES:
        dom = DOMAINS.get(n, device)
        powers = dom["inv_powers"] if inverse else dom["fwd_powers"]
        tabs = []
        m = 1
        j = torch.arange(n // 2, device=device)
        while m < n:
            idx = (j % m) * (n // (2 * m))
            tabs.append(powers.index_select(-1, idx).contiguous())
            m *= 2
        _TWIDDLES[key] = tabs
    return _TWIDDLES[key]


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
    assert n & (n - 1) == 0, "NTT length must be a power of two"
    device = values.device
    x = values if scale_pre is None else F.mont_mul(values, scale_pre)
    if n > 1:
        dom = DOMAINS.get(n, device)
        lead = x.shape[:-2]
        batch = math.prod(lead)
        x = x.index_select(-1, dom["bitrev"]).reshape(batch, NLIMBS, n)
        m = 1
        for w in _stage_twiddles(n, inverse, device):
            blocks = n // (2 * m)
            x5 = x.view(batch, NLIMBS, blocks, 2, m)
            u = x5[:, :, :, 0, :].reshape(batch, NLIMBS, n // 2)
            v = x5[:, :, :, 1, :].reshape(batch, NLIMBS, n // 2)
            t = F.mont_mul(v, w)
            lo = F.add(u, t).view(batch, NLIMBS, blocks, 1, m)
            hi = F.sub(u, t).view(batch, NLIMBS, blocks, 1, m)
            x = torch.cat([lo, hi], dim=3).view(batch, NLIMBS, n)
            m *= 2
        x = x.reshape(lead + (NLIMBS, n))
        if inverse:
            x = F.mont_mul(x, dom["n_inv"])
    if scale_post is not None:
        x = F.mont_mul(x, scale_post)
    return x


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
