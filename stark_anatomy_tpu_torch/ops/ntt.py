"""The NTT: one launch of H3 up to NTT_MAX points, two of H8 above.  The
port of stark_anatomy_tpu/ops/ntt.py and ops/stage_ntt.py.

The JAX package keeps two lowerings (a scan over radix-2 stages and a
staged four-step transform) that are bit-exact with each other
(ops/stage_ntt.py:24-25), so only the output values matter.  Here
:func:`ntt` hands a transform of n <= NTT_MAX points to the H3 wrapper
(field/kernels.py:ntt): on a CUDA tensor one launch runs the whole batch
(a cluster of blocks per row for a small batch, a persistent grid over
the rows for a large one), on a CPU tensor its plain version
``kernels.ntt_plain`` runs the stages in PyTorch.  The optional pre-scale
(a coset table, for an LDE), post-scale (an inverse coset table, for
interpolation) and 1/n of the inverse ride in that launch.

Above NTT_MAX, n = n1 * n2 with n1, n2 <= NTT_MAX (up to 2^24 points,
``_tiled``), H8 (field/kernels.py:ntt_tiled) runs the four-step transform
in two launches over the whole batch, input index j = j1 + n1 j2 and
output index k = k2 + n2 k1: the n1 strided columns' n2-point transforms
with the pre-scale and the twiddles omega_n^(j1 k2), then the n2 rows'
n1-point transforms, written in natural order with 1/n and the
post-scale.  No transpose, no separate scale launch; the twiddles come
from the n1-point domain table and a table of omega_n's first n2 powers.

Transforms H8 does not take (above 2^24 points, which no path runs; or,
where a test lowers NTT_MAX, n2 above it or n1 under TILED_MIN) run
``_four_step``: a transpose to rows j1 of length n2,
their transforms (``ntt`` again: H8 or H3) with the twiddles as their
post-scale, a transpose to rows k2, their transforms, a transpose back;
the (n1, NLIMBS, n2) twiddle table is cached per (n, direction, device).

``prefix_zerofier_evals`` evaluates a prefix zerofier on a geometric
domain by rolls and products (the JAX package's rolling kernel).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..field import kernels as K
from ..field import ops as F
from ..field.limbs import NLIMBS
from ..field.scalar import P
from .domain import DOMAINS, coset_table, mont_const

# crossover below which zerofiers are built with host big-int
# accumulation (stark_anatomy_tpu/ops/ntt.py:HOST_ZEROFIER_MAX)
HOST_ZEROFIER_MAX = 2048

# transforms above this many points run four-step (H8); the tests lower it
# to run the four-step path at small sizes
NTT_MAX = K.NTT_MAX

_TWIDDLES: Dict[tuple, torch.Tensor] = {}


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
    if values.device.type != "cpu":
        values = values.to(torch.int32).contiguous()
    if n > NTT_MAX:
        n1, n2 = K.tiled_split(n)
        if n1 >= K.TILED_MIN and n2 <= min(NTT_MAX, K.TILED_MAX):
            return _tiled(values, inverse, scale_pre, scale_post)
        return _four_step(values, inverse, scale_pre, scale_post)
    dom = DOMAINS.get(n, values.device)
    powers = dom["inv_powers"] if inverse else dom["fwd_powers"]
    n_inv = dom["n_inv"] if inverse and n > 1 else None
    return K.ntt(values, powers, n_inv, scale_pre, scale_post)


def tiled_tables(n: int, inverse: bool, device):
    """(n1, step 0's power table, its twiddle tables, step 1's power table,
    1/n or None) of H8's transform of n points: the n2- and n1-point
    domain tables, and omega_n^(+-i) for i < n2 beside the n1-point one
    (omega_n^(j1 k2) = omega_n1^(e / n2) omega_n^(e mod n2))."""
    n1, n2 = K.tiled_split(n)
    key = "inv_powers" if inverse else "fwd_powers"
    outer = DOMAINS.get(n1, device)[key]
    fine = coset_table(DOMAINS.get(n, device).omega, n2, device, inverse)
    n_inv = DOMAINS.get(n, device)["n_inv"] if inverse else None
    return n1, DOMAINS.get(n2, device)[key], (outer, fine), outer, n_inv


def _tiled(values, inverse, scale_pre, scale_post) -> torch.Tensor:
    """The transform of ``ntt`` for n = n1 n2 > NTT_MAX by H8's two steps
    (module docstring)."""
    values = values.to(torch.int32).contiguous()        # the plain version takes H8's layout too
    n1, inner, twiddles, outer, n_inv = tiled_tables(values.shape[-1], inverse, values.device)
    y = K.ntt_tiled(values, 0, n1, inner, twiddles, scale=scale_pre)
    return K.ntt_tiled(y, 1, n1, outer, n_inv=n_inv, scale=scale_post)


def _twiddles(n: int, n1: int, inverse: bool, device) -> torch.Tensor:
    """(n1, NLIMBS, n2) table omega_n^(+-j1 k2), gathered from the forward
    power table (omega^-e = omega^(n - e)); cached per (n, n1, direction,
    device)."""
    key = (n, n1, inverse, torch.device(device))
    if key not in _TWIDDLES:
        n2 = n // n1
        e = torch.arange(n1, device=device).view(n1, 1) * torch.arange(n2, device=device)
        if inverse:
            e = (n - e) % n
        tab = DOMAINS.get(n, device)["fwd_powers"].index_select(-1, e.flatten())
        _TWIDDLES[key] = tab.view(NLIMBS, n1, n2).transpose(0, 1).contiguous()
    return _TWIDDLES[key]


def _four_step(values, inverse, scale_pre, scale_post) -> torch.Tensor:
    """The transform of ``ntt`` for n > NTT_MAX as n2-point and n1-point
    row transforms (module docstring); the leading axes one at a time."""
    n = values.shape[-1]
    lead = values.shape[:-2]
    if scale_pre is not None:
        values = F.mont_mul(values, scale_pre)
    rows = values.reshape(-1, NLIMBS, n)
    n1 = 1 << ((n.bit_length() - 1) // 2)          # n1 <= n2 = n / n1
    n2 = n // n1
    tw = _twiddles(n, n1, inverse, values.device)
    outs = []
    for x in rows:
        y = x.view(NLIMBS, n2, n1).permute(2, 0, 1).contiguous()       # [j1][l][j2]
        y = ntt(y, inverse, scale_post=tw)                               # [j1][l][k2]
        z = ntt(y.permute(2, 1, 0).contiguous(), inverse)                # [k2][l][k1]
        outs.append(z.permute(1, 2, 0).reshape(NLIMBS, n))               # [l][k1 n2 + k2]
    out = torch.stack(outs).view(lead + (NLIMBS, n))
    if scale_post is not None:
        out = F.mont_mul(out, scale_post)
    return out


def intt(values: torch.Tensor) -> torch.Tensor:
    return ntt(values, inverse=True)


def _pad_coeffs(coeffs: torch.Tensor, order: int) -> torch.Tensor:
    n = coeffs.shape[-1]
    assert n <= order, f"cannot fit {n} coefficients in NTT of size {order}"
    if n == order:
        return coeffs
    return torch.nn.functional.pad(coeffs, (0, order - n))


def coset_scale(coeffs: torch.Tensor, offset: int, inverse: bool = False) -> torch.Tensor:
    """Substitute x -> offset * x (coefficient i scaled by offset^i), or
    x -> x / offset with ``inverse``."""
    return F.mont_mul(coeffs, coset_table(offset, coeffs.shape[-1], coeffs.device, inverse))


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


def poly_multiply(lhs: torch.Tensor, rhs: torch.Tensor, out_len: Optional[int] = None) -> torch.Tensor:
    """Polynomial product by NTT, Hadamard product and inverse NTT.

    lhs and rhs are coefficient tensors (..., NLIMBS, n); the result has
    ``out_len`` coefficients (default: both lengths added, less one).  The
    analog of the reference's fast_multiply (ntt.py:32-64)."""
    la, lb = lhs.shape[-1], rhs.shape[-1]
    if out_len is None:
        out_len = la + lb - 1
    order = 1
    while order < la + lb - 1:
        order *= 2
    prod = intt(F.mont_mul(ntt(_pad_coeffs(lhs, order)), ntt(_pad_coeffs(rhs, order))))
    return prod[..., :out_len]


def coset_divide(lhs: torch.Tensor, rhs: torch.Tensor, offset: int, order: int,
                 out_len: Optional[int] = None) -> torch.Tensor:
    """Exact polynomial division by the Hadamard quotient on a coset (the
    reference's fast_coset_divide, ntt.py:137-176): the coset avoids the
    divisor's roots in <omega>.  A division with a remainder gives
    garbage coefficients, as in the reference."""
    dev = lhs.device
    lc = ntt(_pad_coeffs(lhs, order), scale_pre=coset_table(offset, order, dev))
    rc = ntt(_pad_coeffs(rhs, order), scale_pre=coset_table(offset, order, dev))
    q = F.mont_mul(lc, F.batch_inv(rc))
    coeffs = ntt(q, inverse=True, scale_post=coset_table(offset, order, dev, inverse=True))
    return coeffs if out_len is None else coeffs[..., :out_len]


def zerofier(points: torch.Tensor) -> torch.Tensor:
    """Monic vanishing polynomial of a set of points by a product tree.

    points: (NLIMBS, n) Montgomery form; returns (NLIMBS, n + 1)
    coefficients.  Each level of the tree is one batched NTT product over
    all sibling pairs (the analog of the reference's fast_zerofier,
    ntt.py:66-80); n that is not a power of two is split into power-of-two
    chunks whose zerofiers are multiplied."""
    n = points.shape[-1]
    assert n >= 1
    acc = None
    start = 0
    while start < n:
        size = 1 << ((n - start).bit_length() - 1)
        chunk = _zerofier_pow2(points[:, start:start + size])
        acc = chunk if acc is None else poly_multiply(acc, chunk)
        start += size
    return acc


def _zerofier_pow2(points: torch.Tensor) -> torch.Tensor:
    """Zerofier of 2^k points by a balanced product tree."""
    n = points.shape[-1]
    neg = F.neg(points).movedim(-1, 0).unsqueeze(-1)                      # (n, NLIMBS, 1)
    ones = F.mont_one(1, (n,), points.device)
    polys = torch.cat([neg, ones], dim=-1)                               # (n, NLIMBS, 2)
    while polys.shape[0] > 1:
        d = polys.shape[-1] - 1                                           # monic, degree d
        polys = poly_multiply(polys[0::2], polys[1::2], out_len=2 * d + 1)
    return polys[0]


def prefix_zerofier(root: int, count: int, device=None) -> torch.Tensor:
    """Coefficients of the zerofier of the first ``count`` powers of
    ``root``, prod_{i<count}(x - root^i): (NLIMBS, count + 1), Montgomery,
    monic, on ``device`` (the card unless the caller passes "cpu").  Up to
    HOST_ZEROFIER_MAX points by host big-int accumulation; above, split by
    index parity, Z_c(x) = Z_even(x) * root^lo * Z_odd(x / root), the
    even and odd indices being the first ceil(c/2) and floor(c/2) powers
    of root^2: one product a level (stark_anatomy_tpu/ops/ntt.py:
    prefix_zerofier)."""
    from ..config import resolve_device
    from ..poly.host_ntt import host_zerofier
    from ..utils.convert import device_from_ints
    from .domain import power_table

    device = resolve_device(device)
    if count <= HOST_ZEROFIER_MAX:
        pts, acc = [], 1
        for _ in range(count):
            pts.append(acc)
            acc = acc * root % P
        return device_from_ints(host_zerofier(pts), device)
    hi, lo = (count + 1) // 2, count // 2
    root2 = root * root % P
    even = prefix_zerofier(root2, hi, device)
    odd = even if lo == hi else prefix_zerofier(root2, lo, device)
    # prod_{t<lo}(x - root (root^2)^t) = root^lo Z_lo(x / root): coefficient
    # i picks up root^(lo - i)
    scale = F.mont_mul(power_table(pow(root, P - 2, P), lo + 1, device), mont_const(pow(root, lo, P), device))
    return poly_multiply(even, F.mont_mul(odd, scale), out_len=count + 1)


def evaluate_domain_horner(coeffs: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Evaluate polynomials at arbitrary points (Horner over coefficients).

    coeffs (..., NLIMBS, K), points (..., NLIMBS, n) -> (..., NLIMBS, n).
    """
    cols = coeffs.movedim(-1, 0).contiguous()              # (K, ..., NLIMBS)
    acc = torch.zeros_like(points)
    for k in range(cols.shape[0] - 1, -1, -1):
        acc = F.add(F.mont_mul(acc, points), cols[k].unsqueeze(-1))
    return acc


def prefix_zerofier_evals(y_tab: torch.Tensor, root: int, unit: int, count: int) -> torch.Tensor:
    """Evaluations of Z(x) = prod_{i<count}(x - root^i) at every point of
    ``y_tab`` (..., NLIMBS, D), a geometric domain in natural order,
    y_j = offset * omega_D^j with root = omega_D^unit, without forming Z's
    coefficients (the port of stark_anatomy_tpu/ops/ntt.py:
    prefix_zerofier_evals).

    Multiplying a point by root^-s rolls the table by unit*s places, so
    with F_k(y) = prod_{i<2^k}(y - root^i) the doubling

        F_{k+1}(y) = F_k(y) * root^(4^k) * F_k(y * root^(-2^k)),  F_0 = y - 1

    is one product with a rolled copy, and ``count`` is assembled from its
    binary digits: for each set bit k the running product takes
    F_k(y * root^(-s)) * root^(s 2^k), s the digits of count above k.
    About 2 log2(count) rolls and 4 log2(count) products over the domain.
    """
    assert count >= 1
    D = y_tab.shape[-1]
    assert count * unit <= D, "zerofier roots must fit in the domain"
    dev = y_tab.device
    fk = F.sub(y_tab, F.mont_one(1, (), dev))
    acc = None
    for k in range(count.bit_length()):
        if (count >> k) & 1:
            s_above = count & ~((1 << (k + 1)) - 1)
            shift = (unit * s_above) % D
            term = F.mont_mul(torch.roll(fk, shift, dims=-1), mont_const(pow(root, s_above << k, P), dev))
            acc = term if acc is None else F.mont_mul(acc, term)
        if k + 1 < count.bit_length():
            c_dbl = mont_const(pow(root, 1 << (2 * k), P), dev)
            fk = F.mont_mul(fk, F.mont_mul(torch.roll(fk, (unit << k) % D, dims=-1), c_dbl))
    return acc
