"""The ops namespace, with the reference's names beside the port's
(the port of stark_anatomy_tpu/ops/__init__.py).

A user of the reference's ntt.py module (fast_multiply, fast_zerofier,
fast_evaluate, fast_interpolate, fast_coset_evaluate, fast_coset_divide:
ntt.py:32-176) finds the same functions here.  All take Montgomery limb
tensors (field/limbs.py) and are batched over leading axes.
"""

from .ntt import (
    coset_divide,
    coset_evaluate,
    coset_interpolate,
    evaluate_domain_horner,
    intt,
    poly_multiply,
    zerofier,
)
from .ntt import ntt as ntt_fn
from .interpolate import evaluate_generic, interpolate_generic

# reference-style names (reference: ntt.py)
fast_multiply = poly_multiply
fast_zerofier = zerofier
fast_evaluate = evaluate_generic
fast_interpolate = interpolate_generic
fast_coset_evaluate = coset_evaluate
fast_coset_divide = coset_divide

# keep ``stark_anatomy_tpu_torch.ops.ntt`` the MODULE (the protocols import
# it); the forward transform is ``ntt_fn``
from . import ntt  # noqa: E402

__all__ = [
    "ntt",
    "ntt_fn",
    "intt",
    "poly_multiply",
    "zerofier",
    "coset_evaluate",
    "coset_interpolate",
    "coset_divide",
    "evaluate_domain_horner",
    "evaluate_generic",
    "interpolate_generic",
    "fast_multiply",
    "fast_zerofier",
    "fast_evaluate",
    "fast_interpolate",
    "fast_coset_evaluate",
    "fast_coset_divide",
]
