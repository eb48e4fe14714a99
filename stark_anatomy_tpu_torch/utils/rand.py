"""Bulk randomness for large-trace provers, expanded on the card from a seed.

The port of stark_anatomy_tpu/utils/rand.py, bit for bit.  Only a 32-byte
``urandom`` seed is drawn on the host; the card expands it with blake2s-256
in counter mode (H5, commit/kernels.py:seed_expand, which shares H4's
compression) and rejection-samples to exact uniformity: each digest yields
two 128-bit candidates, and a candidate >= p is redrawn with the next
round tag (P[candidate >= p] is about 0.205).

The output is exactly uniform on [0, p) given termination; its source is a
PRF expansion of a 256-bit seed rather than raw urandom per element, as in
the JAX package (DEVIATIONS.md: blinding randomness, not consensus bytes).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..commit.kernels import seed_expand


def seed_expand_mont(count: int, seed: bytes, device) -> torch.Tensor:
    """``count`` exactly-uniform field elements as a Montgomery limb tensor
    (NLIMBS, count) on ``device``, expanded there from a 32-byte seed."""
    if len(seed) != 32:
        raise ValueError(f"seed_expand_mont: the seed must be 32 bytes, got {len(seed)}")
    words = np.frombuffer(seed, dtype="<u4").view(np.int32).copy()
    return seed_expand(torch.from_numpy(words).to(device), count)


def bulk_random_mont(count: int, device, urandom=os.urandom) -> torch.Tensor:
    """``count`` exactly-uniform field elements (NLIMBS, count), Montgomery
    form, on ``device``: one 32-byte entropy draw, expanded there."""
    return seed_expand_mont(count, urandom(32), device)
