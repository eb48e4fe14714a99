"""Each opened value of a signature given once: ``stark.verify`` reads an
opened section into a map from position to value, so where one position
is opened twice (a query's index i is another query's next point
i + E) it holds only the last copy to the commitment and never reads the
other.  The prover writes one value twice over; a signature whose two
copies differ is not a transcript that the scheme's prover makes, and a
byte of the copy that goes unread would change without the verifier
seeing it.  ``judge_signature`` here is rescue_prime.judge_signature
that rejects such a signature too."""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

from . import rescue_prime as RP
from .stark import verify_fri
from .transcript import Transcript


def copies_differ(config: dict, document: bytes, signature: bytes) -> Optional[str]:
    """Where two copies of an opened value differ in a signature that
    ``rescue_prime.verify_signature`` accepts, which; None where none
    do."""
    p = RP.params(config)
    ts = Transcript(signature, hashlib.blake2s(bytes(document)).digest())
    for _ in range(p.num_registers + 1):                  # the R + 1 committed roots
        ts.pull(bytes)
    indices = sorted(i for i, _ in verify_fri(p, ts))
    n = p.fri_length
    positions = sorted(indices + [(i + p.expansion_factor) % n for i in indices])
    for section in range(p.num_registers + 2):
        values, _ = ts.pull(list), ts.pull(list)
        seen = {}
        for i, v in zip(positions, values):
            if seen.setdefault(i, v) != v:
                return f"opened section {section}: two copies of position {i} differ"
    return None


def judge_signature(config: dict, label: str, sk: int, pk: int, document: bytes,
                    signature: bytes) -> Tuple[bool, Optional[str], Optional[bytes]]:
    """rescue_prime.judge_signature, with a signature whose copies of one
    opened value differ rejected."""
    wrong, reason, root = RP.judge_signature(config, label, sk, pk, document, signature)
    if reason is None:
        differ = copies_differ(config, document, signature)
        if differ is not None:
            return wrong, f"{label}: {differ}", None
    return wrong, reason, root
