"""Structured verification errors.

The reference's verifiers return bare bools and `print` their reasons
(fri.py:148,171-173,209), and can crash on malformed input (asserts in
fri.py:252, pickle in ip.py:27-30).  Here every rejection path raises a
:class:`VerificationError` with a machine-readable reason; the public
``verify`` entry points catch it (via :func:`rejects_malformed`), record
the reason on ``self.last_rejection``, and return False.  Arbitrary bytes
fed to a verifier must never escape as an uncaught exception.
"""

from __future__ import annotations

import functools
import struct


class VerificationError(Exception):
    """A proof failed verification for a structured ``reason``."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class MalformedProof(VerificationError):
    """The proof bytes do not parse into a well-formed transcript."""


def rejects_malformed(verify_fn):
    """Wrap a ``verify``-style method: catch VerificationError AND any
    decode-level exception reachable from attacker-controlled bytes,
    record the reason on ``self.last_rejection``, and return False."""

    @functools.wraps(verify_fn)
    def wrapper(self, *args, **kwargs):
        self.last_rejection = None
        try:
            return verify_fn(self, *args, **kwargs)
        except VerificationError as e:
            self.last_rejection = e.reason
            return False
        except (
            AssertionError,
            IndexError,
            KeyError,
            OverflowError,
            TypeError,
            ValueError,
            ZeroDivisionError,
            struct.error,
        ) as e:
            self.last_rejection = f"malformed proof: {type(e).__name__}: {e}"
            return False

    return wrapper
