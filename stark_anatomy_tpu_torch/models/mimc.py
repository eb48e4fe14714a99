"""MiMC chain: the large-trace workload.  The port of
stark_anatomy_tpu/models/mimc.py.

The computation is the MiMC-style cubing chain

    x_{i+1} = x_i^3 + c          (c a fixed public field constant)

a verifiable-delay-function shape: sequential to compute, cheap to
constrain.  One register, one degree-3 transition constraint with constant
coefficients, and both endpoints are public boundary conditions, so the
STARK buys succinct verification of a long computation.  It exists to run
the prover at large traces (2^20 steps: an omicron domain of 2^22 and a
FRI domain of 2^24).

The chain runs on the host in N2 (csrc/mimc_chain.cpp, built at first use
by utils/build.py; a failed build raises, there is no device fallback),
is copied to the card once as packed (4, n) 32-bit words and unpacked
there into limbs.  ``chain_plain`` is N2's plain version, a Python-int
loop that the tests hold N2 against.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..field import ops as F
from ..field.limbs import R
from ..field.scalar import Field, FieldElement, P
from ..ops.domain import mont_const
from ..poly.multivariate import MPolynomial
from ..protocols.fast_stark import FastStark
from ..protocols.stark import Boundary
from ..utils.build import Job, build_all, host_compiler
from ..utils.profiling import device_sync

# the fixed public chain constant: sampled once from a nothing-up-my-sleeve
# string (the JAX package's value)
MIMC_C = Field.main().sample(b"stark-anatomy-tpu/mimc-chain-constant/v1").value

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "mimc_chain.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall")
_R_INV = pow(R, P - 2, P)
_MASK64 = (1 << 64) - 1

_lib = None


def load_chain() -> ctypes.CDLL:
    """Build N2 at first use (one host C++ compiler call into _build/) and
    load it; a failed build raises."""
    global _lib
    if _lib is None:
        paths, _ = build_all([Job("stark_mimc_chain", host_compiler(), CXX_FLAGS, SOURCE)])
        lib = ctypes.CDLL(paths["stark_mimc_chain"])
        lib.stark_mimc_chain.argtypes = [ctypes.c_uint64] * 5 + [ctypes.c_void_p]
        lib.stark_mimc_chain.restype = None
        _lib = lib
    return _lib


def chain_bytes(x0_mont: int, c_mont: int, steps: int) -> np.ndarray:
    """N2: the chain x_0 .. x_steps from Montgomery-form x_0 and c, as
    (steps + 1) * 16 little-endian Montgomery bytes."""
    buf = np.empty((steps + 1) * 16, dtype=np.uint8)
    load_chain().stark_mimc_chain(
        x0_mont & _MASK64, x0_mont >> 64, c_mont & _MASK64, c_mont >> 64,
        steps, buf.ctypes.data,
    )
    return buf


def chain_plain(x0_mont: int, c_mont: int, steps: int) -> List[int]:
    """Plain version of N2: the same chain in Montgomery form by Python
    ints, x <- x*x*x*R^-2 + c mod p (two Montgomery products and an add)."""
    out = [x0_mont]
    x = x0_mont
    for _ in range(steps):
        x = (x * x * _R_INV % P * x * _R_INV + c_mont) % P
        out.append(x)
    return out


def unpack_columns(words: torch.Tensor) -> torch.Tensor:
    """Packed (4, n) 32-bit words in int32 lanes -> (1, NLIMBS, n) 16-bit
    limb rows: word k holds limbs 2k (low half) and 2k + 1 (high half).
    The shift is arithmetic on int32, so the high half is masked after it."""
    rows = []
    for k in range(4):
        rows.append(words[k] & 0xFFFF)
        rows.append((words[k] >> 16) & 0xFFFF)
    return torch.stack(rows)[None]


class MiMC:
    """The MiMC cubing-chain workload over num_steps steps (a trace of
    num_steps + 1 cycles, 1 register), its columns on ``device`` (the
    card unless the caller passes "cpu")."""

    m = 1

    def __init__(self, num_steps: int, device=None):
        self.num_steps = num_steps
        self.field = Field.main()
        self.c = FieldElement(MIMC_C, self.field)
        self.device = resolve_device(device)
        self._air_eval = None
        self._index_air = None

    # -- scalar semantics (the oracle) -----------------------------------
    def forward(self, input_element: FieldElement) -> FieldElement:
        x = input_element
        for _ in range(self.num_steps):
            x = x ** 3 + self.c
        return x

    def trace(self, input_element: FieldElement) -> List[List[FieldElement]]:
        x = input_element
        rows = [[x]]
        for _ in range(self.num_steps):
            x = x ** 3 + self.c
            rows.append([x])
        return rows

    # -- AIR ---------------------------------------------------------------
    def transition_constraints(self, omicron=None) -> List[MPolynomial]:
        """next - cur^3 - c = 0; degree 3, constant coefficients (omicron
        is accepted for parity with the Rescue model and unused)."""
        x, cur, nxt = MPolynomial.variables(3, self.field)
        return [nxt - cur ** 3 - MPolynomial.constant(self.c)]

    def boundary_constraints(
        self, input_element: FieldElement, output_element: FieldElement
    ) -> Boundary:
        return [
            (0, 0, input_element),
            (self.num_steps, 0, output_element),
        ]

    # -- trace ---------------------------------------------------------------
    def trace_words_with_output(self, input_value: int) -> Tuple[np.ndarray, int]:
        """Host only: (packed (4, n) uint32 words, canonical output int),
        by N2; the output is decoded from the host buffer.  The pipelined
        prover runs this in its worker thread."""
        x_m = input_value % P * R % P
        c_m = self.c.value * R % P
        buf = chain_bytes(x_m, c_m, self.num_steps)
        words = np.ascontiguousarray(buf.view("<u4").reshape(self.num_steps + 1, 4).T)
        out_m = int.from_bytes(buf[-16:].tobytes(), "little")
        return words, out_m * _R_INV % P

    def columns_from_words(self, words: np.ndarray) -> torch.Tensor:
        """Packed host (4, n) words -> (1, NLIMBS, n) trace columns on the
        device: one copy of 16 bytes an element, unpacked there."""
        packed = torch.from_numpy(np.ascontiguousarray(words).view(np.int32))
        return unpack_columns(packed.to(self.device))

    def trace_columns_with_output(self, input_value: int) -> Tuple[torch.Tensor, int]:
        """(trace columns (1, NLIMBS, num_steps + 1) in Montgomery form on
        the device, canonical output int)."""
        words, out = self.trace_words_with_output(input_value)
        return self.columns_from_words(words), out

    def trace_columns(self, input_value: int) -> torch.Tensor:
        """Trace columns (1, NLIMBS, num_steps + 1), Montgomery form, for
        FastStark.prove(trace_columns=...)."""
        return self.trace_columns_with_output(input_value)[0]

    # -- evaluators ----------------------------------------------------------
    def air_evaluator(self):
        """Pointwise device AIR, next - cur^3 - c: (C = 1, L, N), four
        launches.  Cached on the instance."""
        if self._air_eval is None:
            c = mont_const(self.c.value, self.device)

            def evaluator(x_lde, current, next_):
                cur = current[..., 0, :, :]
                nxt = next_[..., 0, :, :]
                cur3 = F.mont_mul(F.mont_mul(cur, cur), cur)
                return F.sub(F.sub(nxt, cur3), c).unsqueeze(-3)

            self._air_eval = evaluator
        return self._air_eval

    def point_air(self):
        """Scalar per-point AIR for the verifier."""
        c = self.c

        def evaluator(x, current, next_):
            return [next_[0] - current[0] ** 3 - c]

        return evaluator

    def index_air(self):
        """Batched device AIR for the verifier (the index argument is unused:
        the constraint has no cycle-dependent constants).  Cached on the
        instance."""
        if self._index_air is None:
            c = mont_const(self.c.value, self.device)

            def evaluator(idx, current, next_):
                cur = current[0]
                cur3 = F.mont_mul(F.mont_mul(cur, cur), cur)
                return F.sub(F.sub(next_[0], cur3), c)[None]

            self._index_air = evaluator
        return self._index_air


def make_stark(
    num_steps: int,
    expansion_factor: int = 4,
    num_colinearity_checks: int = 64,
    security_level: int = 128,
    device=None,
) -> Tuple[MiMC, FastStark]:
    """The MiMC workload and a FastStark sized for it, both on ``device``."""
    mimc = MiMC(num_steps, device=device)
    stark = FastStark(
        mimc.field,
        expansion_factor,
        num_colinearity_checks,
        security_level,
        mimc.m,
        num_steps + 1,
        transition_constraints_degree=3,
        device=mimc.device,
    )
    return mimc, stark


def prove_chain(mimc: MiMC, stark: FastStark, input_element: FieldElement, tz=None,
                urandom=os.urandom):
    """Compute the chain and prove it.  Returns (output_element, proof,
    transition_zerofier).  ``urandom`` is the prover's entropy (a seeded
    stand-in gives reproducible bytes).  The ``trace_gen`` phase has two
    parts on ``stark.timer``: ``trace_gen.chain`` (N2 on the host) and
    ``trace_gen.upload`` (the pageable copy, the unpack on the card and
    the wait for it)."""
    if tz is None:
        tz = stark.preprocess()
    timer = stark.timer
    with timer.phase("trace_gen"):
        with timer.phase("trace_gen.chain"):
            words, output_value = mimc.trace_words_with_output(input_element.value)
        with timer.phase("trace_gen.upload"):
            cols = mimc.columns_from_words(words)
            device_sync(cols.device)
    output_element = FieldElement(output_value, mimc.field)
    proof = prove_columns(mimc, stark, input_element, output_element, cols, tz, urandom)
    return output_element, proof, tz


def prove_columns(mimc: MiMC, stark: FastStark, input_element: FieldElement,
                  output_element: FieldElement, cols: torch.Tensor, tz, urandom=os.urandom) -> bytes:
    """The proof of a chain whose trace columns are already on the device
    (``prove_chain`` and the pipelined prover both end here)."""
    return stark.prove(
        None,
        mimc.transition_constraints(),
        mimc.boundary_constraints(input_element, output_element),
        tz,
        air_evaluator=mimc.air_evaluator(),
        trace_columns=cols,
        urandom=urandom,
    )


def verify_chain(
    mimc: MiMC,
    stark: FastStark,
    input_element: FieldElement,
    output_element: FieldElement,
    proof: bytes,
    tz_root: bytes,
) -> bool:
    return stark.verify(
        proof,
        mimc.transition_constraints(),
        mimc.boundary_constraints(input_element, output_element),
        tz_root,
        air_point_evaluator=mimc.point_air(),
        air_index_evaluator=mimc.index_air(),
    )
