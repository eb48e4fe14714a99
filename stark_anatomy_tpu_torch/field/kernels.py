"""The field kernels written by hand for Hopper, with their plain versions.

H0 ``mont_mul`` replaces the JAX package's only TPU kernel, K0
(stark_anatomy_tpu/field/pallas_kernels.py:mont_mul_pallas_core), and H0
``mont_pow`` runs a whole x^e over it in one launch (in place of the jnp
scan stark_anatomy_tpu/field/ops.py:mont_pow): the fixed chain INV_CHAIN
for the Fermat inverse x^(p-2), square and multiply for any other
exponent (``pow_route``).  H1
``add_mod`` and ``sub_mod`` replace the jnp row functions
field/limb_arith.py:add_mod_rows and sub_mod_rows.  H2
``rescue_permutation`` runs the whole Rescue-Prime permutation in one
launch (stark_anatomy_tpu/models/rescue_prime.py:_permutation_scan), and
H3 ``ntt`` a whole NTT of up to 8192 points in one launch
(stark_anatomy_tpu/ops/ntt.py:ntt_core), on one of two paths by the
batch (``ntt_plan``); H8 ``ntt_tiled`` runs a larger one, up to 2^24
points, in two launches, a step each (stark_anatomy_tpu/ops/stage_ntt.py:
staged_ntt, the four-step transform).  H9 ``ntt_columns`` runs step 1 of
the distributed NTT on one shard in one launch: the A-point column
transforms, the cross twiddle and the coset pre-scale
(stark_anatomy_tpu/parallel/ntt_dist.py:make_distributed_ntt, K18's
column step, and parallel/sharded_stark.py:_lde's scale).  H6 ``fri_fold`` runs one round of
the FRI fold (stark_anatomy_tpu/protocols/fri.py:_fold_kernel and
_square_half) and writes the folded codeword's canonical form beside it;
H7 ``fri_fold_batched`` does the same for a batch of codewords, one
challenge per proof (stark_anatomy_tpu/protocols/fri.py:
_fold_kernel_batched).  H10 ``rescue_quotients`` computes the boundary
and transition quotients of the Rescue AIR in one launch
(stark_anatomy_tpu/protocols/fast_stark.py:_bq_core and _air_quotient_fn
over models/rescue_prime.py:_rescue_air_kernel), H11 ``combination`` the
weighted combination codeword (fast_stark.py:_combination_core, the batch
core's weighted_sum), H12 ``verify_core`` the verifier's combination at
the query points (fast_stark.py:_verify_core with the Rescue index
evaluator).  H13 ``sample_mont`` turns a batch's randomness draws, 17
bytes each, into Montgomery field elements in one launch (the host's
Field.sample and utils/convert.py:device_from_ints of each draw, which
the JAX package's batch prover runs on the host).
The sources are csrc/field.cu, csrc/ntt_tiled.cu (H8),
csrc/ntt_columns.cu (H9) and csrc/air.cu (H10-H12), the word arithmetic
they share with csrc/merkle.cu, csrc/field_arith.cuh, H3's passes, which
H8's blocks run too and whose DFTs H9 runs, csrc/ntt_passes.cuh, the
power chains of H0's ladder and H12, csrc/pow_chain.cuh, and the Rescue
AIR of H10 and H12, csrc/rescue_air.cuh; the header of each source says
what bounds each kernel and how the design answers it.

Each wrapper takes int32 limb tensors (..., 8, n) in Montgomery form:
* on a CPU tensor it runs the kernel's plain PyTorch version below;
* on a CUDA tensor it launches the kernel on the current stream, or
  raises: there is no fallback.

This module also builds and loads H4 ``merkle`` and H5 ``seed_expand``
(csrc/merkle.cu), the blake2s Merkle tree kernel and the seed-expansion
kernel, whose wrappers and plain versions are in commit/kernels.py.  Each CUDA source is built at first use by one ``nvcc``
call into ``_build/`` (git-ignored), the calls side by side, cached by a
hash of the source and flags (utils/build.py), and loaded with ctypes.
``LAUNCHES`` counts the launches of each kernel.
"""

from __future__ import annotations

import ctypes
import math
import os
import shutil
import weakref
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from ..utils.build import Job, build_all
from .limb_arith import add_mod_rows, carry_rows, cond_sub_p_rows, sub_mod_rows
from .limbs import LIMB_BITS, MASK, NLIMBS, NPRIME, R, int_to_limbs
from .scalar import P

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = {                       # library stem -> CUDA source
    "stark_field": os.path.join(_PKG, "csrc", "field.cu"),
    "stark_merkle": os.path.join(_PKG, "csrc", "merkle.cu"),
    "stark_ntt_tiled": os.path.join(_PKG, "csrc", "ntt_tiled.cu"),
    "stark_ntt_columns": os.path.join(_PKG, "csrc", "ntt_columns.cu"),
    "stark_air": os.path.join(_PKG, "csrc", "air.cu"),
}
HEADERS = tuple(os.path.join(_PKG, "csrc", h)
                for h in ("field_arith.cuh", "ntt_passes.cuh", "pow_chain.cuh", "rescue_air.cuh"))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
BINARY = ("mont_mul", "add_mod", "sub_mod")
KERNELS = ("mont_mul", "mont_pow", "add_mod", "sub_mod", "rescue_perm", "ntt", "merkle",
           "seed_expand", "fri_fold", "fri_fold_batched", "ntt_tiled", "ntt_columns",
           "rescue_quotients", "combination", "verify_core", "sample_mont")
AIR_KERNELS = ("rescue_quotients", "combination", "verify_core")
LIBRARY = {name: "stark_merkle" if name in ("merkle", "seed_expand")
           else f"stark_{name}" if name in ("ntt_tiled", "ntt_columns")
           else "stark_air" if name in AIR_KERNELS else "stark_field"
           for name in KERNELS}
RESCUE_M = 2            # Rescue-Prime state width
RESCUE_ROUNDS = 27
# The Rescue S-box x^(1/3) is x^ALPHA_INV, ALPHA_INV = (2p - 1)/3 =
# 0x87AA...AB (128 bits, 65 of them ones).  H2 and its plain version
# compute it by this fixed chain of Montgomery products in place of the
# ladder: a step (out, a, b) sets out = a * b, a squaring where a == b, and
# the chain's result is "acc".  127 squarings and 20 multiplies, 147
# products against the ladder's 191 (127 + 64).  csrc/field.cu:pow_alpha_inv
# runs the same steps.
ALPHA_INV_CHAIN = (
    [("x2", "x", "x"), ("x4", "x2", "x2"), ("x5", "x4", "x"), ("x10", "x5", "x5"),
     ("x20", "x10", "x10"), ("x40", "x20", "x20"), ("x80", "x40", "x40"),
     ("x85", "x80", "x5"),                    # x^0x55
     ("x170", "x85", "x85"),                  # x^0xAA
     ("x171", "x170", "x"),                   # x^0xAB
     ("x125", "x85", "x40"), ("acc", "x125", "x10")]   # x^0x87, the top byte
    # each lower byte b: acc <- acc^256 * x^b
    + [step for byte in (0xAA,) * 14 + (0xAB,)
       for step in [("acc", "acc", "acc")] * 8 + [("acc", "acc", f"x{byte}")]]
)


def _run(out: str, src: str, k: int, factor: str) -> list:
    """Steps out = src^(2^k) * factor: k squarings, then a product."""
    return [(out, src, src)] + [(out, out, out)] * (k - 1) + [(out, out, factor)]


# The Fermat inverse x^(p-2), p - 2 = 406 * 2^119 + (2^119 - 1) (128 bits,
# 124 of them ones), by a fixed chain in the same step form: x^(2^m - 1)
# for m = 2, 3, 5, 10, 11, then x^203 from x^3, then the zero bit and the
# 119 ones in blocks of 10, 10 and nine of 11 (each m squarings and a
# product by x^(2^m - 1)).  136 squarings and 18 products, 154 against the
# ladder's 250 (127 + 123).  csrc/pow_chain.cuh:pow_inv runs the same steps;
# the plain ladder mont_pow_plain stays the independent yardstick.
INV_CHAIN = (
    [("x3", "x", "x"), ("x3", "x3", "x")]                         # x^(2^2 - 1)
    + _run("x7", "x3", 1, "x") + _run("x31", "x7", 2, "x3")
    + _run("x1023", "x31", 5, "x31") + _run("x2047", "x1023", 1, "x")
    + _run("acc", "x3", 3, "x") + _run("acc", "acc", 3, "x3")     # x^25, x^203
    + _run("acc", "acc", 11, "x1023") + _run("acc", "acc", 10, "x1023")
    + [step for _ in range(9) for step in _run("acc", "acc", 11, "x2047")]
)
NTT_MAX = 8192          # H3 holds a whole transform in shared memory (one block or a cluster)
NTT_CLUSTER = 8         # blocks a transform is spread over when the batch cannot fill the card
NTT_CLUSTER_MIN = 1024  # ... from n = 1024 up (16 threads a block; below, a block is enough)
NTT_STAGE = 4096        # the n whose persistent path stages each row (one block an SM)
TILED_MIN = 8           # H8's inner transforms: a cluster holds 8 of them (one sector of a limb row) ...
TILED_MAX = 4096        # ... of at most 4096 points (n/8 threads a block, 16 n bytes)
TILED_ROWS = 1 << 20    # points of the rows H8's plain version transforms at a time
COLUMNS_MAX = 8         # H9's column transforms run in registers: A = 1, 2, 4 or 8 points

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
_SMS: Dict[int, int] = {}                 # device index -> its SM count
_TWIDDLE_WORDS: Dict[int, tuple] = {}     # id(power table) -> (weakref, version, packed words)
build_log = ""          # nvcc's output (ptxas register use) of the last build
_libs = None
_fns: Dict[str, object] = {}    # kernel name -> its ctypes entry point


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the kernels are built from csrc/field.cu and csrc/merkle.cu")


def build() -> Dict[str, str]:
    """Compile each CUDA source that was not built already, one ``nvcc``
    call per source, all at once; returns {library stem: path}."""
    global build_log
    paths, log = build_all([Job(stem, _nvcc(), NVCC_FLAGS, src, HEADERS)
                            for stem, src in SOURCES.items()])
    build_log = log or build_log
    return paths


_BINARY_ARGTYPES = (
    [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 8 + [ctypes.c_void_p, ctypes.c_int]
)
_ARGTYPES = {
    "mont_pow": [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [ctypes.c_uint64] * 2
    + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int],
    "rescue_perm": [ctypes.c_void_p] * 2 + [ctypes.c_int64] + [ctypes.c_void_p] * 2
    + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int],
    "ntt": [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_int] + [ctypes.c_void_p] * 2
    + [ctypes.c_int64] * 3 + [ctypes.c_void_p] + [ctypes.c_int64] * 3
    + [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int],
    "merkle": [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [ctypes.c_void_p, ctypes.c_int],
    "seed_expand": [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_int],
    "fri_fold": [ctypes.c_void_p] * 5 + [ctypes.c_int64] + [ctypes.c_uint64] * 4
    + [ctypes.c_void_p, ctypes.c_int],
    "fri_fold_batched": [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 2 + [ctypes.c_uint64] * 2
    + [ctypes.c_void_p, ctypes.c_int],
    "ntt_tiled": [ctypes.c_void_p] * 2 + [ctypes.c_int64] + [ctypes.c_int] * 3
    + [ctypes.c_void_p] * 4 + [ctypes.c_int64] + [ctypes.c_void_p] * 2 + [ctypes.c_int],
    "ntt_columns": [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int64]
    + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int64] + [ctypes.c_void_p] * 5 + [ctypes.c_int],
    "rescue_quotients": [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3 + [ctypes.c_void_p, ctypes.c_int],
    "combination": [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 2
    + [ctypes.c_void_p, ctypes.c_int],
    "verify_core": [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                                            ctypes.c_void_p, ctypes.c_int64]
    + [ctypes.c_void_p] * 8 + [ctypes.c_int],
    "sample_mont": [ctypes.c_void_p] * 2 + [ctypes.c_int64] + [ctypes.c_uint64] * 2
    + [ctypes.c_void_p, ctypes.c_int],
}


def load() -> Dict[str, ctypes.CDLL]:
    """Build (at first use) and load every kernel library."""
    global _libs
    if _libs is None:
        libs = {stem: ctypes.CDLL(path) for stem, path in build().items()}
        for name in KERNELS:
            fn = getattr(libs[LIBRARY[name]], "stark_" + name)
            fn.argtypes = _ARGTYPES.get(name, _BINARY_ARGTYPES)
            fn.restype = ctypes.c_int
            _fns[name] = fn
        _libs = libs
    return _libs


def _entry(name: str):
    if not _fns:
        load()
    return _fns[name]


# ---------------------------------------------------------------------------
# launch
# ---------------------------------------------------------------------------

def operand_strides(
    x: torch.Tensor, lead: Tuple[int, ...], n: int
) -> Optional[Tuple[int, int, int]]:
    """(batch, limb, element) strides of an operand the kernels take for an
    output (*lead, 8, n), or None.  They take a contiguous int32 tensor
    whose leading shape is ``lead`` or all ones, and whose last axis is n
    or 1 (one element broadcast along the row)."""
    if x.dtype != torch.int32 or x.dim() < 2 or x.shape[-2] != NLIMBS:
        return None
    if not x.is_contiguous():
        return None
    nx = x.shape[-1]
    if nx != n and nx != 1:
        return None
    xlead = tuple(x.shape[:-2])
    if xlead == lead:
        sb = NLIMBS * nx
    elif math.prod(xlead) == 1:
        sb = 0
    else:
        return None
    return sb, nx, (1 if nx == n else 0)


Layout = Tuple[torch.Size, Optional[Tuple[int, int, int]], Optional[Tuple[int, int, int]]]


def binary_layout(a: torch.Tensor, b: torch.Tensor) -> Layout:
    """(output shape, strides of a, strides of b) for a binary kernel; a
    stride triple is None where the kernel does not take that operand as
    it lies (``operand_strides``)."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    if len(shape) < 2 or shape[-2] != NLIMBS:
        raise ValueError(f"expected (..., {NLIMBS}, n) limb tensors, got {tuple(shape)}")
    lead, n = tuple(shape[:-2]), shape[-1]
    return shape, operand_strides(a, lead, n), operand_strides(b, lead, n)


def _check_cuda(name: str, *xs: torch.Tensor) -> None:
    if xs[0].device.type != "cuda" or any(x.device != xs[0].device for x in xs):
        raise ValueError(f"{name}: operands must lie on one CUDA device, got "
                         + " and ".join(str(x.device) for x in xs))


def _stream(x: torch.Tensor) -> Tuple[int, int]:
    """(current stream, device index) of a CUDA tensor: the last two
    arguments of every entry point."""
    return torch.cuda.current_stream(x.device).cuda_stream, x.device.index


def _finish(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1


def _launch(name: str, a: torch.Tensor, b: torch.Tensor, layout: Optional[Layout]) -> torch.Tensor:
    _check_cuda(name, a, b)
    shape, sa, sb = layout if layout is not None else binary_layout(a, b)
    if sa is None or sb is None:
        raise ValueError(
            f"{name}: the kernel takes contiguous int32 (..., {NLIMBS}, n) operands "
            f"that match or broadcast whole axes; got {tuple(a.shape)} {a.dtype} and "
            f"{tuple(b.shape)} {b.dtype}"
        )
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    err = _entry(name)(
        out.data_ptr(), a.data_ptr(), b.data_ptr(), math.prod(shape[:-2]), shape[-1],
        *sa, *sb, *_stream(a),
    )
    _finish(name, err)
    return out


def _dispatch(name: str, plain, a: torch.Tensor, b: torch.Tensor,
              layout: Optional[Layout]) -> torch.Tensor:
    if a.device.type == "cpu" and b.device.type == "cpu":
        return plain(a, b)
    return _launch(name, a, b, layout)


# ``layout`` is ``binary_layout(a, b)`` where the caller has it already
# (field/ops.py), so that a call checks its operands once.

def mont_mul(a: torch.Tensor, b: torch.Tensor, layout: Optional[Layout] = None) -> torch.Tensor:
    """H0: Montgomery product a*b*2^-128 mod p, elementwise."""
    return _dispatch("mont_mul", mont_mul_plain, a, b, layout)


def add_mod(a: torch.Tensor, b: torch.Tensor, layout: Optional[Layout] = None) -> torch.Tensor:
    """H1: (a + b) mod p, elementwise."""
    return _dispatch("add_mod", add_mod_plain, a, b, layout)


def sub_mod(a: torch.Tensor, b: torch.Tensor, layout: Optional[Layout] = None) -> torch.Tensor:
    """H1: (a - b) mod p, elementwise."""
    return _dispatch("sub_mod", sub_mod_plain, a, b, layout)


def exponent_words(exponent: int) -> Tuple[int, int, int]:
    """(low 64 bits, high 64 bits, bit length) of an exponent the ladder
    takes: 0 <= exponent < 2^128."""
    if exponent < 0 or exponent >> 128:
        raise ValueError(f"mont_pow: the exponent must lie in [0, 2^128), got {exponent}")
    return exponent & ((1 << 64) - 1), exponent >> 64, exponent.bit_length()


def pow_route(exponent: int) -> str:
    """The kernel's path for x^exponent: "inv_chain", the fixed chain
    INV_CHAIN, for the Fermat inverse's p - 2; "ladder", square and
    multiply over the exponent's bits, for any other.  csrc/field.cu's
    launcher (stark_mont_pow) picks by the same rule."""
    exponent_words(exponent)
    return "inv_chain" if exponent == P - 2 else "ladder"


def mont_pow(x: torch.Tensor, exponent: int) -> torch.Tensor:
    """H0 ladder: x^exponent in Montgomery form, elementwise, for a host
    integer 0 <= exponent < 2^128 (exponent 0 gives the Montgomery one);
    on the card by the path ``pow_route`` names."""
    words = exponent_words(exponent)
    if x.device.type == "cpu":
        return mont_pow_plain(x, exponent)
    _check_cuda("mont_pow", x)
    if x.dtype != torch.int32 or x.dim() < 2 or x.shape[-2] != NLIMBS or not x.is_contiguous():
        raise ValueError(f"mont_pow: the kernel takes a contiguous int32 (..., {NLIMBS}, n) "
                         f"tensor; got {tuple(x.shape)} {x.dtype}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    n = x.shape[-1]
    err = _entry("mont_pow")(
        out.data_ptr(), x.data_ptr(), math.prod(x.shape[:-2]), n, *words, *_stream(x),
    )
    _finish("mont_pow", err)
    return out


def run_chain(x, mul, chain=ALPHA_INV_CHAIN):
    """The result of ``chain`` (ALPHA_INV_CHAIN or INV_CHAIN) from x, with
    ``mul`` as the product."""
    values = {"x": x}
    for out, a, b in chain:
        values[out] = mul(values[a], values[b])
    return values["acc"]


ALPHA_INV = run_chain(1, lambda a, b: a + b)    # the exponent the chain computes


def _check_alpha_inv(alpha_inv: int) -> None:
    if alpha_inv != ALPHA_INV:
        raise ValueError(f"rescue_perm: x^(1/3) runs a fixed chain for ALPHA_INV = {ALPHA_INV:#x}; "
                         f"got the exponent {alpha_inv:#x}")


def _check_table(name: str, table: torch.Tensor, shape: Tuple[int, ...]) -> None:
    if table.dtype != torch.int32 or tuple(table.shape) != shape or not table.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 {shape} table; "
                         f"got {tuple(table.shape)} {table.dtype}")


def rescue_permutation(state: torch.Tensor, rc: torch.Tensor, mds: torch.Tensor,
                       alpha_inv: int, collect_trace: bool) -> torch.Tensor:
    """H2: the 27-round Rescue-Prime permutation of (m, 8, B) Montgomery
    states, m = 2.  ``rc`` holds the round constants (N, 2, m, 8, 1) (round
    r adds [r, 0] after its forward half, [r, 1] after its backward half),
    ``mds`` the MDS matrix (m, m, 8, 1), both in Montgomery form, and the
    backward S-box is x^alpha_inv, which must be ALPHA_INV (ValueError
    otherwise: the kernel runs a fixed chain for it).  Returns every state
    from the input on, (N+1, m, 8, B), if ``collect_trace``; else the final
    states (m, 8, B)."""
    _check_alpha_inv(alpha_inv)
    if state.device.type == "cpu":
        return rescue_permutation_plain(state, rc, mds, alpha_inv, collect_trace)
    _check_cuda("rescue_perm", state, rc, mds)
    if (state.dtype != torch.int32 or tuple(state.shape[:-1]) != (RESCUE_M, NLIMBS)
            or not state.is_contiguous()):
        raise ValueError(f"rescue_perm: the kernel takes a contiguous int32 ({RESCUE_M}, "
                         f"{NLIMBS}, B) state; got {tuple(state.shape)} {state.dtype}")
    _check_table("rescue_perm: rc", rc, (RESCUE_ROUNDS, 2, RESCUE_M, NLIMBS, 1))
    _check_table("rescue_perm: mds", mds, (RESCUE_M, RESCUE_M, NLIMBS, 1))
    lead = (RESCUE_ROUNDS + 1,) if collect_trace else ()
    out = torch.empty(lead + tuple(state.shape), dtype=torch.int32, device=state.device)
    if out.numel() == 0:
        return out
    err = _entry("rescue_perm")(
        out.data_ptr(), state.data_ptr(), state.shape[-1], rc.data_ptr(), mds.data_ptr(),
        int(collect_trace), *_stream(state),
    )
    _finish("rescue_perm", err)
    return out


def ntt_layout(values: torch.Tensor) -> Tuple[int, int]:
    """(batch, log2 n) of a (..., 8, n) input H3 takes: contiguous int32,
    n a power of two with 1 <= n <= NTT_MAX.  Raises ValueError for any
    other input."""
    if values.dtype != torch.int32 or values.dim() < 2 or values.shape[-2] != NLIMBS:
        raise ValueError(f"ntt: the kernel takes int32 (..., {NLIMBS}, n) limb tensors; "
                         f"got {tuple(values.shape)} {values.dtype}")
    n = values.shape[-1]
    if n < 1 or n & (n - 1):
        raise ValueError(f"ntt: the length must be a power of two, got {n}")
    if n > NTT_MAX:
        raise ValueError(f"ntt: the kernel takes n <= {NTT_MAX} (its shared memory holds "
                         f"the whole transform); got n = {n}")
    if not values.is_contiguous():
        raise ValueError("ntt: the kernel takes a contiguous input")
    return math.prod(values.shape[:-2]), n.bit_length() - 1


def _scale_args(name: str, scale: Optional[torch.Tensor], lead, n: int):
    """(pointer or None, sb, sl, se) of an optional scale operand."""
    if scale is None:
        return None, 0, 0, 0
    strides = operand_strides(scale, lead, n)
    if strides is None:
        raise ValueError(f"ntt: {name} must be a contiguous int32 (..., {NLIMBS}, {n}) table "
                         f"that matches or broadcasts the input; got {tuple(scale.shape)} {scale.dtype}")
    return scale.data_ptr(), *strides


def ntt_plan(batch: int, log_n: int, sms: int) -> Tuple[str, int, bool]:
    """(path, blocks per transform, staged) of H3 for ``batch`` transforms
    of 2^log_n points on a card of ``sms`` SMs.  "cluster": each transform
    spread over a cluster of NTT_CLUSTER blocks, where the batch's clusters
    leave SMs idle otherwise (the sign, the verify, the generic prover).
    "persistent": one block a transform (two at n = 8192, whose 1024
    threads one block cannot hold), a grid of the blocks resident at once
    looping over the rows.  At n = NTT_STAGE, where the block's registers
    leave one block an SM and so nothing else hides a row's loads, each
    row's limbs are staged by cp.async while the row before it runs; at
    smaller n two or more blocks an SM overlap each other's loads, and
    staging (32 n bytes of shared memory taken from the L1 cache) measured
    slower.  The wrapper stages no row that has a post-scale table, which
    also measured slower staged (PERF.md)."""
    n = 1 << log_n
    if n >= NTT_CLUSTER_MIN and batch * NTT_CLUSTER <= sms:
        return "cluster", NTT_CLUSTER, False
    if n > NTT_STAGE:
        return "persistent", 2, False
    return "persistent", 1, n == NTT_STAGE


def _sm_count(device: torch.device) -> int:
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device.index]


def pack_words(limbs: torch.Tensor) -> torch.Tensor:
    """The contiguous (..., n, 4) int32 words of a (..., 8, n) limb tensor:
    each element's four 32-bit words side by side, least significant first
    (16 bytes an element: H3's twiddle tables, H8's intermediate)."""
    x = limbs.long() & 0xFFFF
    words = x[..., 0::2, :] | (x[..., 1::2, :] << 16)                   # (..., 4, n)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)
    return words.transpose(-1, -2).contiguous()


def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """The contiguous (..., 8, n) limbs of packed (..., n, 4) words."""
    w = words.long() & 0xFFFFFFFF
    limbs = torch.stack([w & 0xFFFF, w >> 16], dim=-1).flatten(-2)      # (..., n, 8)
    return limbs.transpose(-1, -2).to(torch.int32).contiguous()


def twiddle_words(powers: torch.Tensor) -> torch.Tensor:
    """The contiguous (n, 4) int32 words of an (8, n) power table, each
    element's four 32-bit words side by side (one 16-byte load in H3).
    Cached per table, for as long as the table lives unchanged."""
    key = id(powers)
    hit = _TWIDDLE_WORDS.get(key)
    if hit is not None and hit[0]() is powers and hit[1] == powers._version:
        return hit[2]
    words = pack_words(powers)
    _TWIDDLE_WORDS[key] = (weakref.ref(powers, lambda _: _TWIDDLE_WORDS.pop(key, None)),
                           powers._version, words)
    return words


def ntt(values: torch.Tensor, powers: torch.Tensor, n_inv: Optional[torch.Tensor] = None,
        scale_pre: Optional[torch.Tensor] = None,
        scale_post: Optional[torch.Tensor] = None) -> torch.Tensor:
    """H3: an NTT over the last axis of (..., 8, n) Montgomery values,
    batched over the leading axes.  ``powers`` is the (8, n) table w^j of a
    primitive n-th root w (the inverse's: w^-j), ``n_inv`` an optional (8, 1)
    factor (1/n for the inverse), and the scales optional tables on the
    input and the output:
        out_k = post_k * n_inv * sum_j pre_j * x_j * w^(j k).
    The path (``ntt_plan``) follows the batch and n."""
    if values.device.type == "cpu":
        return ntt_plain(values, powers, n_inv, scale_pre, scale_post)
    _check_cuda("ntt", *(t for t in (values, powers, n_inv, scale_pre, scale_post) if t is not None))
    batch, log_n = ntt_layout(values)
    n = values.shape[-1]
    lead = tuple(values.shape[:-2])
    _check_table("ntt: powers", powers, (NLIMBS, n))
    if n_inv is not None:
        _check_table("ntt: n_inv", n_inv, (NLIMBS, 1))
    pre = _scale_args("scale_pre", scale_pre, lead, n)
    post = _scale_args("scale_post", scale_post, lead, n)
    out = torch.empty_like(values)
    if out.numel() == 0:
        return out
    _, cluster, stage = ntt_plan(batch, log_n, _sm_count(values.device))
    stage = stage and scale_post is None
    err = _entry("ntt")(
        out.data_ptr(), values.data_ptr(), batch, log_n, twiddle_words(powers).data_ptr(),
        *pre, *post, None if n_inv is None else n_inv.data_ptr(), cluster, int(stage),
        *_stream(values),
    )
    _finish("ntt", err)
    return out


def tiled_split(n: int) -> Tuple[int, int]:
    """(n1, n2) of H8's transform of n points: n1 = 2^floor(log2(n) / 2),
    n2 = n / n1 >= n1."""
    n1 = 1 << ((n.bit_length() - 1) // 2)
    return n1, n // n1


def tiled_layout(values: torch.Tensor, step: int, n1: int) -> Tuple[int, int, int]:
    """(batch, n, n2) of an input H8's ``step`` takes: contiguous int32
    limbs (..., 8, n) for step 0, packed words (..., n, 4) for step 1, n a
    power of two, n1 and n2 = n / n1 powers of two in [TILED_MIN,
    TILED_MAX].  Raises ValueError for any other input."""
    if step not in (0, 1):
        raise ValueError(f"ntt_tiled: the step is 0 (columns) or 1 (rows), got {step}")
    shape = f"(..., {NLIMBS}, n)" if step == 0 else "(..., n, 4)"
    if (values.dtype != torch.int32 or values.dim() < 2 or not values.is_contiguous()
            or (values.shape[-2] != NLIMBS if step == 0 else values.shape[-1] != 4)):
        raise ValueError(f"ntt_tiled: step {step} takes a contiguous int32 {shape} tensor; "
                         f"got {tuple(values.shape)} {values.dtype}")
    n = values.shape[-1] if step == 0 else values.shape[-2]
    n2 = n // max(n1, 1)
    if n1 * n2 != n or not all(TILED_MIN <= k <= TILED_MAX and k & (k - 1) == 0 for k in (n1, n2)):
        raise ValueError(f"ntt_tiled: n = n1 n2 with n1, n2 powers of two in [{TILED_MIN}, "
                         f"{TILED_MAX}]; got n = {n}, n1 = {n1}")
    return math.prod(values.shape[:-2]), n, n2


def ntt_tiled(values: torch.Tensor, step: int, n1: int, powers: torch.Tensor,
              twiddles: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              n_inv: Optional[torch.Tensor] = None,
              scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """H8: one of the two launches of an NTT of n = n1 n2 points (input
    index j = j1 + n1 j2, output index k = k2 + n2 k1), batched over the
    leading axes; csrc/ntt_tiled.cu.
    * step 0, the columns: ``values`` (..., 8, n) limbs; ``powers`` the
      (8, n2) table w_n2^j (the inverse's w_n2^-j); ``twiddles`` the (8, n1)
      table w_n^(n2 i) and the (8, n2) table w_n^i (w_n^-i for the
      inverse); ``scale`` an optional pre-scale.  Returns the packed
      (..., n, 4) words Y[k2 n1 + j1] = w_n^(j1 k2) sum_j2 w_n2^(j2 k2)
      (scale x)[j1 + n1 j2].
    * step 1, the rows: ``values`` that Y; ``powers`` the (8, n1) table;
      ``n_inv`` an optional (8, 1) factor; ``scale`` an optional
      post-scale.  Returns (..., 8, n) limbs X[k2 + n2 k1] = (scale n_inv
      sum_j1 w_n1^(j1 k1) Y[k2 n1 + j1])[k2 + n2 k1].
    A scale is an (8, n) table, or an (..., 8, n) one that matches the
    batch."""
    if values.device.type == "cpu":
        return ntt_tiled_plain(values, step, n1, powers, twiddles, n_inv, scale)
    _check_cuda("ntt_tiled", values, powers,
                *(t for t in (*(twiddles or ()), n_inv, scale) if t is not None))
    batch, n, n2 = tiled_layout(values, step, n1)
    lead = tuple(values.shape[:-2])
    _check_table("ntt_tiled: powers", powers, (NLIMBS, n2 if step == 0 else n1))
    if step == 0:
        if twiddles is None or n_inv is not None:
            raise ValueError("ntt_tiled: step 0 takes the twiddle tables, and 1/n rides step 1")
        _check_table("ntt_tiled: twiddles", twiddles[0], (NLIMBS, n1))
        _check_table("ntt_tiled: twiddles", twiddles[1], (NLIMBS, n2))
    elif n_inv is not None:
        _check_table("ntt_tiled: n_inv", n_inv, (NLIMBS, 1))
    if values.data_ptr() % 16:
        raise ValueError("ntt_tiled: the kernel takes a 16-byte aligned input")
    scale_sb = 0
    if scale is not None:
        strides = operand_strides(scale, lead, n)
        if strides is None or strides[2] != 1:
            raise ValueError(f"ntt_tiled: the scale must be a contiguous int32 (..., {NLIMBS}, {n}) "
                             f"table that matches or broadcasts the batch; got {tuple(scale.shape)} "
                             f"{scale.dtype}")
        scale_sb = strides[0]
    out = torch.empty(lead + ((n, 4) if step == 0 else (NLIMBS, n)), dtype=torch.int32,
                      device=values.device)
    if out.numel() == 0:
        return out
    coarse, fine = (twiddle_words(t).data_ptr() for t in twiddles) if step == 0 else (None, None)
    err = _entry("ntt_tiled")(
        out.data_ptr(), values.data_ptr(), batch, n1.bit_length() - 1, n2.bit_length() - 1, step,
        twiddle_words(powers).data_ptr(), coarse, fine,
        None if scale is None else scale.data_ptr(), scale_sb,
        None if n_inv is None else n_inv.data_ptr(), *_stream(values),
    )
    _finish("ntt_tiled", err)
    return out


class ColumnTables(NamedTuple):
    """H9's tables, each an (8, m) limb table in Montgomery form: ``powers``
    the A-point table w_A^(+-i); ``coarse`` and ``fine`` (r^F)^i and r^i,
    r = w_n^(+-1), F = fine's length, so that r^b = coarse[b / F] fine[b
    mod F] for every column b of the shard; ``rows``, ``scale_coarse`` and
    ``scale_fine`` c^(a B) (a < A), (c^F)^i and c^i for a pre-scale by the
    coset offset c, all three or none; ``n_inv`` None or the (8, 1)
    constant 1/A (parallel/ntt_dist.py:column_tables builds them)."""

    powers: torch.Tensor
    coarse: torch.Tensor
    fine: torch.Tensor
    rows: Optional[torch.Tensor] = None
    scale_coarse: Optional[torch.Tensor] = None
    scale_fine: Optional[torch.Tensor] = None
    n_inv: Optional[torch.Tensor] = None


def _lead_stride(x: torch.Tensor) -> Optional[int]:
    """The stride of x's leading axes flattened into one (0 for one row), or
    None where they do not flatten."""
    dims = [(size, stride) for size, stride in zip(x.shape[:-2], x.stride()[:-2]) if size != 1]
    for (_, outer), (size, inner) in zip(dims, dims[1:]):
        if outer != inner * size:
            return None
    return dims[-1][1] if dims else 0


def columns_layout(pieces: Sequence[torch.Tensor], b0: int,
                   tables: ColumnTables) -> Tuple[Tuple[int, ...], int, list]:
    """(lead shape, w, [(row stride, limb stride)] a piece) of a call H9
    takes: A = 1, 2, 4 or 8 int32 pieces (..., 8, w) of one shape, w a power
    of two, each piece's elements adjacent and its leading axes flattening
    to one stride (a slice of a contiguous shard or of a receive buffer);
    the tables of ``ColumnTables`` at A and the split F, with b0 + w <=
    (coarse's length) F.  Raises ValueError for any other call."""
    A = len(pieces)
    if not 1 <= A <= COLUMNS_MAX or A & (A - 1):
        raise ValueError(f"ntt_columns: the kernel takes A = 1, 2, 4 or 8 pieces, got {A}")
    shape = tuple(pieces[0].shape)
    strides = []
    for p in pieces:
        if p.dtype != torch.int32 or tuple(p.shape) != shape or len(shape) < 2 or shape[-2] != NLIMBS:
            raise ValueError(f"ntt_columns: the pieces must be int32 (..., {NLIMBS}, w) tensors of one "
                             f"shape; got {tuple(p.shape)} {p.dtype} beside {shape}")
        sb = _lead_stride(p)
        if sb is None or (shape[-1] > 1 and p.stride(-1) != 1):
            raise ValueError(f"ntt_columns: a piece's elements must be adjacent and its leading axes "
                             f"flatten to one stride; got strides {p.stride()} for {tuple(p.shape)}")
        strides.append((sb, p.stride(-2)))
    w = shape[-1]
    if w < 1 or w & (w - 1):
        raise ValueError(f"ntt_columns: the pieces' width must be a power of two, got {w}")
    fine_len = tables.fine.shape[-1] if tables.fine.dim() == 2 else 0
    coarse_len = tables.coarse.shape[-1] if tables.coarse.dim() == 2 else 0
    if fine_len < 1 or fine_len & (fine_len - 1):
        raise ValueError(f"ntt_columns: the fine table's length must be a power of two, got {fine_len}")
    _check_table("ntt_columns: powers", tables.powers, (NLIMBS, A))
    _check_table("ntt_columns: coarse", tables.coarse, (NLIMBS, coarse_len))
    _check_table("ntt_columns: fine", tables.fine, (NLIMBS, fine_len))
    if b0 < 0 or b0 + w > coarse_len * fine_len:
        raise ValueError(f"ntt_columns: columns [{b0}, {b0 + w}) lie outside the tables' "
                         f"{coarse_len} x {fine_len} powers")
    scale = (tables.rows, tables.scale_coarse, tables.scale_fine)
    if any(t is None for t in scale) != all(t is None for t in scale):
        raise ValueError("ntt_columns: the pre-scale takes rows, scale_coarse and scale_fine together")
    if tables.rows is not None:
        _check_table("ntt_columns: rows", tables.rows, (NLIMBS, A))
        _check_table("ntt_columns: scale_coarse", tables.scale_coarse, (NLIMBS, coarse_len))
        _check_table("ntt_columns: scale_fine", tables.scale_fine, (NLIMBS, fine_len))
    if tables.n_inv is not None:
        _check_table("ntt_columns: n_inv", tables.n_inv, (NLIMBS, 1))
    return shape[:-2], w, strides


def ntt_columns(pieces: Sequence[torch.Tensor], b0: int, tables: ColumnTables) -> torch.Tensor:
    """H9: step 1 of the distributed NTT on one shard (csrc/ntt_columns.cu).
    ``pieces`` are the A pieces (..., 8, w) the first exchange brought,
    piece a holding columns b = b0 + t (t < w) of row a; ``tables`` their
    ``ColumnTables``.  Returns the contiguous (..., 8, A, w)
        out[..., :, k, t] = n_inv c^b r^(k b) sum_a w_A^(a k) c^(a B) piece_a[..., :, t],
    b = b0 + t, with c^(...) only where the tables hold a pre-scale and
    n_inv only where they hold one."""
    lead, w, strides = columns_layout(pieces, b0, tables)
    if all(p.device.type == "cpu" for p in pieces):
        return ntt_columns_plain(pieces, b0, tables)
    _check_cuda("ntt_columns", *pieces, *(t for t in tables if t is not None))
    A = len(pieces)
    out = torch.empty(lead + (NLIMBS, A, w), dtype=torch.int32, device=pieces[0].device)
    if out.numel() == 0:
        return out
    ptrs = (ctypes.c_void_p * A)(*(p.data_ptr() for p in pieces))
    words = (ctypes.c_int64 * (2 * A))(*(v for pair in strides for v in pair))

    def packed(t):
        return None if t is None else twiddle_words(t).data_ptr()

    fine_len = tables.fine.shape[-1]
    err = _entry("ntt_columns")(
        out.data_ptr(), ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(words, ctypes.c_void_p),
        A.bit_length() - 1, math.prod(lead), w.bit_length() - 1, b0,
        packed(tables.powers), packed(tables.coarse), packed(tables.fine),
        fine_len.bit_length() - 1, tables.coarse.shape[-1],
        packed(tables.rows), packed(tables.scale_coarse), packed(tables.scale_fine),
        None if tables.n_inv is None else tables.n_inv.data_ptr(), *_stream(pieces[0]),
    )
    _finish("ntt_columns", err)
    return out


# ---------------------------------------------------------------------------
# the AIR kernels (csrc/air.cu)
# ---------------------------------------------------------------------------

def air_rows(name: str, x: torch.Tensor, lead: Tuple[int, ...], k: Optional[int],
             n: int) -> Tuple[int, int, int]:
    """(sb, sk, sl) of an operand the AIR kernels take for a call over the
    batch ``lead`` (() or (B,)): an int32 tensor (k, 8, n), or (8, n) where
    k is None, with or without the lead axis in front (without: shared by
    the batch, sb = 0), its elements adjacent.  Element (b, k, j) has limb l
    at b sb + k sk + l sl + j.  Raises ValueError for any other operand."""
    tail = (NLIMBS, n) if k is None else (k, NLIMBS, n)
    extra = tuple(x.shape[: x.dim() - len(tail)])
    if (x.dtype != torch.int32 or x.dim() < len(tail) or tuple(x.shape[-len(tail):]) != tail
            or extra not in ((), lead) or (n > 1 and x.stride(-1) != 1)):
        want = f"{tail}" + (f" or {lead + tail}" if lead else "")
        raise ValueError(f"{name}: the kernel takes an int32 {want} tensor with adjacent elements; "
                         f"got {tuple(x.shape)} {x.dtype} with strides {x.stride()}")
    sb = x.stride(0) if extra and math.prod(lead) > 1 else 0
    return sb, (0 if k is None else x.stride(-3)), x.stride(-2)


def _air_launch(name: str, tensors, *args) -> None:
    """Launch an AIR kernel: ``tensors`` (the operands, for the device and
    stream checks), then the entry point's arguments less the stream."""
    _check_cuda(name, *tensors)
    _finish(name, _entry(name)(*args, *_stream(tensors[0])))


def _ptrs(xs) -> ctypes.Array:
    return (ctypes.c_void_p * len(xs))(*(x.data_ptr() for x in xs))


def _words(values) -> ctypes.Array:
    return (ctypes.c_int64 * len(values))(*values)


def quotients_layout(trace, interp, inv_bz, inv_tz, tables, shift: int, next_rows) -> list:
    """The (sb, sk, sl) of each operand of an H10 call, in the entry point's
    order (trace, next, interp, inv_bz, c1, c2, inv_tz): trace (..., 2, 8,
    n) with lead () or (B,), next_rows None or of trace's shape, interp and
    inv_bz (2, 8, n) or of trace's shape, c1 and c2 (2, 8, n), inv_tz
    (8, n), the MDS tables contiguous (2, 2, 8, 1), 0 <= shift < n.  Raises
    ValueError for any other call."""
    c1, c2, mds, mds_inv = tables
    if trace.dim() not in (3, 4):
        raise ValueError(f"rescue_quotients: the trace is (2, 8, n) or (B, 2, 8, n); got {tuple(trace.shape)}")
    lead, n = tuple(trace.shape[:-3]), trace.shape[-1]
    if not 0 <= shift < max(n, 1):
        raise ValueError(f"rescue_quotients: the shift must lie in [0, {n}); got {shift}")
    m = RESCUE_M
    strides = [air_rows("rescue_quotients: trace", trace, lead, m, n)]
    if next_rows is None:
        strides.append(strides[0])
    else:
        if tuple(next_rows.shape) != tuple(trace.shape):
            raise ValueError(f"rescue_quotients: next_rows must have the trace's shape {tuple(trace.shape)}; "
                             f"got {tuple(next_rows.shape)}")
        strides.append(air_rows("rescue_quotients: next_rows", next_rows, lead, m, n))
    strides += [air_rows(f"rescue_quotients: {label}", x, lead, m, n)
                for label, x in (("interp", interp), ("inv_bz", inv_bz))]
    strides += [air_rows(f"rescue_quotients: {label}", x, (), m, n) for label, x in (("c1", c1), ("c2", c2))]
    strides.append(air_rows("rescue_quotients: inv_tz", inv_tz, (), None, n))
    _check_table("rescue_quotients: mds", mds, (m, m, NLIMBS, 1))
    _check_table("rescue_quotients: mds_inv", mds_inv, (m, m, NLIMBS, 1))
    return strides


def rescue_quotients(trace: torch.Tensor, interp: torch.Tensor, inv_bz: torch.Tensor,
                     inv_tz: torch.Tensor, tables, shift: int = 0,
                     next_rows: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """H10: the boundary quotients and the Rescue AIR's transition quotients
    of trace codewords (..., 2, 8, n), in one launch (csrc/air.cu).
    ``tables`` is models/rescue_prime.py:rescue_air_tables's (c1, c2, mds,
    mds_inv).  The next cycle of point j is row (j + shift) mod n of
    ``next_rows``, or of the trace itself where next_rows is None (shift =
    the expansion factor: no rolled copy).  Returns contiguous (bq, tq):
        bq = (trace - interp) inv_bz,
        tq = AIR(trace, next; c1, c2, mds, mds_inv) inv_tz,
    both (..., 2, 8, n)."""
    strides = quotients_layout(trace, interp, inv_bz, inv_tz, tables, shift, next_rows)
    operands = [trace, trace if next_rows is None else next_rows, interp, inv_bz, *tables[:2], inv_tz]
    if all(x.device.type == "cpu" for x in (*operands, *tables[2:])):
        return rescue_quotients_plain(trace, interp, inv_bz, inv_tz, tables, shift, next_rows)
    bq = torch.empty(trace.shape, dtype=torch.int32, device=trace.device)
    tq = torch.empty_like(bq)
    if bq.numel() == 0:
        return bq, tq
    n = trace.shape[-1]
    _air_launch("rescue_quotients", operands + list(tables[2:]),
                bq.data_ptr(), tq.data_ptr(), _ptrs(operands), _words([v for t in strides for v in t]),
                tables[2].data_ptr(), tables[3].data_ptr(), trace.numel() // (RESCUE_M * NLIMBS * n),
                n, shift)
    return bq, tq


def combination_layout(rand, tq, bq, tq_shift, bq_shift, weights) -> list:
    """The (sb, sk, sl) of each operand of an H11 call, in the entry point's
    order: rand (8, n) or (B, 8, n); tq (..., C, 8, n) and bq (..., R, 8, n)
    with rand's lead; the shifts (C, 8, n) and (R, 8, n); weights (W, 8, 1)
    or (..., W, 8, 1), W = 1 + 2C + 2R.  Raises ValueError otherwise."""
    if rand.dim() not in (2, 3) or tq.dim() != rand.dim() + 1 or bq.dim() != rand.dim() + 1:
        raise ValueError(f"combination: rand (8, n) or (B, 8, n) with tq and bq one axis more; got "
                         f"{tuple(rand.shape)}, {tuple(tq.shape)}, {tuple(bq.shape)}")
    lead, n = tuple(rand.shape[:-2]), rand.shape[-1]
    C, R = tq.shape[-3], bq.shape[-3]
    return [air_rows("combination: rand", rand, lead, None, n),
            air_rows("combination: tq", tq, lead, C, n),
            air_rows("combination: bq", bq, lead, R, n),
            air_rows("combination: tq_shift", tq_shift, (), C, n),
            air_rows("combination: bq_shift", bq_shift, (), R, n),
            air_rows("combination: weights", weights, lead, 1 + 2 * C + 2 * R, 1)]


def combination(rand: torch.Tensor, tq: torch.Tensor, bq: torch.Tensor, tq_shift: torch.Tensor,
                bq_shift: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """H11: the weighted combination codeword (..., 8, n), FRI's input, in
    one launch (csrc/air.cu):
        w_0 rand + sum_s tq_s (w_{2s+1} + w_{2s+2} tq_shift_s)
                 + sum_r bq_r (w_{2C+2r+1} + w_{2C+2r+2} bq_shift_r),
    the weights in the transcript's order, shared (W, 8, 1) or one set a
    proof (..., W, 8, 1)."""
    strides = combination_layout(rand, tq, bq, tq_shift, bq_shift, weights)
    operands = [rand, tq, bq, tq_shift, bq_shift, weights]
    if all(x.device.type == "cpu" for x in operands):
        return combination_plain(rand, tq, bq, tq_shift, bq_shift, weights)
    out = torch.empty(rand.shape, dtype=torch.int32, device=rand.device)
    if out.numel() == 0:
        return out
    n = rand.shape[-1]
    _air_launch("combination", operands, out.data_ptr(), _ptrs(operands),
                _words([v for t in strides for v in t]), rand.numel() // (NLIMBS * n), n,
                tq.shape[-3], bq.shape[-3])
    return out


def verify_layout(vals, bz, ip, weights, idx, tables, tq_sh, bq_sh) -> int:
    """K of an H12 call: vals contiguous (8, 8K), bz and ip contiguous
    (2, 8, D), D >= 1, weights contiguous (9, 8, 1), idx contiguous int64
    (K,), c1 and c2 (2, 8, N), the MDS tables contiguous (2, 2, 8, 1), two
    transition and two boundary shift exponents in [0, 2^64).  Raises
    ValueError for any other call."""
    m = RESCUE_M
    if idx.dtype != torch.int64 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"verify_core: idx must be a contiguous int64 (K,) tensor; got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    K = idx.shape[0]
    _check_table("verify_core: vals", vals, (NLIMBS, (2 * m + 4) * K))
    for label, x in (("bz", bz), ("ip", ip)):
        if x.dim() != 3 or x.shape[-1] < 1:
            raise ValueError(f"verify_core: {label} must be ({m}, {NLIMBS}, D), D >= 1; got {tuple(x.shape)}")
        _check_table(f"verify_core: {label}", x, (m, NLIMBS, x.shape[-1]))
    _check_table("verify_core: weights", weights, (1 + 4 * m, NLIMBS, 1))
    c1, c2, mds, mds_inv = tables
    for label, x in (("c1", c1), ("c2", c2)):
        air_rows(f"verify_core: {label}", x, (), m, x.shape[-1])
    _check_table("verify_core: mds", mds, (m, m, NLIMBS, 1))
    _check_table("verify_core: mds_inv", mds_inv, (m, m, NLIMBS, 1))
    shifts = tuple(tq_sh) + tuple(bq_sh)
    if len(tq_sh) != m or len(bq_sh) != m or not all(0 <= e < 1 << 64 for e in shifts):
        raise ValueError(f"verify_core: {m} transition and {m} boundary shift exponents in [0, 2^64); "
                         f"got {tuple(tq_sh)} and {tuple(bq_sh)}")
    return K


def verify_core(vals: torch.Tensor, bz: torch.Tensor, ip: torch.Tensor, weights: torch.Tensor,
                idx: torch.Tensor, tables, tq_sh: Sequence[int], bq_sh: Sequence[int]) -> torch.Tensor:
    """H12: the verifier's combination values (8, K) at K query points of the
    Rescue AIR, in one launch (csrc/air.cu).  ``vals`` (8, 8K) holds, per
    register, the K current and K next opened boundary quotients, then
    the K randomizer and K transition-zerofier openings, the K points and
    the K next points; ``bz`` and ``ip`` the boundary zerofiers' and
    interpolants' coefficients (2, 8, D); ``idx`` the query indices into
    the round-constant codewords of ``tables`` (rescue_air_tables's);
    ``weights`` (9, 8, 1); the shifts the degree-adjusting exponents.  The
    values of protocols/fast_stark.py:_verify_core with the Rescue index
    evaluator, 1/0 taken as 0."""
    K = verify_layout(vals, bz, ip, weights, idx, tables, tq_sh, bq_sh)
    operands = [vals, bz, ip, weights, idx, *tables]
    if all(x.device.type == "cpu" for x in operands):
        return verify_core_plain(vals, bz, ip, weights, idx, tables, tq_sh, bq_sh)
    out = torch.empty((NLIMBS, K), dtype=torch.int32, device=vals.device)
    if K == 0:
        return out
    c1, c2 = tables[:2]
    _air_launch("verify_core", operands, out.data_ptr(), vals.data_ptr(), K, bz.data_ptr(),
                bz.shape[-1], ip.data_ptr(), ip.shape[-1], _ptrs([c1, c2]),
                _words([c1.stride(-3), c1.stride(-2), c2.stride(-3), c2.stride(-2)]), idx.data_ptr(),
                weights.data_ptr(), tables[2].data_ptr(), tables[3].data_ptr(),
                (ctypes.c_uint64 * 4)(*tq_sh, *bq_sh))
    return out


def mont_words(value: int) -> Tuple[int, int]:
    """(low, high) 64-bit halves of the Montgomery form of a field element."""
    m = value % P * R % P
    return m & ((1 << 64) - 1), m >> 64


TWO_INV = pow(2, P - 2, P)


def fold_layout(codeword: torch.Tensor, u: torch.Tensor) -> int:
    """h of a fold H6 takes: a contiguous int32 (8, 2h) codeword and a
    contiguous int32 (8, h) table, h >= 2.  Raises ValueError otherwise."""
    for name, x in (("codeword", codeword), ("u", u)):
        if x.dtype != torch.int32 or x.dim() != 2 or x.shape[0] != NLIMBS or not x.is_contiguous():
            raise ValueError(f"fri_fold: {name} must be a contiguous int32 ({NLIMBS}, n) tensor; "
                             f"got {tuple(x.shape)} {x.dtype}")
    h = u.shape[-1]
    if h < 2 or codeword.shape[-1] != 2 * h:
        raise ValueError(f"fri_fold: the codeword must hold 2h elements for a table of h >= 2; "
                         f"got {codeword.shape[-1]} and {h}")
    return h


def fri_fold(codeword: torch.Tensor, u: torch.Tensor, alpha: int):
    """H6: one FRI fold round.  ``codeword`` (8, 2h) and ``u`` (8, h), the
    inverse-domain table u_i = 1/(offset omega^i), in Montgomery form;
    ``alpha`` the round's challenge.  Returns (folded, canon, u2): the
    folded codeword c'_i = 2^-1 ((1 + alpha u_i) c_i + (1 - alpha u_i)
    c_{i+h}) in Montgomery form (8, h) and in canonical form (8, h), and
    the next round's table u2_i = u_i^2, i < h/2."""
    h = fold_layout(codeword, u)
    if codeword.device.type == "cpu" and u.device.type == "cpu":
        return fri_fold_plain(codeword, u, alpha)
    _check_cuda("fri_fold", codeword, u)
    folded = torch.empty_like(u)
    canon = torch.empty_like(u)
    u2 = torch.empty((NLIMBS, h // 2), dtype=torch.int32, device=u.device)
    err = _entry("fri_fold")(
        folded.data_ptr(), canon.data_ptr(), u2.data_ptr(), codeword.data_ptr(), u.data_ptr(),
        h, *mont_words(alpha), *mont_words(TWO_INV), *_stream(u),
    )
    _finish("fri_fold", err)
    return folded, canon, u2


def fold_batched_layout(codeword: torch.Tensor, u: torch.Tensor, alphas: torch.Tensor) -> int:
    """h of a batched fold H7 takes: a contiguous int32 (B, 8, 2h) codeword,
    a contiguous int32 (8, h) table, h >= 2, and contiguous int32 (B, 8, 1)
    challenges, 1 <= B <= 65535.  Raises ValueError otherwise."""
    if (codeword.dtype != torch.int32 or codeword.dim() != 3 or codeword.shape[1] != NLIMBS
            or not codeword.is_contiguous()):
        raise ValueError(f"fri_fold_batched: codeword must be a contiguous int32 (B, {NLIMBS}, 2h) "
                         f"tensor; got {tuple(codeword.shape)} {codeword.dtype}")
    batch = codeword.shape[0]
    if not 1 <= batch <= 65535:
        raise ValueError(f"fri_fold_batched: the kernel takes 1 <= B <= 65535 codewords; got {batch}")
    if (alphas.dtype != torch.int32 or tuple(alphas.shape) != (batch, NLIMBS, 1)
            or not alphas.is_contiguous()):
        raise ValueError(f"fri_fold_batched: alphas must be a contiguous int32 ({batch}, {NLIMBS}, 1) "
                         f"tensor; got {tuple(alphas.shape)} {alphas.dtype}")
    return fold_layout(codeword[0], u)


def fri_fold_batched(codeword: torch.Tensor, u: torch.Tensor, alphas: torch.Tensor):
    """H7: one FRI fold round of B codewords.  ``codeword`` (B, 8, 2h) and
    ``u`` (8, h), the shared inverse-domain table, in Montgomery form;
    ``alphas`` (B, 8, 1) the proofs' challenges in Montgomery form.
    Returns (folded, canon, u2): the folded codewords in Montgomery form
    (B, 8, h) and in canonical form (B, 8, h), and the next round's table
    u2_i = u_i^2, i < h/2."""
    h = fold_batched_layout(codeword, u, alphas)
    if all(x.device.type == "cpu" for x in (codeword, u, alphas)):
        return fri_fold_batched_plain(codeword, u, alphas)
    _check_cuda("fri_fold_batched", codeword, u, alphas)
    batch = codeword.shape[0]
    folded = torch.empty((batch, NLIMBS, h), dtype=torch.int32, device=u.device)
    canon = torch.empty_like(folded)
    u2 = torch.empty((NLIMBS, h // 2), dtype=torch.int32, device=u.device)
    err = _entry("fri_fold_batched")(
        folded.data_ptr(), canon.data_ptr(), u2.data_ptr(), codeword.data_ptr(), u.data_ptr(),
        alphas.data_ptr(), batch, h, *mont_words(TWO_INV), *_stream(u),
    )
    _finish("fri_fold_batched", err)
    return folded, canon, u2


SAMPLE_BYTES = 17       # a randomness draw: Field.sample's bytes, big-endian
R2 = R * R % P          # H13's factor to Montgomery form: x * R2 * R^-1 = x R


def sample_layout(raw: torch.Tensor) -> int:
    """n of the draws H13 takes: a contiguous uint8 (n, SAMPLE_BYTES)
    tensor.  Raises ValueError otherwise."""
    if (raw.dtype != torch.uint8 or raw.dim() != 2 or raw.shape[1] != SAMPLE_BYTES
            or not raw.is_contiguous()):
        raise ValueError(f"sample_mont: the kernel takes a contiguous uint8 (n, {SAMPLE_BYTES}) "
                         f"tensor; got {tuple(raw.shape)} {raw.dtype}")
    return raw.shape[0]


def sample_mont(raw: torch.Tensor) -> torch.Tensor:
    """H13: n randomness draws, each row of ``raw`` (n, 17) read as a
    big-endian integer (Field.sample), as the contiguous (8, n) Montgomery
    limbs of their values mod p, bit for bit ``device_from_ints`` of them."""
    n = sample_layout(raw)
    if raw.device.type == "cpu":
        return sample_mont_plain(raw)
    _check_cuda("sample_mont", raw)
    out = torch.empty((NLIMBS, n), dtype=torch.int32, device=raw.device)
    if n == 0:
        return out
    err = _entry("sample_mont")(out.data_ptr(), raw.data_ptr(), n, R2 & ((1 << 64) - 1), R2 >> 64,
                                *_stream(raw))
    _finish("sample_mont", err)
    return out


# ---------------------------------------------------------------------------
# plain PyTorch versions (any device, any broadcastable shapes)
# ---------------------------------------------------------------------------

_CONSTS: Dict[tuple, torch.Tensor] = {}


def _limb_col(value: int, device: torch.device) -> torch.Tensor:
    key = (value, device)
    if key not in _CONSTS:
        _CONSTS[key] = torch.tensor(
            int_to_limbs(value), dtype=torch.int64, device=device
        ).view(NLIMBS, 1)
    return _CONSTS[key]


def _cols(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Column sums of the limb product x*y, not carried: (..., 15, n) with
    column k = sum_{i+j=k} x_i * y_j.  Row i of the (8, 8) product table
    is sheared right by i (pad, flatten, drop the tail, refold), so one sum
    over rows gives every column."""
    prod = x.unsqueeze(-2) * y.unsqueeze(-3)                     # (..., 8, 8, n)
    wide = torch.nn.functional.pad(prod, (0, 0, 0, NLIMBS))      # (..., 8, 16, n)
    lead, n = wide.shape[:-3], wide.shape[-1]
    flat = wide.reshape(lead + (2 * NLIMBS * NLIMBS, n))
    flat = flat[..., : NLIMBS * (2 * NLIMBS - 1), :]
    return flat.reshape(lead + (NLIMBS, 2 * NLIMBS - 1, n)).sum(-3)


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of H0 in int64: U = T + m*p with T = a*b and
    m = T*(-p^-1) mod 2^128, result U / 2^128 less p once if needed.
    Columns stay uncarried until a carry is needed: a column of T holds at
    most 8 products < 2^32, one of T*N' at most 8 products < 2^51."""
    a, b = torch.broadcast_tensors(a, b)
    dev = a.device
    t = _cols(a.long(), b.long())                                # T, (..., 15, n)
    m_cols = _cols(t[..., :NLIMBS, :], _limb_col(NPRIME, dev))[..., :NLIMBS, :]
    m_rows, _ = carry_rows(list(m_cols.unbind(-2)))              # m mod 2^128
    u = t + _cols(torch.stack(m_rows, -2), _limb_col(P, dev))
    u_rows, carry = carry_rows(list(u.unbind(-2)))
    r = u_rows[NLIMBS:] + [carry & MASK]                         # U >> 128
    out = cond_sub_p_rows(r, carry >> LIMB_BITS)
    return torch.stack(out, -2).to(torch.int32)


def mont_pow_plain(x: torch.Tensor, exponent: int) -> torch.Tensor:
    """Plain version of the ladder: left-to-right square and multiply over
    ``mont_mul_plain``, from the top bit down (the JAX scan's order)."""
    exponent_words(exponent)
    if exponent == 0:
        return _limb_col(R, x.device).to(torch.int32).expand(x.shape).clone()
    acc = x.clone()
    for bit in bin(exponent)[3:]:
        acc = mont_mul_plain(acc, acc)
        if bit == "1":
            acc = mont_mul_plain(acc, x)
    return acc


def add_mod_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of H1's add (field/limb_arith.py:add_mod_rows)."""
    a, b = torch.broadcast_tensors(a, b)
    out = add_mod_rows(list(a.long().unbind(-2)), list(b.long().unbind(-2)))
    return torch.stack(out, -2).to(torch.int32)


def sub_mod_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of H1's subtract (field/limb_arith.py:sub_mod_rows)."""
    a, b = torch.broadcast_tensors(a, b)
    out = sub_mod_rows(list(a.long().unbind(-2)), list(b.long().unbind(-2)))
    return torch.stack(out, -2).to(torch.int32)


def _mds_plain(state: torch.Tensor, mds: torch.Tensor) -> torch.Tensor:
    """(..., m, 8, n) states times the (m, m, 8, 1) MDS matrix."""
    rows = []
    for i in range(RESCUE_M):
        acc = mont_mul_plain(state[..., 0, :, :], mds[i, 0])
        for j in range(1, RESCUE_M):
            acc = add_mod_plain(acc, mont_mul_plain(state[..., j, :, :], mds[i, j]))
        rows.append(acc)
    return torch.stack(rows, dim=-3)


def rescue_permutation_plain(state: torch.Tensor, rc: torch.Tensor, mds: torch.Tensor,
                             alpha_inv: int, collect_trace: bool) -> torch.Tensor:
    """Plain version of H2: the rounds of the JAX scan
    (stark_anatomy_tpu/models/rescue_prime.py:_permutation_scan) over the
    plain field functions, x^(1/3) by ALPHA_INV_CHAIN."""
    _check_alpha_inv(alpha_inv)
    states = [state]
    for r in range(rc.shape[0]):
        # forward half-round: x^3, MDS, constants
        state = mont_mul_plain(mont_mul_plain(state, state), state)
        state = add_mod_plain(_mds_plain(state, mds), rc[r, 0])
        # backward half-round: x^(1/3) = x^ALPHA_INV, MDS, constants
        state = run_chain(state, mont_mul_plain)
        state = add_mod_plain(_mds_plain(state, mds), rc[r, 1])
        states.append(state)
    return torch.stack(states) if collect_trace else state


_BITREV: Dict[tuple, torch.Tensor] = {}


def _bitrev(n: int, device: torch.device) -> torch.Tensor:
    """Index array of the bit-reversal permutation of range(n)."""
    key = (n, device)
    if key not in _BITREV:
        bits = n.bit_length() - 1
        idx = torch.arange(n, device=device)
        rev = torch.zeros_like(idx)
        for b in range(bits):
            rev |= ((idx >> b) & 1) << (bits - 1 - b)
        _BITREV[key] = rev
    return _BITREV[key]


def ntt_plain(values: torch.Tensor, powers: torch.Tensor, n_inv: Optional[torch.Tensor] = None,
              scale_pre: Optional[torch.Tensor] = None,
              scale_post: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of H3: iterative radix-2 Cooley-Tukey over bit-reversed
    input.  Each stage gathers the even and odd halves of every butterfly
    block, t = v * w^(j n/(2m)), then u + t and u - t, interleaved back."""
    n = values.shape[-1]
    x = values if scale_pre is None else mont_mul_plain(values, scale_pre)
    if n > 1:
        lead = x.shape[:-2]
        batch = math.prod(lead)
        x = x.index_select(-1, _bitrev(n, x.device)).reshape(batch, NLIMBS, n)
        j = torch.arange(n // 2, device=x.device)
        m = 1
        while m < n:
            w = powers.index_select(-1, (j % m) * (n // (2 * m)))
            blocks = n // (2 * m)
            x5 = x.view(batch, NLIMBS, blocks, 2, m)
            u = x5[:, :, :, 0, :].reshape(batch, NLIMBS, n // 2)
            v = x5[:, :, :, 1, :].reshape(batch, NLIMBS, n // 2)
            t = mont_mul_plain(v, w)
            lo = add_mod_plain(u, t).view(batch, NLIMBS, blocks, 1, m)
            hi = sub_mod_plain(u, t).view(batch, NLIMBS, blocks, 1, m)
            x = torch.cat([lo, hi], dim=3).view(batch, NLIMBS, n)
            m *= 2
        x = x.reshape(lead + (NLIMBS, n))
    if n_inv is not None:
        x = mont_mul_plain(x, n_inv)
    if scale_post is not None:
        x = mont_mul_plain(x, scale_post)
    return x


def ntt_tiled_plain(values: torch.Tensor, step: int, n1: int, powers: torch.Tensor,
                    twiddles: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    n_inv: Optional[torch.Tensor] = None,
                    scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of H8's steps (``ntt_tiled``): the four-step glue the
    port ran before H8, a transpose to rows, ``ntt_plain`` over them and a
    transpose back, with the twiddle w_n^(j1 k2) = w_n^(n2 (e / n2))
    w_n^(e mod n2), e = j1 k2, from the two tables; TILED_ROWS points of
    rows at a time, so that the card holds its temporaries at 2^24."""
    batch, n, n2 = tiled_layout(values, step, n1)
    lead, dev = values.shape[:-2], values.device
    scale = None if scale is None else scale.reshape(-1, NLIMBS, n)    # (1 or batch, 8, n)
    if step == 0:
        coarse, fine = twiddles
        lg2 = n2.bit_length() - 1
        x = values.view(batch, NLIMBS, n2, n1)
        out = torch.empty((batch, n2, n1, 4), dtype=torch.int32, device=dev)
        width = max(1, TILED_ROWS // n2)
        for b in range(batch):
            pre = None if scale is None else scale[b % scale.shape[0]].view(NLIMBS, n2, n1)
            for c in range(0, n1, width):
                e = torch.arange(c, min(c + width, n1), device=dev).view(-1, 1) * torch.arange(n2, device=dev)
                tw = mont_mul_plain(coarse[:, e >> lg2].transpose(0, 1), fine[:, e & (n2 - 1)].transpose(0, 1))
                rows = x[b, :, :, c:c + width].permute(2, 0, 1)                # [j1][l][j2]
                p = None if pre is None else pre[:, :, c:c + width].permute(2, 0, 1)
                y = ntt_plain(rows, powers, None, p, tw)                        # [j1][l][k2]
                out[b, :, c:c + width] = pack_words(y).transpose(0, 1)          # [k2][j1][w]
        return out.view(lead + (n, 4))
    y = values.view(batch, n2, n1, 4)
    out = torch.empty((batch, NLIMBS, n1, n2), dtype=torch.int32, device=dev)
    height = max(1, TILED_ROWS // n1)
    for b in range(batch):
        post = None if scale is None else scale[b % scale.shape[0]].view(NLIMBS, n1, n2)
        for r in range(0, n2, height):
            p = None if post is None else post[:, :, r:r + height].permute(2, 0, 1)
            z = ntt_plain(unpack_words(y[b, r:r + height]), powers, n_inv, None, p)   # [k2][l][k1]
            out[b, :, :, r:r + height] = z.permute(1, 2, 0)
    return out.view(lead + (NLIMBS, n))


def ntt_columns_plain(pieces: Sequence[torch.Tensor], b0: int, tables: ColumnTables) -> torch.Tensor:
    """Plain version of H9 (``ntt_columns``): the pieces stacked, the
    pre-scale c^(a B) c^b, ``ntt_plain`` over the A points with 1/A, and
    the twiddle r^(k b) as the powers of r^b = coarse[b / F] fine[b mod F]."""
    _, w, _ = columns_layout(pieces, b0, tables)
    A, dev = len(pieces), pieces[0].device
    b = b0 + torch.arange(w, device=dev)

    def power(coarse, fine):                                   # base^b, (8, w)
        f = fine.shape[-1]
        return mont_mul_plain(coarse[:, b >> (f.bit_length() - 1)], fine[:, b & (f - 1)])

    x = torch.stack(list(pieces), dim=-3)                      # (..., A, 8, w)
    if tables.rows is not None:
        x = mont_mul_plain(x, tables.rows.transpose(0, 1).unsqueeze(-1))          # c^(a B)
        x = mont_mul_plain(x, power(tables.scale_coarse, tables.scale_fine))      # c^b
    y = ntt_plain(x.transpose(-3, -1), tables.powers, tables.n_inv).transpose(-3, -1)
    u = power(tables.coarse, tables.fine)
    tw = [_limb_col(R, dev).to(torch.int32).expand(NLIMBS, w)]
    for _ in range(1, A):
        tw.append(u if len(tw) == 1 else mont_mul_plain(tw[-1], u))
    return mont_mul_plain(y, torch.stack(tw)).transpose(-3, -2).contiguous()


def _fold_plain(codeword: torch.Tensor, u: torch.Tensor, alpha_m: torch.Tensor):
    """The fold of H6 and H7 over the plain field functions, in the JAX
    package's order (_fold_kernel, _fold_kernel_batched), the canonical
    form (a product with 1) and _square_half; ``alpha_m`` is (8, 1) or
    (B, 8, 1) in Montgomery form."""
    h = u.shape[-1]
    a, b = codeword[..., :h], codeword[..., h:]
    two_inv = _limb_col(TWO_INV * R % P, u.device).to(torch.int32)
    d = mont_mul_plain(mont_mul_plain(alpha_m, u), sub_mod_plain(a, b))
    folded = mont_mul_plain(two_inv, add_mod_plain(add_mod_plain(a, b), d))
    canon = mont_mul_plain(folded, _limb_col(1, u.device).to(torch.int32))
    u2 = mont_mul_plain(u[:, : h // 2], u[:, : h // 2])
    return folded, canon, u2


def fri_fold_plain(codeword: torch.Tensor, u: torch.Tensor, alpha: int):
    """Plain version of H6."""
    fold_layout(codeword, u)
    return _fold_plain(codeword, u, _limb_col(alpha % P * R % P, u.device).to(torch.int32))


def fri_fold_batched_plain(codeword: torch.Tensor, u: torch.Tensor, alphas: torch.Tensor):
    """Plain version of H7."""
    fold_batched_layout(codeword, u, alphas)
    return _fold_plain(codeword, u, alphas)


def rescue_air_plain(cur: torch.Tensor, nxt: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
                     mds: torch.Tensor, mds_inv: torch.Tensor) -> torch.Tensor:
    """The Rescue AIR's constraints (..., 2, 8, n) over the plain field
    functions, the glue of models/rescue_prime.py:_rescue_air_kernel:
    [sum_k MDS[i][k] cur_k^3 + c1_i] - [sum_k MDSinv[i][k] (nxt_k - c2_k)]^3."""
    cube = mont_mul_plain(mont_mul_plain(cur, cur), cur)
    inner = sub_mod_plain(nxt, c2)
    outs = []
    for i in range(RESCUE_M):
        lhs = mont_mul_plain(cube[..., 0, :, :], mds[i, 0])
        rhs = mont_mul_plain(inner[..., 0, :, :], mds_inv[i, 0])
        for k in range(1, RESCUE_M):
            lhs = add_mod_plain(lhs, mont_mul_plain(cube[..., k, :, :], mds[i, k]))
            rhs = add_mod_plain(rhs, mont_mul_plain(inner[..., k, :, :], mds_inv[i, k]))
        lhs = add_mod_plain(lhs, c1[..., i, :, :])
        outs.append(sub_mod_plain(lhs, mont_mul_plain(mont_mul_plain(rhs, rhs), rhs)))
    return torch.stack(outs, dim=-3)


def rescue_quotients_plain(trace: torch.Tensor, interp: torch.Tensor, inv_bz: torch.Tensor,
                           inv_tz: torch.Tensor, tables, shift: int = 0,
                           next_rows: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of H10: the glue the port ran before it (the boundary
    quotient, the rolled trace, the AIR and the quotient by inv_tz, as the
    JAX package's _bq_core and _air_quotient_fn) over the plain field
    functions."""
    quotients_layout(trace, interp, inv_bz, inv_tz, tables, shift, next_rows)
    c1, c2, mds, mds_inv = tables
    nxt = trace if next_rows is None else next_rows
    if shift:
        nxt = torch.roll(nxt, -shift, dims=-1)
    bq = mont_mul_plain(sub_mod_plain(trace, interp), inv_bz)
    tq = mont_mul_plain(rescue_air_plain(trace, nxt, c1, c2, mds, mds_inv), inv_tz)
    return bq, tq


def combination_plain(rand: torch.Tensor, tq: torch.Tensor, bq: torch.Tensor, tq_shift: torch.Tensor,
                      bq_shift: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Plain version of H11: the glue the port ran before it (the JAX
    package's fast_stark.py:_combination_core) over the plain field
    functions, a proof's weights broadcast over its row."""
    combination_layout(rand, tq, bq, tq_shift, bq_shift, weights)

    def w(k):                                              # (8, 1) or (B, 8, 1)
        return weights[..., k, :, :]

    acc = mont_mul_plain(rand, w(0))
    k = 1
    for q, shift in ((tq, tq_shift), (bq, bq_shift)):
        for s in range(q.shape[-3]):
            ws = add_mod_plain(w(k), mont_mul_plain(w(k + 1), shift[s]))
            acc = add_mod_plain(acc, mont_mul_plain(q[..., s, :, :], ws))
            k += 2
    return acc


def horner_plain(coeffs: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """coeffs (..., 8, D), low degree first, at points (..., 8, n), by
    Horner over the plain field functions (ops/ntt.py:
    evaluate_domain_horner's steps)."""
    acc = torch.zeros(torch.broadcast_shapes(coeffs.shape[:-1] + (1,), points.shape),
                      dtype=torch.int32, device=points.device)
    for d in range(coeffs.shape[-1] - 1, -1, -1):
        acc = add_mod_plain(mont_mul_plain(acc, points), coeffs[..., d:d + 1])
    return acc


def verify_core_plain(vals: torch.Tensor, bz: torch.Tensor, ip: torch.Tensor, weights: torch.Tensor,
                      idx: torch.Tensor, tables, tq_sh: Sequence[int], bq_sh: Sequence[int]) -> torch.Tensor:
    """Plain version of H12: protocols/fast_stark.py:_verify_core's glue with
    the Rescue index evaluator, over the plain field functions; 1/tz by the
    ladder (mont_pow_plain to p - 2, 0 giving 0)."""
    K = verify_layout(vals, bz, ip, weights, idx, tables, tq_sh, bq_sh)
    c1, c2, mds, mds_inv = tables
    m = RESCUE_M
    parts = [vals[..., i * K:(i + 1) * K] for i in range(2 * m + 4)]
    bq_cur, bq_next = torch.stack(parts[0:2 * m:2]), torch.stack(parts[1:2 * m:2])
    rand, tz, x, xn = parts[2 * m:]
    cur = add_mod_plain(mont_mul_plain(bq_cur, horner_plain(bz, x)), horner_plain(ip, x))
    nxt = add_mod_plain(mont_mul_plain(bq_next, horner_plain(bz, xn)), horner_plain(ip, xn))
    cons = rescue_air_plain(cur, nxt, c1.index_select(-1, idx), c2.index_select(-1, idx), mds, mds_inv)
    tq = mont_mul_plain(cons, mont_pow_plain(tz, P - 2))
    acc = mont_mul_plain(rand, weights[0])
    k = 1
    for q, exps in ((tq, tq_sh), (bq_cur, bq_sh)):
        for s, e in enumerate(exps):
            acc = add_mod_plain(acc, mont_mul_plain(q[s], weights[k]))
            shifted = mont_mul_plain(q[s], mont_pow_plain(x, e))
            acc = add_mod_plain(acc, mont_mul_plain(shifted, weights[k + 1]))
            k += 2
    return acc


def sample_mont_plain(raw: torch.Tensor) -> torch.Tensor:
    """Plain version of H13: the host route the batch prover took before
    it, each draw's bytes as a Python int mod p (Field.sample), then
    ``device_from_ints`` of the values onto ``raw``'s device."""
    from ..utils.convert import device_from_ints

    sample_layout(raw)
    data = raw.cpu().numpy().tobytes()
    values = [int.from_bytes(data[i:i + SAMPLE_BYTES], "big") % P
              for i in range(0, len(data), SAMPLE_BYTES)]
    return device_from_ints(values, raw.device)


PLAIN = {
    "mont_mul": mont_mul_plain, "mont_pow": mont_pow_plain,
    "add_mod": add_mod_plain, "sub_mod": sub_mod_plain,
    "rescue_perm": rescue_permutation_plain, "ntt": ntt_plain,
    "fri_fold": fri_fold_plain, "fri_fold_batched": fri_fold_batched_plain,
    "ntt_tiled": ntt_tiled_plain, "ntt_columns": ntt_columns_plain,
    "rescue_quotients": rescue_quotients_plain, "combination": combination_plain,
    "verify_core": verify_core_plain, "sample_mont": sample_mont_plain,
}
