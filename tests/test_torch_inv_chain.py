"""The ladder's fixed chain for the Fermat inverse x^(p-2)
(field/kernels.py:INV_CHAIN, csrc/pow_chain.cuh:pow_inv), the wrapper's choice
between that chain and square-and-multiply, and the carry-flag PTX forms
of the Montgomery product and squaring the ladder runs on the card.

The CUDA kernel has no CPU mode; chip_smoke.py holds it against the plain
ladder on the card.  What the CPU can check:
* the list computes p - 2, and run through the plain product it equals
  the JAX package's ``inv`` on seeded inputs (0 and 1 among them);
* the kernel's written-out chain (the body of pow_inv, read from the
  source) is the list, step for step;
* ``pow_route``, a plain function, picks the chain for p - 2 only, and
  the C launcher's condition (read from the source) picks the same;
* the PTX of ``mont_mul_chain`` and ``mont_sqr_chain`` (read from the
  source and run instruction by instruction, carry flag included, on
  Python ints) equals a * b * 2^-128 mod p on special and seeded values.
Tolerance: zero (exact field arithmetic).
"""

import os
import random
import re

import numpy as np
import pytest
import torch

from stark_anatomy_tpu.field import ops as JF
from stark_anatomy_tpu.utils.convert import device_from_ints as jfrom
from stark_anatomy_tpu.utils.convert import ints_from_device as jints
from stark_anatomy_tpu_torch.field import kernels as K
from stark_anatomy_tpu_torch.field.limbs import R
from stark_anatomy_tpu_torch.field.scalar import P
from stark_anatomy_tpu_torch.utils.convert import device_from_ints as tfrom
from stark_anatomy_tpu_torch.utils.convert import ints_from_device as tints

torch.set_num_threads(1)

FIELD_CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "stark_anatomy_tpu_torch", "csrc", "field.cu")
R_INV = pow(R, P - 2, P)
M32 = (1 << 32) - 1
SPECIAL = [0, 1, 2, P - 1, P - 2, R % P, (P - 1) // 2, P - (1 << 96), (1 << 96) - 1,
           (1 << 127) - 1, 0xCB7FFFFF << 96]


@pytest.fixture(autouse=True)
def _no_aot(monkeypatch):
    monkeypatch.setenv("STARK_TPU_AOT", "0")


def source() -> str:
    """field.cu, the header that holds its power chains (pow_chain.cuh,
    which air.cu includes too) and the one that holds its carry-flag
    products (ntt_passes.cuh, which H8 includes too)."""
    text = ""
    for name in ("field.cu", "pow_chain.cuh", "ntt_passes.cuh"):
        with open(os.path.join(os.path.dirname(FIELD_CU), name)) as f:
            text += f.read()
    return text


def arith_source() -> str:
    with open(os.path.join(os.path.dirname(FIELD_CU), "field_arith.cuh")) as f:
        return f.read()


def test_inv_chain_computes_p_minus_2():
    assert K.run_chain(1, lambda a, b: a + b, K.INV_CHAIN) == P - 2
    squarings = sum(a == b for _, a, b in K.INV_CHAIN)
    assert (len(K.INV_CHAIN), squarings) == (154, 136)
    # every step reads values already made
    made = {"x"}
    for out, a, b in K.INV_CHAIN:
        assert a in made and b in made, (out, a, b)
        made.add(out)
    assert K.INV_CHAIN[-1][0] == "acc"


def test_inv_chain_on_ints_matches_fermat():
    rng = random.Random(12)
    for v in SPECIAL + [rng.randrange(P) for _ in range(20)]:
        got = K.run_chain(v * R % P, lambda a, b: a * b * R_INV % P, K.INV_CHAIN)
        assert got == pow(v, P - 2, P) * R % P


@pytest.mark.parametrize("seed", [0, 1])
def test_inv_chain_plain_matches_jax_inv(seed):
    rng = np.random.default_rng(seed)
    vals = [0, 1] + [int.from_bytes(rng.bytes(16), "little") % P for _ in range(30)]
    got = tints(K.run_chain(tfrom(vals, "cpu"), K.mont_mul_plain, K.INV_CHAIN))
    want = jints(JF.inv(jfrom(vals)))
    assert got == want
    assert got[0] == 0 and got[1] == 1


def pow_inv_steps(text: str) -> list:
    """The steps (out, a, b) of csrc/pow_chain.cuh:pow_inv, read from its body:
    mont_sqr_chain(a, r), mont_mul_chain(a, b, r), sqr_run(a, k, r) and
    one level of counted for loops."""
    start = text.index("void pow_inv(")
    body = text[text.index("{", start) + 1:]
    lines, depth = [], 1
    for line in body.splitlines():
        code = line.split("//")[0].strip()
        depth += code.count("{") - code.count("}")
        if depth == 0:
            break
        lines.append(code)
    stack = [[]]
    repeat = []
    for code in lines:
        loop = re.match(r"for \(int \w+ = 0; \w+ < (\d+); \+\+\w+\) \{$", code)
        if loop:
            repeat.append(int(loop.group(1)))
            stack.append([])
            continue
        if code == "}":
            steps = stack.pop()
            stack[-1].extend(steps * repeat.pop())
            continue
        if code.startswith("uint32_t") or code.startswith("#pragma") or not code:
            continue
        m = re.fullmatch(r"mont_sqr_chain\((\w+), (\w+)\);", code)
        if m:
            stack[-1].append((m.group(2), m.group(1), m.group(1)))
            continue
        m = re.fullmatch(r"mont_mul_chain\((\w+), (\w+), (\w+)\);", code)
        if m:
            stack[-1].append((m.group(3), m.group(1), m.group(2)))
            continue
        m = re.fullmatch(r"sqr_run\((\w+), (\d+), (\w+)\);", code)
        if m:
            a, k, r = m.group(1), int(m.group(2)), m.group(3)
            stack[-1].extend([(r, a, a)] + [(r, r, r)] * (k - 1))
            continue
        raise AssertionError(f"pow_inv: a statement the reader does not know: {code!r}")
    assert len(stack) == 1 and not repeat
    return stack[0]


def test_kernel_chain_is_the_list():
    assert pow_inv_steps(source()) == K.INV_CHAIN


ROUTES = [
    (P - 2, "inv_chain"), (P - 1, "ladder"), (P - 3, "ladder"), (0, "ladder"), (1, "ladder"),
    (201, "ladder"), (741, "ladder"), (K.ALPHA_INV, "ladder"), ((1 << 128) - 1, "ladder"),
]


@pytest.mark.parametrize("exponent,route", ROUTES)
def test_pow_route(exponent, route):
    assert K.pow_route(exponent) == route


def launcher_takes_chain(text: str, e_lo: int, e_hi: int, nbits: int) -> bool:
    """The condition by which csrc/field.cu:stark_mont_pow takes the fixed
    chain, read from its source and evaluated on the wrapper's words."""
    start = text.index("int stark_mont_pow(")
    cond = re.search(r"const bool inv = (.*?);", text[start:], re.S).group(1)
    k_p3 = int(re.search(r"constexpr uint32_t kP3 = (0x[0-9A-Fa-f]+)u;", arith_source()).group(1), 16)
    expr = (" ".join(cond.split()).replace("~uint64_t(0)", str((1 << 64) - 1))
            .replace("uint64_t(kP3)", str(k_p3)).replace("&&", "and"))
    assert re.fullmatch(r"[\w\s()=<>+\-]+", expr), expr
    return eval(expr, {}, {"e_lo": e_lo, "e_hi": e_hi, "nbits": nbits})


@pytest.mark.parametrize("exponent,route", ROUTES)
def test_launcher_takes_the_route_pow_route_names(exponent, route):
    """The C launcher picks the chain by the same rule as ``pow_route``,
    on the words the wrapper passes it."""
    assert launcher_takes_chain(source(), *K.exponent_words(exponent)) == (route == "inv_chain")


@pytest.mark.parametrize("exponent", [-1, 1 << 128])
def test_pow_route_refuses_out_of_range(exponent):
    with pytest.raises(ValueError):
        K.pow_route(exponent)


@pytest.mark.parametrize("shape", [(8, 1), (3, 8, 1), (8, 5)])
def test_mont_pow_on_the_cpu_is_the_plain_ladder(shape):
    """On a CPU tensor the wrapper runs the plain ladder whatever the
    route, and the ladder's x^(p-2) equals the chain's."""
    rng = random.Random(sum(shape))
    n = int(np.prod(shape)) // 8
    vals = ([0, 1] + [rng.randrange(P) for _ in range(n)])[:n]
    lead, width = shape[:-2], shape[-1]
    x = tfrom(vals, "cpu").T.reshape(lead + (width, 8)).transpose(-1, -2).contiguous()
    got = K.mont_pow(x, P - 2)
    assert torch.equal(got, K.mont_pow_plain(x, P - 2))
    assert torch.equal(got, K.run_chain(x, K.mont_mul_plain, K.INV_CHAIN))


# ---------------------------------------------------------------------------
# the carry-flag PTX forms, run instruction by instruction
# ---------------------------------------------------------------------------

def asm_text(text: str, function: str) -> str:
    """The PTX of ``function``'s asm statement, the reduction macro
    expanded, as one string."""
    macro_start = text.index("#define STARK_MONT_REDUCE_PTX")
    macro_lines = []
    for line in text[macro_start:].splitlines()[1:]:
        macro_lines.append(line)
        if not line.rstrip().endswith("\\"):
            break
    macro = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', "\n".join(macro_lines)))
    start = text.index(f"void {function}(")
    block = text[text.index("asm(", start):text.index(': "=r"', start)]
    block = block.replace("STARK_MONT_REDUCE_PTX", '"' + macro + '"')
    return "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', block)).replace("\\n", "\n").replace("\\t", " ")


def run_ptx(ptx: str, inputs: list) -> list:
    """Run the PTX on 32-bit inputs %4, %5, ...; returns outputs %0-%3."""
    regs = {f"%{4 + k}": v for k, v in enumerate(inputs)}
    cf = 0

    def val(x):
        x = x.strip()
        if x in regs:
            return regs[x]
        if re.fullmatch(r"(0x[0-9A-Fa-f]+|\d+)", x):
            return int(x, 0)
        raise KeyError(f"read before written: {x}")

    for ins in ptx.replace("{", ";").replace("}", ";").split(";"):
        ins = ins.strip()
        if not ins or ins.startswith(".reg"):
            continue
        op, args = ins.split(None, 1)
        args = [a.strip() for a in args.split(",")]
        parts = op.split(".")
        base, flags = parts[0], set(parts[1:])
        d = args[0]
        if base == "mul":
            prod = val(args[1]) * val(args[2])
            regs[d] = (prod >> 32) & M32 if "hi" in flags else prod & M32
        elif base in ("mad", "madc"):
            prod = val(args[1]) * val(args[2])
            part = (prod >> 32) & M32 if "hi" in flags else prod & M32
            s = part + val(args[3]) + (cf if base == "madc" else 0)
            regs[d] = s & M32
            if "cc" in flags:
                cf = s >> 32
        elif base in ("add", "addc"):
            s = val(args[1]) + val(args[2]) + (cf if base == "addc" else 0)
            regs[d] = s & M32
            if "cc" in flags:
                cf = s >> 32
        elif base in ("sub", "subc"):
            s = val(args[1]) - val(args[2]) - (cf if base == "subc" else 0)
            regs[d] = s & M32
            if "cc" in flags:
                cf = 1 if s < 0 else 0
        elif base == "setp":
            assert flags == {"lt", "s32"}, op
            signed = [v - (1 << 32) if v >> 31 else v for v in (val(args[1]), val(args[2]))]
            regs[d] = signed[0] < signed[1]
        elif base == "selp":
            regs[d] = val(args[1]) if regs[args[3]] else val(args[2])
        else:
            raise AssertionError(f"an instruction the simulator does not know: {ins}")
    return [regs[f"%{k}"] for k in range(4)]


def words(v: int) -> list:
    return [(v >> (32 * k)) & M32 for k in range(4)]


def from_words(w: list) -> int:
    return sum(x << (32 * k) for k, x in enumerate(w))


def ptx_cases(seed: int, count: int) -> list:
    rng = random.Random(seed)
    pairs = [(a, b) for a in SPECIAL for b in SPECIAL]
    return pairs + [(rng.randrange(P), rng.randrange(P)) for _ in range(count)]


@pytest.mark.parametrize("seed", [0, 1])
def test_mont_mul_chain_ptx(seed):
    ptx = asm_text(source(), "mont_mul_chain")
    for a, b in ptx_cases(seed, 400):
        got = from_words(run_ptx(ptx, words(a) + words(b)))
        assert got == a * b * R_INV % P, (a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_mont_sqr_chain_ptx(seed):
    ptx = asm_text(source(), "mont_sqr_chain")
    rng = random.Random(100 + seed)
    for a in SPECIAL + [rng.randrange(P) for _ in range(1600)]:
        got = from_words(run_ptx(ptx, words(a)))
        assert got == a * a * R_INV % P, a


def test_ptx_reader_sees_the_whole_reduction():
    """The two forms share the reduction text; the simulator must run it
    (a reading that dropped the macro would leave %0-%3 unwritten)."""
    text = source()
    mul, sqr = asm_text(text, "mont_mul_chain"), asm_text(text, "mont_sqr_chain")
    tail = asm_text(text, "mont_mul_chain")[mul.index("mul.lo.u32 c3"):]
    assert sqr.endswith(tail) and tail.count("selp.b32") == 4
    assert sum(ins.strip().startswith(("mul", "mad")) for ins in sqr.split(";")) == 20 + 9
