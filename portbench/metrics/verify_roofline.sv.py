"""H12 (csrc/air.cu, ``verify_kernel``: the verifier's combination at the
K = 2 x checks query points of one signature, one launch a verify that
reaches it) against its least time.  Bytes: the (2R + 4) K opened values
and points in and the K values out, 16 bytes an element.  Operations:
what one point's thread runs, counted from the kernel's body at the
instruction costs of PERF.md's kernel table (41 a product, 29 a squaring,
16 an add or subtract).  The operations bound it: each thread runs its
249 products in turn, so the card's latency, not its rate, sets the time,
and the share is far below 1%."""

from portbench import roofline
from portbench.reference.rescue_prime import boundary, params

KERNEL = "verify_kernel"
PRODUCT, SQUARING, ADD = 41, 29, 16
# the fixed chain of x^(p-2) (csrc/pow_chain.cuh:pow_inv)
INV_SQUARINGS, INV_PRODUCTS = 136, 18
# the Rescue AIR at a point for m = 2 (csrc/rescue_air.cuh:rescue_air):
# four cubes (a squaring and a product each), the eight MDS products,
# and ten adds or subtracts
AIR_SQUARINGS, AIR_PRODUCTS, AIR_ADDS = 4, 12, 10


def point_counts(config: dict):
    """(products, squarings, adds) of one query point's thread.  For each
    register, the trace value at x and at the next point: the boundary
    zerofier (dz coefficients) and interpolant (di) by Horner, a product
    and an add a step, then a product and an add; the AIR; 1/tz by the
    chain; the randomizer's weight; for each of the 2R quotients
    (each constraint's times 1/tz first) w_a q + w_b q x^e: three
    products, two adds and x^e by square and multiply."""
    p = params(config)
    registers = p.num_registers
    per_register = [sum(r == s for _, r, _ in boundary(config, 1)) for s in range(registers)]
    dz, di = max(per_register) + 1, max(max(per_register), 1)
    degree = p.randomized_trace_length - 1
    tq_bound = p.air_degree * degree - (p.trace_length - 1)
    max_degree = (1 << tq_bound.bit_length()) - 1
    shifts = [max_degree - tq_bound] * registers + [max_degree - (degree - n) for n in per_register]
    trace = 2 * registers * (dz + di + 1)
    products = trace + AIR_PRODUCTS + INV_PRODUCTS + 1 + registers + 3 * len(shifts)
    squarings = AIR_SQUARINGS + INV_SQUARINGS
    adds = trace + AIR_ADDS + 2 * len(shifts)
    for e in shifts:
        squarings += e.bit_length() - 1
        products += bin(e).count("1") - 1
    return products, squarings, adds


def least_seconds(config: dict) -> float:
    """One launch at the configuration's K points."""
    points = 2 * config["num_colinearity_checks"]
    products, squarings, adds = point_counts(config)
    nbytes = (2 * config["state_width"] + 5) * points * roofline.ELEMENT_BYTES
    instructions = products * PRODUCT + squarings * SQUARING + adds * ADD
    return roofline.least_seconds(nbytes, points * instructions)


def read(win):
    if not win.traced:
        return None
    launches = [(a, b) for name, a, b in win.ops if KERNEL in name]
    device_s = sum(b - a for a, b in launches)
    return roofline.share(len(launches) * least_seconds(win.config), device_s)
