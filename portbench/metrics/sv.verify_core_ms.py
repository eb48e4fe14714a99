"""The median milliseconds a round trip spends in the verifier's part
``verify.core``: the boundary zerofiers and interpolants, the
combination at every query point (one upload, one launch of H12,
csrc/air.cu:verify_kernel, and one copy back, on the card) and the check
for trailing objects.  A forgery rejected before it opens none: its
round trip counts 0.  None where the program opens no such part."""

from portbench import parts


def read(win):
    return parts.part_ms(win, "verify.core")
