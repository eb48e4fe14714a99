"""The median milliseconds a round trip spends in the verifier's part
``verify.decode`` (protocols/fast_stark.py:FastStark.verify): the
signature's bytes read into the transcript's objects
(transcript/codec.py), about 100 kB a signature.  None where the program
opens no such part."""

from portbench import parts


def read(win):
    return parts.part_ms(win, "verify.decode")
