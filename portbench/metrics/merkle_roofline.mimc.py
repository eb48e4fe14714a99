"""The device commitments (``commit_bq`` and ``commit_randomizer``:
commit/device_merkle.py's canonical form and H4 tree of one FRI-domain
codeword each) against their least time: the blake2s compressions at the
card's issue rate, or the codeword's bytes, whichever is longer (the
window's proves)."""

from portbench import roofline
from portbench.reference.stark import Params


def read(win):
    if not win.traced:
        return None
    params = Params.of(win.config, 1, win.config["steps"] + 1)
    count, device_s = win.device_seconds({"phase.commit_bq", "phase.commit_randomizer"})
    return roofline.share(count * roofline.merkle_commit_seconds(params.fri_length), device_s)
