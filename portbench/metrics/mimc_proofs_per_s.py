"""Every proof of the window over the time from the window's start to the
end of its last proof, so that a proof cut off by the end of the window
does not quantize the rate."""


def read(win):
    proves = win.requests.get("prove")
    if not proves or not win.counts["proofs"]:
        return None
    return win.counts["proofs"] / (proves[-1][1] - win.t0)
