"""The readings that the limits of ``correct`` are set from: one cell's
program, sound or with the control switched on, over several seeds in one
process (set-up once, then a window and the reference's judgement for
each seed), at the cell's own size and load.

    python3 portbench/control.py --workload <cell> --program sound|control \\
        --seconds <s> --seeds <n> [<n> ...]

The control is the program at the nearest guarantee below the one the
configuration states: half the colinearity checks, and so half the bits
of security (32 checks, 64 bits, for the configuration's 64 and 128).
The reference keeps the configuration's parameters, so each of the
control's proofs has to be rejected.  One JSON line is printed a seed.
The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_program(config: dict) -> dict:
    """The configuration's parameters with the control switched on."""
    return {"num_colinearity_checks": config["num_colinearity_checks"] // 2,
            "security_level": config["security_level"] // 2}


def readings(cell, program: str, seeds, seconds: float, device=None):
    """[(seed, checks, attempted)] of the cell's program over ``seeds``."""
    from portbench import harness as H

    overrides = control_program(cell.config) if program == "control" else None
    driver = H.driver_module(cell).Driver(cell, program=overrides, device=device)
    out = []
    try:
        driver.setup(seeds[0])
        for seed in seeds:
            win = driver.window(seed, seconds, False)
            out.append((seed, driver.judge(win, seed), driver.attempted(win)[0]))
    finally:
        driver.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program", choices=("sound", "control"), required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import harness as H

    cell = H.load_cell(args.workload)
    card = H.card_info()
    H.pin(H.card_cpus(card["pci"])[0], cell.traffic["torch_threads"])
    for seed, checks, attempted in readings(cell, args.program, args.seeds, args.seconds):
        print(json.dumps({"workload": args.workload, "program": args.program, "seed": seed,
                          "attempted": attempted, "correct": H.within(checks),
                          "checks": {k: v for k, (v, _) in checks.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
