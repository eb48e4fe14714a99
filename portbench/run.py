"""Run one cell of the port's benchmark on the card this process sees.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

In order: load the port, set up the cell's program and warm its shapes
(set-up, ``setup_s``), collect and freeze Python's garbage, measure for
``--seconds``, free the program, judge what the window produced against
the plain reference (``correct``), and print the result as the last line
of standard output: the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics from spans and a device trace with ``--trace 1``.
The numbers compared and their limits are the last lines of standard
error and the last key of the result.  Diagnostics go to standard error
before them.  The run exits with another code than 0, and prints no
result, without a CUDA card or with fewer than the cell asks for, and
where JAX or the JAX package is loaded when the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from portbench import harness as H

    cell = H.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        H.log(f"{args.workload} needs {cell.chips} CUDA card(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    card = H.card_info()
    cpus, note = H.card_cpus(card["pci"])
    threads = cell.traffic["torch_threads"]
    H.pin(cpus, threads)
    H.log(f"card: {card['name']}, power limit {card['power_limit']}, PCI {card['pci']}")
    H.log(f"host: os.cpu_count() {os.cpu_count()}; pinned to {len(cpus)} CPUs {cpus}, {note}; "
          f"torch threads {threads}")

    driver = H.driver_module(cell).Driver(cell)
    try:
        parts = driver.setup(args.seed)
        gc.collect()
        gc.freeze()
        setup_s = time.perf_counter() - T_START
        for name, seconds in parts:
            H.log(f"set-up, {name}: {seconds:.3f} s")
        H.log(f"set-up: {setup_s:.3f} s")
        win = driver.window(args.seed, args.seconds, bool(args.trace))
        memory = driver.memory_peak()
    finally:
        driver.close()

    for kind, reqs in win.requests.items():
        lat = sorted(b - a for a, b in reqs)
        if lat:
            H.log(f"window: {len(lat)} {kind} requests, seconds min {lat[0]:.4f}, median "
                  f"{H.median(lat):.4f}, max {lat[-1]:.4f}")
            fifth = (win.t1 - win.t0) / 5
            medians = [H.median([b - a for a, b in reqs if win.t0 + k * fifth <= a < win.t0 + (k + 1) * fifth])
                       for k in range(5)]
            H.log(f"window: {kind} median seconds in each fifth of the window: "
                  + ", ".join("-" if m is None else f"{m:.4f}" for m in medians))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": memory}
    metrics, extra = {}, {}
    wanted = cell.per_layer if args.trace else cell.end_to_end
    for m in wanted:
        if m["name"] == "setup_s":
            value = setup_s
        else:
            value = H.metric_reader(m["name"])(win)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if args.trace:
        device["busy_s"] = win.busy_seconds()
        device["window_s"] = win.t1 - win.t0
        extra["breakdown"] = H.breakdown(win)

    checks = driver.judge(win, args.seed)
    attempted, failed = driver.attempted(win)
    bad = H.forbidden_modules()
    if bad:
        H.log(f"the run holds modules it may not load: {', '.join(bad)}")
        return 3
    correct = H.within(checks)
    print(H.result_line(correct, attempted, failed, metrics, device, checks, extra), flush=True)
    for name, (value, limit) in checks.items():
        H.log(f"check {name}: {value} (limit {limit})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
