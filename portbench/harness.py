"""What every cell shares: finding a cell's files by name, placing the run
on the card's own CPUs, the spans and the device trace, the metric
readers, and the result line.

A cell is an entry of BENCHMARK.json's ``workloads``.  Its configuration
is the file that the entry's ``configs`` names, its traffic mix the file
``traffic/<traffic>.json``, whose ``driver`` names the module under
``drivers/`` that runs it, and each of its metrics the reader
``metrics/<metric>.py``.  Nothing here knows a cell, a configuration or a
metric by name: a later cell, mix or metric is a new file and a new entry.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
# whole top-level module names that no run may hold once its window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "stark_anatomy_tpu")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# the cell
# ---------------------------------------------------------------------------

@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str) -> Cell:
    """The cell ``name`` of BENCHMARK.json, with its configuration, traffic
    and metrics; KeyError for an unknown name."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    work = {w["name"]: w for w in bench["workloads"]}[name]
    entry = {c["name"]: c for c in bench["configs"]}[work["config"]]
    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", work["traffic"] + ".json")) as f:
        traffic = json.load(f)
    end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name, work["chips"], config, traffic, end_to_end, per_layer)


def driver_module(cell: Cell):
    """The module under drivers/ that runs the cell's traffic."""
    return importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")


def metric_reader(name: str):
    """``read(window)`` of metrics/<name>.py."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def seeded_bytes(*label):
    """An os.urandom stand-in: the blake2b counter stream of ``label``, so
    that a seed gives the same inputs and the same prover randomness."""
    import hashlib

    key = repr(label).encode()
    state = {"ctr": 0}

    def draw(n: int) -> bytes:
        out = b""
        while len(out) < n:
            out += hashlib.blake2b(key + state["ctr"].to_bytes(8, "big")).digest()
            state["ctr"] += 1
        return out[:n]

    return draw


# ---------------------------------------------------------------------------
# the host: the card's CPUs, a fixed number of threads
# ---------------------------------------------------------------------------

def card_info() -> Dict[str, str]:
    """The first card's name and power limit (nvidia-smi) and its PCI
    address (torch's properties of the device)."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()[0]
    name, limit = (part.strip() for part in out.rsplit(",", 1))
    props = torch.cuda.get_device_properties(0)
    pci = f"{props.pci_domain_id:04x}:{props.pci_bus_id:02x}:{props.pci_device_id:02x}.0"
    return {"name": name, "power_limit": limit, "pci": pci}


def card_cpus(pci: str) -> Tuple[List[int], str]:
    """The CPUs local to the card (its PCI device's local_cpulist in sysfs)
    that this process may use, and a note where sysfs gives no list and
    the allowed set is kept."""
    allowed = sorted(os.sched_getaffinity(0))
    path = f"/sys/bus/pci/devices/{pci}/local_cpulist"
    try:
        with open(path) as f:
            text = f.read().strip()
    except OSError:
        return allowed, f"no {path}: kept the allowed CPUs"
    local = set()
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        local.update(range(int(lo), int(hi or lo) + 1))
    cpus = sorted(local & set(allowed))
    if not cpus:
        return allowed, f"{path} lists {text}, none of them allowed: kept the allowed CPUs"
    return cpus, f"local to the card ({path}: {text})"


def pin(cpus: List[int], threads: int) -> None:
    """Place this process on ``cpus`` with ``threads`` intra-op threads."""
    import torch

    os.sched_setaffinity(0, cpus)
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# spans and the device trace
# ---------------------------------------------------------------------------

def _port_phase_timer():
    from stark_anatomy_tpu_torch.utils.profiling import PhaseTimer

    return PhaseTimer


class SpanTimer(_port_phase_timer()):
    """The port's PhaseTimer that also keeps each phase as a span (name,
    start, end) on the host's perf_counter clock, and marks it in a device
    trace; ``span`` records the harness's own spans (a request) the same
    way.  Spans are kept only while ``recording``."""

    def __init__(self):
        super().__init__()
        self.spans: List[Tuple[str, float, float]] = []
        self.recording = False
        self.tracing = False

    @contextlib.contextmanager
    def span(self, name: str):
        mark = contextlib.nullcontext()
        if self.tracing:
            from torch.profiler import record_function

            mark = record_function(name)
        with mark:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if self.recording:
                    self.spans.append((name, t0, time.perf_counter()))

    @contextlib.contextmanager
    def phase(self, name: str):
        with self.span("phase." + name), super().phase(name):
            yield


SPAN_PREFIXES = ("phase.", "bench.", "portbench.")


class DeviceTrace:
    """torch.profiler over a window, its device operations as (name, start,
    end) on the perf_counter clock: a marker span stamps both clocks."""

    MARK = "portbench.clock"

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.ops: List[Tuple[str, float, float]] = []
        self._prof = None

    def __enter__(self):
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile, record_function

            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._prof.__enter__()
            with record_function(self.MARK):
                self._mark = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        import torch

        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.ops = self._device_ops()
        self._prof = None
        return False

    def _device_ops(self):
        from torch.autograd import DeviceType

        raw, mark = [], None
        for e in self._prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                # the spans' marks come back as device-side annotations too:
                # they are not operations
                if not e.is_user_annotation() and not name.startswith(SPAN_PREFIXES):
                    raw.append((name, e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9))
            elif mark is None and name == self.MARK:
                mark = e.start_ns() * 1e-9
        if mark is None:
            raise RuntimeError("the device trace lost its clock marker")
        shift = self._mark - mark
        return sorted((name, a + shift, b + shift) for name, a, b in raw)


def merge(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of intervals, clipped to [lo, hi], as sorted disjoint
    intervals."""
    out: List[List[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap(intervals, lo: float, hi: float) -> float:
    """Seconds of the intervals that lie in [lo, hi] (summed, not merged)."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in intervals)


# ---------------------------------------------------------------------------
# a measured window, as the metric readers see it
# ---------------------------------------------------------------------------

@dataclass
class Window:
    """What a window did.  ``requests`` maps a kind of request to the
    (start, end) of each one completed in the window; ``spans`` are
    (name, start, end), the port's phases as ``phase.<name>``;
    ``ops`` the run's device operations (name, start, end) and ``busy``
    their intervals, in a traced run; ``counts`` holds what a driver
    counts beyond its requests."""

    t0: float
    t1: float
    config: dict
    traffic: dict
    traced: bool = False
    requests: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    ops: List[Tuple[str, float, float]] = field(default_factory=list)
    busy: List[Tuple[float, float]] = field(default_factory=list)
    counts: Dict[str, object] = field(default_factory=dict)

    def durations(self, name: str) -> List[float]:
        """The seconds of every span of this name."""
        return [b - a for n, a, b in self.spans if n == name]

    def device_seconds(self, names) -> Tuple[int, float]:
        """(spans, device seconds) of the spans of the given names: the
        summed time of the device operations inside them."""
        spans = [(a, b) for n, a, b in self.spans if n in names]
        return len(spans), sum(overlap([(a, b) for _, a, b in self.ops], lo, hi) for lo, hi in spans)

    def busy_seconds(self) -> float:
        return sum(b - a for a, b in merge(self.busy, self.t0, self.t1))


def median(values: List[float]) -> Optional[float]:
    return statistics.median(values) if values else None


def phase_ms(win: Window, phase: str) -> Optional[float]:
    """The median milliseconds of a port phase over the window's spans."""
    values = win.durations("phase." + phase)
    return 1000.0 * median(values) if values else None


def idle_percent(win: Window) -> Optional[float]:
    """The share of the window in which the device ran no operation, in
    percent; None without a trace."""
    if not win.traced:
        return None
    return 100.0 * (1.0 - win.busy_seconds() / (win.t1 - win.t0))


def breakdown(win: Window) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the device by the innermost span the host was in."""
    by_op: Dict[str, float] = {}
    for name, a, b in win.ops:
        by_op[name] = by_op.get(name, 0.0) + max(0.0, min(b, win.t1) - max(a, win.t0))
    gaps: Dict[str, float] = {}
    edges = [win.t0] + [t for iv in merge([(a, b) for _, a, b in win.ops], win.t0, win.t1) for t in iv] + [win.t1]
    spans = sorted((b - a, n, a, b) for n, a, b in win.spans)
    for lo, hi in zip(edges[0::2], edges[1::2]):
        if hi <= lo:
            continue
        mid = (lo + hi) / 2
        owner = next((n for _, n, a, b in spans if a <= mid <= b), "host.outside_spans")
        gaps[owner] = gaps.get(owner, 0.0) + hi - lo
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(gaps)}


# ---------------------------------------------------------------------------
# the result
# ---------------------------------------------------------------------------

def judge_apart(fn, items) -> list:
    """``[fn(*item) for item in items]``, worked out in reference processes
    of their own, one a CPU the run may use, once the program is freed:
    the reference is plain Python and would take minutes in one process.
    The processes are spawned (they load the reference and nothing of
    torch or the port) and have ended when this returns."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    if not items:
        return []
    workers = min(len(items), len(os.sched_getaffinity(0)))
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        return list(pool.map(fn, *zip(*items)))


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: Dict[str, Tuple[float, float]], extra: Optional[dict] = None) -> str:
    """The contract's JSON line; the compared numbers come last."""
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    out.update(extra or {})
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return json.dumps(out)


def within(checks: Dict[str, Tuple[float, float]]) -> bool:
    return all(value <= limit for value, limit in checks.values())
