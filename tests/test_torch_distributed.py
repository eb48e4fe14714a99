"""The port under torch.distributed: two CPU processes joined by gloo.

``init_distributed`` takes the STARK_TPU_COORD / STARK_TPU_NUM_PROC /
STARK_TPU_PROC_ID variables (tests/test_distributed.py:103); the
coordinator is a ``file://`` URL under ``tmp_path``, so that parallel test
workers never race for a port.  Over a (1, 2) dist mesh, one shard a rank,
the distributed NTT round trip equals the one-device transform, and the
sharded prover's proof on both ranks equals the one-device proof byte for
byte (the draws come from rank 0, the roots and openings are gathered).
Over a (2, 1) mesh a batch of two proofs splits over dp, a proof a rank,
with the unsplit batch's bytes.  Single-process, ``init_distributed`` is a
no-op and ``scaling_report`` runs (tests/test_distributed.py:85).  Each
child process has its own timeout, so a hang fails one test.
"""

import hashlib
import os
import subprocess
import sys

import torch

from stark_anatomy_tpu_torch.field.scalar import Field
from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime, make_air_evaluator
from stark_anatomy_tpu_torch.parallel.batch_prover import BatchProver
from stark_anatomy_tpu_torch.parallel.multihost import init_distributed, is_controller, scaling_report
from stark_anatomy_tpu_torch.protocols.fast_stark import FastStark
from stark_anatomy_tpu_torch.transcript.proof_stream import SignatureProofStream

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELD = Field.main()
CHILD_TIMEOUT = 50

PRELUDE = '''
import hashlib, os, sys
import torch
torch.set_num_threads(1)
from stark_anatomy_tpu_torch.parallel.multihost import init_distributed, is_controller, shutdown
pid = int(os.environ["STARK_TPU_PROC_ID"])

def det_urandom(seed):
    state = {"ctr": 0}
    def rand(n):
        out = b""
        while len(out) < n:
            out += hashlib.blake2b(seed + state["ctr"].to_bytes(8, "big")).digest()
            state["ctr"] += 1
        return out[:n]
    return rand
'''

PROVE = PRELUDE + '''
assert init_distributed(device="cpu") is True
import torch.distributed as dist
from stark_anatomy_tpu_torch.field.scalar import Field, P
from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime, make_air_evaluator
from stark_anatomy_tpu_torch.ops import ntt as NTT
from stark_anatomy_tpu_torch.parallel.mesh import Mesh, Sharded, make_mesh
from stark_anatomy_tpu_torch.parallel.multihost import rank_device
from stark_anatomy_tpu_torch.parallel.ntt_dist import make_distributed_ntt
from stark_anatomy_tpu_torch.parallel.sharded_stark import ShardedFastStark
from stark_anatomy_tpu_torch.utils.convert import device_from_ints

mesh = make_mesh()
assert mesh.backend == "dist" and mesh.shape == {"dp": 1, "sp": 2} and mesh.local_shards() == [pid]
rng = __import__("random").Random(31)
x = device_from_ints([rng.randrange(P) for _ in range(1024)], "cpu").view(8, 2, 512).movedim(1, 0).contiguous()
xs = Sharded.place(mesh, x)
fwd = make_distributed_ntt(512, mesh)(xs)
assert list(fwd.shards) == [pid] and torch.equal(fwd.gather(), NTT.ntt(x))
assert torch.equal(make_distributed_ntt(512, mesh, inverse=True)(fwd).gather(), x)

field = Field.main()
rp = RescuePrime()
stark = ShardedFastStark(field, 4, 2, 4, rp.m, rp.N + 1, transition_constraints_degree=3, mesh=mesh)
inp = field.sample(b"topology")
air = rp.transition_constraints(stark.omicron)
tz = stark.preprocess()
proof = stark.prove(rp.trace(inp), air, rp.boundary_constraints(rp.hash(inp)), tz,
                    air_evaluator=make_air_evaluator(stark), urandom=det_urandom(b"seed-A"))
print("PROOF", pid, is_controller(), tz.root.hex(), hashlib.sha256(proof).hexdigest(),
      dict(stark.routes)["ntt_dist"], flush=True)
shutdown()
'''

BATCH = PRELUDE + '''
assert init_distributed(device="cpu") is True
from stark_anatomy_tpu_torch.field.scalar import Field
from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime
from stark_anatomy_tpu_torch.parallel.batch_prover import BatchProver
from stark_anatomy_tpu_torch.parallel.mesh import Mesh
from stark_anatomy_tpu_torch.protocols.fast_stark import FastStark
from stark_anatomy_tpu_torch.transcript.proof_stream import SignatureProofStream

mesh = Mesh([[torch.device("cpu")], [torch.device("cpu")]], backend="dist")
assert mesh.shape == {"dp": 2, "sp": 1} and mesh.dp_index == pid
field = Field.main()
rp = RescuePrime()
stark = FastStark(field, 4, 2, 4, rp.m, rp.N + 1, transition_constraints_degree=3, device="cpu")
prover = BatchProver(stark, rp, stark.preprocess(), mesh=mesh)
docs = [b"dist batch 0", b"dist batch 1"]
proofs = prover.prove_batch([field.sample(bytes([9, i])) for i in range(2)],
                            [SignatureProofStream(d) for d in docs], urandom=det_urandom(b"batch"))
print("BATCH", pid, " ".join(hashlib.sha256(p).hexdigest() for p in proofs), flush=True)
shutdown()
'''

SMOKE = PRELUDE + '''
assert init_distributed(device="cpu") is True
import torch.distributed as dist
assert dist.get_world_size() == 2, dist.get_world_size()
assert is_controller() == (pid == 0)
print("MH_OK", pid, flush=True)
shutdown()
'''


def det_urandom(seed: bytes):
    state = {"ctr": 0}

    def rand(n: int) -> bytes:
        out = b""
        while len(out) < n:
            out += hashlib.blake2b(seed + state["ctr"].to_bytes(8, "big")).digest()
            state["ctr"] += 1
        return out[:n]

    return rand


def run_two(tmp_path, code: str, tag: str):
    """Run ``code`` as ranks 0 and 1; returns each rank's output."""
    child = tmp_path / f"{tag}.py"
    child.write_text(code)
    procs = []
    for pid in range(2):
        env = dict(os.environ, PYTHONPATH=ROOT, STARK_TPU_COORD=f"file://{tmp_path}/rdv_{tag}",
                   STARK_TPU_NUM_PROC="2", STARK_TPU_PROC_ID=str(pid))
        procs.append(subprocess.Popen([sys.executable, str(child)], cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {pid} failed:\n{out[-3000:]}"
    return outs


def line(out: str, tag: str):
    return next(ln.split()[1:] for ln in out.splitlines() if ln.startswith(tag + " "))


def test_sharded_prove_over_two_gloo_processes(tmp_path):
    rp = RescuePrime()
    stark = FastStark(FIELD, 4, 2, 4, rp.m, rp.N + 1, transition_constraints_degree=3, device="cpu")
    inp = FIELD.sample(b"topology")
    tz = stark.preprocess()
    want = stark.prove(rp.trace(inp), rp.transition_constraints(stark.omicron),
                       rp.boundary_constraints(rp.hash(inp)), tz,
                       air_evaluator=make_air_evaluator(stark), urandom=det_urandom(b"seed-A"))
    outs = run_two(tmp_path, PROVE, "prove")
    got = [line(out, "PROOF") for out in outs]
    assert [g[0] for g in got] == ["0", "1"] and [g[1] for g in got] == ["True", "False"]
    for g in got:
        assert g[2] == tz.root.hex()
        assert g[3] == hashlib.sha256(want).hexdigest(), "a rank's proof differs from one device's"
        assert g[4] == "4"


def test_batch_split_over_dp_ranks(tmp_path):
    rp = RescuePrime()
    stark = FastStark(FIELD, 4, 2, 4, rp.m, rp.N + 1, transition_constraints_degree=3, device="cpu")
    prover = BatchProver(stark, rp, stark.preprocess())
    docs = [b"dist batch 0", b"dist batch 1"]
    want = prover.prove_batch([FIELD.sample(bytes([9, i])) for i in range(2)],
                              [SignatureProofStream(d) for d in docs], urandom=det_urandom(b"batch"))
    outs = run_two(tmp_path, BATCH, "batch")
    for out in outs:
        assert line(out, "BATCH")[1:] == [hashlib.sha256(p).hexdigest() for p in want]


def test_two_process_init_and_controller(tmp_path):
    outs = run_two(tmp_path, SMOKE, "smoke")
    for pid, out in enumerate(outs):
        assert f"MH_OK {pid}" in out


def test_single_process_noop_and_scaling_report(monkeypatch):
    for var in ("STARK_TPU_COORD", "STARK_TPU_NUM_PROC", "STARK_TPU_PROC_ID"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() is False
    assert is_controller()
    calls = []
    report = scaling_report(lambda s: calls.append(s), [1, 2], reps=1)
    assert [r["shards"] for r in report] == [1, 2]
    assert report[0]["efficiency"] == 1.0 and calls == [1, 1, 2, 2]
