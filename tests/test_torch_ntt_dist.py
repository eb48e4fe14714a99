"""The distributed NTT (parallel/ntt_dist.py, the JAX package's K18) and the
sharded FRI fold on in-process CPU shards.

At n = 512 and S = 2, 4 and 8 shards of a local mesh, the forward and
inverse transforms equal the port's one-device ``NTT.ntt`` and the JAX
``make_distributed_ntt`` on the JAX package's virtual CPU devices (as
tests/test_distributed.py:31,45 runs it), and the inverse undoes the
forward.  The sharded fold of ShardedFastStark (H6's plain version on
each pair block) equals the JAX ``_fold_kernel`` on the whole codeword
(tests/test_distributed.py:57), with the next round's table and the
folded layer's root.  Zero tolerance: the values are equal.
"""

import os
import random

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec

from stark_anatomy_tpu.field import ops as JF
from stark_anatomy_tpu.ops.domain import mont_const as jax_mont_const
from stark_anatomy_tpu.ops.domain import power_table as jax_power_table
from stark_anatomy_tpu.parallel.ntt_dist import make_distributed_ntt as jax_dist_ntt
from stark_anatomy_tpu.protocols.fri import _fold_kernel, _square_half
from stark_anatomy_tpu.utils.convert import device_from_ints as jax_from_ints
from stark_anatomy_tpu.utils.convert import ints_from_device as jax_ints
from stark_anatomy_tpu_torch.commit.merkle import MerkleTree
from stark_anatomy_tpu_torch.field.scalar import Field, P
from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime
from stark_anatomy_tpu_torch.ops import ntt as NTT
from stark_anatomy_tpu_torch.parallel.mesh import Mesh, Sharded
from stark_anatomy_tpu_torch.parallel.ntt_dist import dist_ntt_ok, make_distributed_ntt
from stark_anatomy_tpu_torch.parallel.sharded_stark import Paired, ShardedFastStark
from stark_anatomy_tpu_torch.utils.convert import canonical_np, device_from_ints, ints_from_device

os.environ.setdefault("STARK_TPU_AOT", "0")
torch.set_num_threads(1)

N = 512


def cpu_mesh(shards: int) -> Mesh:
    return Mesh([[torch.device("cpu")] * shards])


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_distributed_ntt_matches_one_device_and_jax(shards):
    rng = random.Random(88 + shards)
    vals = [rng.randrange(P) for _ in range(2 * N)]
    x = device_from_ints(vals, "cpu").view(8, 2, N).movedim(1, 0).contiguous()      # (2, 8, N)
    mesh = cpu_mesh(shards)
    xs = Sharded.place(mesh, x)
    fwd = make_distributed_ntt(N, mesh)(xs)
    assert isinstance(fwd, Sharded) and set(fwd.shards) == set(range(shards))
    assert all(t.shape == (2, 8, N // shards) for t in fwd.shards.values())
    want = NTT.ntt(x)
    assert torch.equal(fwd.gather(), want)
    back = make_distributed_ntt(N, mesh, inverse=True)(fwd)
    assert torch.equal(back.gather(), x)
    assert torch.equal(make_distributed_ntt(N, mesh, inverse=True)(xs).gather(), NTT.intt(x))

    jmesh = JaxMesh(np.array(jax.devices()[:shards]).reshape(1, shards), axis_names=("dp", "sp"))
    row = jax_from_ints(vals[:N])
    placed = jax.device_put(row, NamedSharding(jmesh, PartitionSpec(None, "sp")))
    assert ints_from_device(fwd.gather()[0]) == jax_ints(jax_dist_ntt(N, jmesh)(placed))
    inv_row = jax.device_put(jax_from_ints(ints_from_device(want[0])),
                             NamedSharding(jmesh, PartitionSpec(None, "sp")))
    assert jax_ints(jax_dist_ntt(N, jmesh, inverse=True)(inv_row)) == vals[:N]


def test_routing_rule():
    assert dist_ntt_ok(512, 8) and dist_ntt_ok(128, 8) and not dist_ntt_ok(96, 8)
    assert not dist_ntt_ok(512, 1) and not dist_ntt_ok(32, 8) and dist_ntt_ok(4, 2)


def table_ints(u) -> list:
    """A sharded round's inverse-domain table, its blocks in shard order,
    as host ints."""
    return [v for k in sorted(u) for v in ints_from_device(u[k])]


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_fold_matches_jax_fold(shards):
    """One sharded FRI round at the topology parameters (FRI domain 512):
    the folded layer, the next table and the layer's root."""
    field = Field.main()
    rp = RescuePrime()
    stark = ShardedFastStark(field, 4, 2, 4, rp.m, rp.N + 1, transition_constraints_degree=3,
                             mesh=cpu_mesh(shards))
    fri = stark.fri
    rng = random.Random(57 + shards)
    vals = [rng.randrange(P) for _ in range(N)]
    alpha = rng.randrange(P)
    layer = Paired.of(Sharded.place(stark.mesh, device_from_ints(vals, "cpu")))
    u = fri.initial_table(layer)
    assert table_ints(u) == ints_from_device(fri._initial_u("cpu"))
    folded, u_next, rows, tree = fri.fold_layer(layer, u, alpha)

    ju = JF.mont_mul(jax_power_table(pow(fri.omega, P - 2, P), N // 2),
                     jax_mont_const(pow(fri.offset, P - 2, P)))
    want = _fold_kernel(jax_from_ints(vals), ju, jax_mont_const(alpha), jax_mont_const(pow(2, P - 2, P)))
    assert ints_from_device(folded.gather()) == jax_ints(want)
    assert table_ints(u_next) == jax_ints(_square_half(ju))
    canon = canonical_np(folded.gather())
    assert tree.root == MerkleTree.from_limbs_paired(canon).root
    assert rows.gather(range(N // 2)) == jax_ints(want)
    assert stark.routes["fold_sharded"] == 1
