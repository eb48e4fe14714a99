"""The batched prover core and its entry (stark_anatomy_tpu_torch/entry.py)
against the JAX package's (parallel/batch.py:build_prover_core and
__graft_entry__.py:entry).

Both draw their example arguments at checks = 2 and B = 2 from
``random.Random(2024)`` in the same order: the port's arguments equal the
JAX ones, and the port's core gives the JAX core's three outputs (the
combination codeword, the boundary-quotient codewords and the randomizer
codeword), exactly.  ``__graft_entry__._build`` points JAX's persistent
compile cache at the repository's tracked .aot_cache/; the test keeps
that setting out of its process (monkeypatch of ``jax.config.update`` for
those two keys) and otherwise runs the entry as it is.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def outputs():
    """(port args, port outputs, JAX args, JAX outputs) as numpy arrays."""
    import jax

    import __graft_entry__
    from stark_anatomy_tpu_torch.entry import entry

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STARK_TPU_AOT", "0")
        real_update = jax.config.update

        def update(name, value):
            if name not in CACHE_KEYS:
                real_update(name, value)

        mp.setattr(jax.config, "update", update)
        jcore, jargs = __graft_entry__.entry()
        jout = jcore(*jargs)
    core, args = entry(device="cpu")
    out = core(*args)
    as_np = lambda xs: [np.asarray(x).astype(np.int64) for x in xs]
    return (as_np([a.numpy() for a in args]), as_np([o.numpy() for o in out]),
            as_np(jargs), as_np(jout))


def test_entry_arguments_equal_jax(outputs):
    args, _, jargs, _ = outputs
    assert len(args) == len(jargs) == 9
    for k, (a, j) in enumerate(zip(args, jargs)):
        assert a.shape == j.shape, (k, a.shape, j.shape)
        assert np.array_equal(a, j), k


@pytest.mark.parametrize("k,name", [(0, "combination"), (1, "boundary quotients"), (2, "randomizer")])
def test_core_outputs_equal_jax(outputs, k, name):
    _, out, _, jout = outputs
    assert out[k].shape == jout[k].shape, name
    assert np.array_equal(out[k], jout[k]), name


def test_core_batch_of_two_shapes(outputs):
    _, out, _, _ = outputs
    assert out[0].shape == (2, 8, 512)
    assert out[1].shape == (2, 2, 8, 512)
    assert out[2].shape == (2, 8, 512)
