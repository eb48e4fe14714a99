"""The port stands alone: it imports neither jax nor the JAX package (nor
do chip_smoke.py and the tools that drive it on the card), and its entry
points run on the card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "stark_anatomy_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "stark_anatomy_tpu")


PORT_TOOLS = ("tools/port_compare.py", "tools/port_interleave.py", "tools/sass_count.py",
              "tools/port_fri_branch.py", "tools/preprocess_steps.py", "tools/ntt_tiled_probe.py")


def port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")] + [os.path.join(ROOT, t) for t in PORT_TOOLS]
    for dirpath, _, files in os.walk(PORT):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import sys\n"
        "import stark_anatomy_tpu_torch.models.rpsss\n"
        "import stark_anatomy_tpu_torch.protocols.fast_stark\n"
        "import stark_anatomy_tpu_torch.parallel.batch_prover\n"
        "import stark_anatomy_tpu_torch.models.mimc\n"
        "import stark_anatomy_tpu_torch.parallel.pipeline_prover\n"
        "import stark_anatomy_tpu_torch.utils.rand\n"
        "import stark_anatomy_tpu_torch.entry\n"
        "import stark_anatomy_tpu_torch.ops\n"
        "import stark_anatomy_tpu_torch.protocols.stark\n"
        "import stark_anatomy_tpu_torch.parallel.mesh\n"
        "import stark_anatomy_tpu_torch.field.kernels\n"
        "import stark_anatomy_tpu_torch.parallel.ntt_dist\n"
        "import stark_anatomy_tpu_torch.parallel.sharded_stark\n"
        "import stark_anatomy_tpu_torch.parallel.multihost\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import_in_the_port_or_chip_smoke(path):
    assert not set(imported_roots(path)) & set(FORBIDDEN)


def test_entry_point_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    from stark_anatomy_tpu_torch.config import resolve_device
    from stark_anatomy_tpu_torch.models.rpsss import FastRPSSS

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FastRPSSS()
    assert resolve_device("cpu") == torch.device("cpu")
