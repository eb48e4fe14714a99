"""The benchmark stands apart: nothing under portbench/ imports JAX or the
JAX package (whole top-level names, so the port's own name, which begins
with the JAX package's, does not match), nor names a file of the JAX
package, and the plain reference imports nothing of the program either."""

import ast
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "stark_anatomy_tpu"}
PORT = "stark_anatomy_tpu_torch"


def sources(under):
    for dirpath, _, files in os.walk(under):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", list(sources(HERE)), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_import(path):
    assert not FORBIDDEN & set(imported_roots(path)), path


@pytest.mark.parametrize("path", list(sources(os.path.join(HERE, "reference"))),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_program(path):
    roots = set(imported_roots(path))
    assert not (FORBIDDEN | {PORT, "torch", "numpy"}) & roots, path


@pytest.mark.parametrize("path", list(sources(HERE)), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_package_file_named(path):
    # a path into the JAX package is its name followed by a slash
    assert "stark_anatomy_tpu" + "/" not in open(path).read(), path


def test_whole_names_tell_the_port_from_the_jax_package():
    assert "stark_anatomy_tpu_torch.models".split(".")[0] not in FORBIDDEN
    assert "stark_anatomy_tpu.models".split(".")[0] in FORBIDDEN


def test_importing_every_module_loads_no_jax():
    modules = sorted(
        "portbench." + os.path.relpath(p, HERE)[:-3].replace(os.sep, ".")
        for p in sources(HERE)
        if "tests" not in p and os.path.basename(p) != "conftest.py" and "metrics" not in p
    )
    code = ("import sys\n" + "".join(f"import {m.replace('.__init__', '')}\n" for m in modules)
            + "from portbench import harness\n"
            + "for name in __import__('os').listdir(harness.HERE + '/metrics'):\n"
            + "    harness.metric_reader(name[:-3])\n"
            + "print(','.join(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=ROOT), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout
