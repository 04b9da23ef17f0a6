"""PyTorch port: the port's examples (examples/torch/) as a whole, and the
multi-device one run end to end on a mesh of CPU devices at TEST_TINY. They
sit in a folder of their own, so the JAX examples' smoke test
(tests/test_examples_smoke.py, which runs every examples/*.py under JAX's
CPU flags) does not pick them up. The other examples are held against their
JAX counterparts in tests/test_torch_examples_{gates,circuits,radix,deploy}.py."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch_examples_util as U  # noqa: E402

EXAMPLES = Path(__file__).resolve().parent.parent / "examples" / "torch"


def _run(name, *flags, timeout=300):
    return subprocess.run([sys.executable, str(EXAMPLES / name), *flags], capture_output=True, text=True,
                          timeout=timeout, env={"OMP_NUM_THREADS": "1", **os.environ})


def test_multi_chip_scaling_on_cpu_devices():
    res = _run("multi_chip_scaling.py", "--cpu", "--batch", "16")
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[0].startswith("8 device(s): cpu")
    assert any(line.startswith("data-parallel NAND over 8 devices") for line in lines)
    assert any(line.startswith("tensor-parallel NAND (4 x 2 mesh)") for line in lines)
    assert lines[-1] == "OK"


def test_multi_chip_scaling_needs_a_card_by_default():
    """Without --cpu the example takes the visible CUDA devices, and raises
    where there is none rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default mesh exists")
    res = _run("multi_chip_scaling.py", "--batch", "4")
    assert res.returncode != 0 and "no CUDA device" in res.stderr


def test_port_examples_stay_out_of_the_jax_examples_glob():
    ported = set(EXAMPLES.glob("*.py"))
    assert ported and ported.isdisjoint(EXAMPLES.parent.glob("*.py"))


def test_every_jax_example_has_a_port():
    jax_examples = {p.name for p in EXAMPLES.parent.glob("*.py") if not p.name.startswith("_")}
    ported = {p.name for p in EXAMPLES.glob("*.py")}
    assert len(jax_examples) == 20 and not jax_examples - ported, sorted(jax_examples - ported)


def test_every_port_example_is_held_against_jax():
    """Each example but multi_chip_scaling (above) is in one group module."""
    groups = set()
    for module in ("gates", "circuits", "radix", "deploy"):
        groups.update(__import__(f"test_torch_examples_{module}").GROUP.names)
    ported = {p.name for p in EXAMPLES.glob("*.py") if not p.name.startswith("_")}
    assert groups == ported - {"multi_chip_scaling.py"}


@pytest.mark.parametrize("path", sorted(EXAMPLES.glob("*.py")), ids=lambda p: p.name)
def test_port_examples_import_no_jax(path):
    """No example of the port, nor its helper, imports JAX or the JAX package."""
    for node in ast.walk(ast.parse(path.read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "rs_tfhe_tpu"), f"{path.name} imports {name}"


def test_result_lines_drop_times_only():
    out = ("[keygen] tiny: 0.01s\n[x + y (3 PBS)] 1.754s\n  [15 10] + [15 12] = [14  6] (mod 16)\n"
           " batch   total ms   ms/gate   gates/s\n     8        7.8     0.973    1027.6\n"
           "key-switching key: 3 ms (warm)\n[standard key] single-gate latency: 9.59 ms\n"
           "[speedup] 0.52x  (reference: ~15 ms/gate)\nsecret key        : 1.2 kB\nOK")
    assert U.result_lines(out) == ["  [15 10] + [15 12] = [14  6] (mod 16)",
                                   " batch   total ms   ms/gate   gates/s", "8", "secret key        : 1.2 kB", "OK"]
