"""PyTorch port: the port's examples (examples/torch/) run end to end on a
mesh of CPU devices at TEST_TINY. They sit in a folder of their own, so the
JAX examples' smoke test (tests/test_examples_smoke.py, which runs every
examples/*.py under JAX's CPU flags) does not pick them up."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

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
