"""PyTorch port: the gate and LUT examples of examples/torch/ on the CPU at
TEST_TINY, each against its JAX counterpart in examples/ (result lines
equal under the same flags), and each refusing to run without a card
unless --cpu is given. Helpers: tests/torch_examples_util.py."""

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
import torch_examples_util as U  # noqa: E402

GROUP = U.ExampleGroup([
    "security_levels.py", "gates_with_strategies.py", "batch_gates.py", "low_latency_gates.py",
    "keygen_speed.py", "lut_bootstrapping.py", "lut_uint_parameters_demo.py",
])


@pytest.mark.parametrize("name", GROUP.names)
def test_port_example_runs_on_cpu(name):
    GROUP.check_runs(name)


@pytest.mark.parametrize("name", GROUP.names)
def test_port_example_prints_the_jax_result_lines(name):
    GROUP.check_matches_jax(name)


@pytest.mark.parametrize("name", GROUP.needs_device)
def test_port_example_needs_a_card_by_default(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device exists")
    GROUP.check_needs_a_card(name)


def test_security_levels_needs_no_device():
    """The one example that makes no tensor runs without --cpu anywhere."""
    res = U.run_port("security_levels.py", cpu=False)
    assert res.returncode == 0, res.stderr[-1000:]
    assert res.stdout.count(" -> Security level: ") == 14
