"""PyTorch port: the deployment examples of examples/torch/ (key files, the
native client's compressed transport, proxy re-encryption with and without
bootstraps between hops) on the CPU at TEST_TINY, each against its JAX
counterpart in examples/ (result lines equal under the same flags), and
each refusing to run without a card unless --cpu is given. Helpers:
tests/torch_examples_util.py."""

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
import torch_examples_util as U  # noqa: E402

GROUP = U.ExampleGroup([
    "key_serialization.py", "compressed_transport.py", "proxy_reencryption_demo.py",
    "proxy_reenc_with_bootstrap.py",
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


def test_compressed_transport_ran_the_native_client():
    """Where g++ builds the native client, the example does not skip."""
    from rs_tfhe_tpu_torch import native

    if not native.available():
        pytest.skip("no native client on this machine (no g++)")
    assert "evaluated on expanded ciphertexts: OK" in GROUP.port("compressed_transport.py").stdout
