"""PyTorch port: threefry-2x32 and JAX's key derivation (`torus.key_data`,
`split`, `fold_in`, `random_bits`, `threefry2x32_bits`) against `jax.random`
under its default partitionable threefry, the JAX package's
`threefry2x32_bits`, and the native client's `threefry_bits` in both
packages, with tolerance 0."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rs_tfhe_tpu import native as JNAT  # noqa: E402
from rs_tfhe_tpu import torus as JTo  # noqa: E402
from rs_tfhe_tpu_torch import native as PNAT  # noqa: E402
from rs_tfhe_tpu_torch import torus as PTo  # noqa: E402
from rs_tfhe_tpu_torch.torus import to_numpy  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port: the suite runs six workers on the
    machine's cores, and torch's default of a thread a core oversubscribes
    them (the JAX side keeps its own pool)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_words(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.uint32)


def test_partitionable_threefry_is_the_default():
    """The mask streams and key files assume it (`rs_tfhe_tpu.torus`)."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, -1, 2**40 + 5, -(2**63), 2**63 - 1])
def test_key_data_matches_jax(seed):
    np.testing.assert_array_equal(to_numpy(PTo.key_data(seed)), _jax_words(jax.random.key(seed)))


def test_key_data_rejects_seeds_beyond_64_bits():
    with pytest.raises(ValueError, match="64 bits"):
        PTo.key_data(2**63)


@pytest.mark.parametrize("num", [1, 2, 3, 8])
def test_split_matches_jax(num):
    rng = np.random.default_rng(num)
    for words in rng.integers(0, 2**32, (3, 2), dtype=np.uint32):
        jkey = jax.random.wrap_key_data(jnp.asarray(words))
        np.testing.assert_array_equal(to_numpy(PTo.split(words, num)), _jax_words(jax.random.split(jkey, num)))


@pytest.mark.parametrize("data", [0, 1, 0x6D62, 2**31, 2**32 - 1])
def test_fold_in_matches_jax(data):
    for seed in (0, 9, -7):
        np.testing.assert_array_equal(
            to_numpy(PTo.fold_in(PTo.key_data(seed), data)), _jax_words(jax.random.fold_in(jax.random.key(seed), data))
        )


@pytest.mark.parametrize("shape", [(1,), (7,), (16, 8, 2, 64)])
def test_random_bits_matches_jax(shape):
    words = np.random.default_rng(len(shape)).integers(0, 2**32, 2, dtype=np.uint32)
    jkey = jax.random.wrap_key_data(jnp.asarray(words))
    ref = np.asarray(jax.random.bits(jkey, shape, jnp.uint32))
    np.testing.assert_array_equal(to_numpy(PTo.random_bits(words, shape, "cpu")), ref)


@pytest.mark.parametrize("start", [0, 1, 4093, 2**31 - 3, 2**32 - 40])
def test_stream_matches_jax_and_both_native_clients(start):
    """The counter-offset stream: JAX's `threefry2x32_bits(_raw)`, the JAX
    package's native client, the port's native client, and (at small starts)
    a slice of `jax.random.bits`, all the same words."""
    count = 37
    k1, k2 = (int(w) for w in np.random.default_rng(start % 97).integers(0, 2**32, 2, dtype=np.uint32))
    port = to_numpy(PTo.threefry2x32_bits_raw(k1, k2, start, count, "cpu"))
    np.testing.assert_array_equal(to_numpy(PTo.threefry2x32_bits((k1, k2), start, count, "cpu")), port)
    ref = np.asarray(JTo.threefry2x32_bits_raw(jnp.uint32(k1), jnp.uint32(k2), start, count))
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(PNAT.threefry_bits(k1, k2, start, count), ref)
    np.testing.assert_array_equal(JNAT.threefry_bits(k1, k2, start, count), ref)
    if start < 5000:
        jkey = jax.random.wrap_key_data(jnp.asarray([k1, k2], dtype=jnp.uint32))
        np.testing.assert_array_equal(port, np.asarray(jax.random.bits(jkey, (start + count,), jnp.uint32))[start:])


def test_stream_rejects_counters_past_32_bits():
    """JAX's row tables raise there (rs_tfhe_tpu/tlwe.py:126-127)."""
    with pytest.raises(ValueError, match="32-bit threefry counter"):
        PTo.threefry2x32_bits((1, 2), 2**32 - 3, 4, "cpu")
    with pytest.raises(ValueError, match="32-bit"):
        PNAT.threefry_bits(1, 2, 2**32 - 3, 4)
    assert PTo.threefry2x32_bits((1, 2), 2**32 - 4, 4, "cpu").shape == (4,)


def test_key_tensor_takes_every_form():
    ref = PTo.key_tensor(np.asarray([0xDEADBEEF, 7], dtype=np.uint32))
    assert ref.dtype == torch.int32 and ref.device.type == "cpu"
    for form in ((0xDEADBEEF, 7), [0xDEADBEEF - 2**32, 7], ref.clone(), np.asarray([0xDEADBEEF, 7], np.int64)):
        assert torch.equal(PTo.key_tensor(form), ref)
    with pytest.raises(ValueError, match="two 32-bit words"):
        PTo.key_tensor([1, 2, 3])
