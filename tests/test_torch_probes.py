"""PyTorch port: the probe and primitive-rate kernels' plain versions
(rs_tfhe_tpu_torch/ops/cuda_probes.py), the functions of the CUDA kernels in
csrc/probes.cu, held with tolerance 0 against

  - the seven TPU probe kernels of scripts/probe_mosaic.py and
    scripts/bench_kernel_prims.py, run on the CPU in interpret mode
    (`pl.pallas_call` wrapped with interpret=True while this module's tests
    run; nothing in scripts/ changes), at the scripts' own inputs and, with
    the scripts' `jnp.ones` replaced by seeded full-range random operands,
    on inputs that would show a permuted or folded result;
  - int64 numpy products and transcriptions on random inputs.

The kernels themselves are held against these plain versions on the card in
tests/test_torch_kernel_gpu.py and chip_smoke.py."""

import functools
import importlib.util
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from rs_tfhe_tpu_torch.ops import cuda_probes as CP  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE_OPTIONS = (
    "jax_compilation_cache_dir",
    "jax_persistent_cache_min_entry_size_bytes",
    "jax_persistent_cache_min_compile_time_secs",
)


def _load_script(name):
    """Import scripts/<name>.py; bench_kernel_prims.py points JAX at a
    persistent compilation cache when imported, which is undone here (the
    tests run without one, tests/conftest.py)."""
    saved = {opt: getattr(jax.config, opt) for opt in _CACHE_OPTIONS}
    spec = importlib.util.spec_from_file_location(f"_probe_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for opt, value in saved.items():
            jax.config.update(opt, value)
    return mod


class _RandomOnes:
    """Stands in for a script's `jnp`: `ones` draws seeded full-range random
    integers (and keeps them), everything else is jax.numpy's."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.made = []

    def ones(self, shape, dtype):
        info = np.iinfo(np.dtype(dtype))
        arr = self.rng.integers(info.min, int(info.max) + 1, shape).astype(info.dtype)
        self.made.append(arr)
        return jnp.asarray(arr)

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture(scope="module")
def scripts():
    """(probe_mosaic, bench_kernel_prims) with every pallas_call in interpret
    mode, bench_kernel_prims sized to its minimum chain (TARGET_SECS = 0) and
    its timing loop replaced by one that keeps the kernel's output."""
    real = pl.pallas_call
    pl.pallas_call = functools.partial(real, interpret=True)
    try:
        probe, bench = _load_script("probe_mosaic"), _load_script("bench_kernel_prims")
        bench.TARGET_SECS = 0
        bench.kept = []

        def keep(fn, *args):
            bench.kept.append(np.asarray(fn(*args)))
            return 1.0

        bench._run = keep
        yield probe, bench
    finally:
        pl.pallas_call = real


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rand(rng, shape, dtype):
    info = np.iinfo(dtype)
    return rng.integers(info.min, int(info.max) + 1, shape).astype(dtype)


def _u32(a):
    return np.asarray(a).astype(np.int64) % (1 << 32)


# ---------------------------------------------------------------------------
# P1, P5: integer dots
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32], ids=["s8", "s16", "s32"])
@pytest.mark.parametrize("random", [False, True], ids=["script_inputs", "random_inputs"])
def test_dot_plain_matches_tpu_probe_dot(scripts, dtype, random):
    probe, _ = scripts
    shim = _RandomOnes(100)
    if random:
        probe.jnp = shim
    try:
        ref = np.asarray(probe.probe_dot(jnp.dtype(dtype), 128, 1024, 256))
    finally:
        probe.jnp = jnp
    a, b = shim.made if random else (np.ones((128, 1024), dtype), np.ones((1024, 256), dtype))
    out = CP.probe_dot(_t(a), _t(b))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32], ids=["s8", "s16", "s32"])
@pytest.mark.parametrize("shape", [(128, 1024, 256), (5, 37, 11)], ids=["probe_shape", "odd_shape"])
def test_dot_plain_wraps_like_int64_numpy(dtype, shape):
    m, k, n = shape
    rng = np.random.default_rng(101)
    a, b = _rand(rng, (m, k), dtype), _rand(rng, (k, n), dtype)
    want = (a.astype(np.int64) @ b.astype(np.int64)) % (1 << 32) if dtype != np.int32 else \
        np.array((a.astype(object) @ b.astype(object)) % (1 << 32), dtype=np.int64)
    np.testing.assert_array_equal(_u32(CP.dot_plain(_t(a), _t(b)).numpy()), want)


def test_dot_correct_s16_matches_tpu_probe(scripts):
    """P5 draws its operands from default_rng(0) itself; so does the port."""
    probe, _ = scripts
    ref = np.asarray(probe.probe_dot_correct_s16())
    np.testing.assert_array_equal(CP.probe_dot_correct_s16("cpu").numpy(), ref)


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32], ids=["s8", "s32"])
def test_dot_correct_holds_every_type(dtype):
    assert CP.probe_dot_correct_s16("cpu", dtype).shape == (128, 256)


def test_dot_rejects_what_it_does_not_take():
    a = torch.zeros((4, 8), dtype=torch.int8)
    with pytest.raises(TypeError):
        CP.probe_dot(a, torch.zeros((8, 4), dtype=torch.int16))
    with pytest.raises(TypeError):
        CP.probe_dot(a.to(torch.int64), a.t().contiguous().to(torch.int64))
    with pytest.raises(ValueError, match="contract"):
        CP.probe_dot(a, a)
    with pytest.raises(ValueError, match="contiguous"):
        CP.probe_dot(a, torch.zeros((4, 8), dtype=torch.int8).t())


# ---------------------------------------------------------------------------
# P2, P3, P4: roll, bitcast, unpack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32], ids=["int8", "int16", "int32"])
@pytest.mark.parametrize("random", [False, True], ids=["script_inputs", "random_inputs"])
def test_roll_plain_matches_tpu_probe_roll(scripts, dtype, random):
    probe, _ = scripts
    shim = _RandomOnes(102)
    if random:
        probe.jnp = shim
    try:
        ref = np.asarray(probe.probe_roll(jnp.dtype(dtype)))
    finally:
        probe.jnp = jnp
    x = shim.made[0] if random else np.ones((8, 256), dtype)
    np.testing.assert_array_equal(CP.probe_roll(_t(x)).numpy(), ref)
    if random:
        np.testing.assert_array_equal(ref[:, 5:], x[:, :-5])


@pytest.mark.parametrize("shift", [0, 1, 5, 255, 256, 300, -7])
def test_roll_plain_takes_any_shift(shift):
    x = _rand(np.random.default_rng(103), (3, 256), np.int16)
    np.testing.assert_array_equal(CP.probe_roll(_t(x), shift).numpy(), np.roll(x, shift, axis=1))


@pytest.mark.parametrize("random", [False, True], ids=["script_inputs", "random_inputs"])
def test_bitcast_plain_matches_tpu_probe(scripts, random):
    probe, _ = scripts
    shim = _RandomOnes(104)
    if random:
        probe.jnp = shim
    try:
        ref = np.asarray(probe.probe_bitcast_i32_to_i8())
    finally:
        probe.jnp = jnp
    x = shim.made[0] if random else np.ones((8, 256), np.int32)
    out = CP.probe_bitcast_i32_to_i8(_t(x))
    assert out.dtype == torch.int8 and tuple(out.shape) == (8, 1024)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), x.view(np.int8))  # little-endian lanes


def test_unpack_plain_matches_tpu_probe(scripts):
    probe, _ = scripts
    ref_lo, ref_hi = (np.asarray(r) for r in probe.probe_unpack_s16())
    x = (np.arange(8 * 256, dtype=np.int64).reshape(8, 256) * 65537).astype(np.int32)
    lo, hi = CP.probe_unpack_s16(_t(x))
    assert lo.dtype == hi.dtype == torch.int16
    np.testing.assert_array_equal(lo.numpy(), ref_lo)
    np.testing.assert_array_equal(hi.numpy(), ref_hi)


def test_unpack_plain_on_random_words():
    x = _rand(np.random.default_rng(105), (8, 256), np.int32)
    lo, hi = CP.probe_unpack_s16(_t(x))
    np.testing.assert_array_equal(lo.numpy(), x.astype(np.int16))
    np.testing.assert_array_equal(hi.numpy(), (x >> 16).astype(np.int16))


# ---------------------------------------------------------------------------
# P6: the chained dot
# ---------------------------------------------------------------------------

def _chain_numpy(a0, b, steps):
    """bench_kernel_prims.py:61-83 transcribed to int64 numpy."""
    (m, k), n = a0.shape, b.shape[1]
    big = m * k * 4 > (2 << 20)
    fm = 8 if big else m
    wrap = lambda x: ((x + (1 << 31)) % (1 << 32)) - (1 << 31)  # noqa: E731
    fb = np.zeros((fm, k), np.int64)
    acc = np.zeros((m, n), np.int64)
    for _ in range(steps):
        dep = wrap(fb.sum(axis=0, keepdims=True)) if big else fb
        a = (a0.astype(np.int64) + (dep & 1)).astype(np.int8)
        acc = wrap(a.astype(np.int64) @ b.astype(np.int64))
        rows = acc[:fm]
        fb = wrap(rows[:, :k] + (rows[:, -1:] & 1)) if n >= k else np.concatenate([rows] * (k // n), axis=1)
    return acc, fb


#: (m, k, n): both feedback folds in the small form, and both in the big
#: form (lhs above 2 MiB of int32: 8 rows fed back as column sums).
CHAIN_SHAPES = [(128, 128, 128), (128, 256, 128), (4096, 256, 128), (8192, 128, 128)]


@pytest.mark.parametrize("shape", CHAIN_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("random", [False, True], ids=["script_inputs", "random_inputs"])
def test_chain_dot_plain_matches_tpu_bench_dot(scripts, shape, random):
    """The TPU kernel's last accumulator after its minimum chain (8 grid
    steps of 8 dots, or of 1 in the big form) equals the port's chain of as
    many steps."""
    _, bench = scripts
    m, k, n = shape
    shim = _RandomOnes(106)
    if random:
        bench.jnp = shim
    bench.kept.clear()
    try:
        bench.bench_dot(m, k, n)
    finally:
        bench.jnp = jnp
    a0, b = shim.made if random else (np.ones((m, k), np.int8), np.ones((k, n), np.int8))
    big, fm = CP.chain_shape(m, k)
    assert big == (m * k > 1 << 19)
    steps = 8 * (1 if big else bench.INNER)
    res = CP.chain_dot(_t(a0), _t(b), steps)
    np.testing.assert_array_equal(res.acc.numpy(), bench.kept[-1])
    assert tuple(res.fb.shape) == (fm, k)


@pytest.mark.parametrize("shape", [(16, 32, 32), (16, 64, 16), (16, 16, 40), (2048, 512, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_chain_dot_plain_matches_numpy_transcription(shape):
    m, k, n = shape
    rng = np.random.default_rng(107)
    a0, b = _rand(rng, (m, k), np.int8), _rand(rng, (k, n), np.int8)
    res = CP.chain_dot(_t(a0), _t(b), 5)
    acc, fb = _chain_numpy(a0, b, 5)
    np.testing.assert_array_equal(res.acc.numpy(), acc)
    np.testing.assert_array_equal(res.fb.numpy(), fb)
    zero = CP.chain_dot(_t(a0), _t(b), 0)
    assert not zero.acc.any() and not zero.fb.any()
    with pytest.raises(ValueError, match="plain version"):
        res.tile_loop()


def test_chain_dot_rejects_what_it_does_not_take():
    a0, b = torch.zeros((16, 48), dtype=torch.int8), torch.zeros((48, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="feedback"):
        CP.chain_dot(a0, b, 1)
    with pytest.raises(ValueError, match="unit"):
        CP.chain_dot(a0, b, 1, unit="wgmma")
    with pytest.raises(TypeError):
        CP.chain_dot(a0.to(torch.int16), b.to(torch.int16), 1)
    with pytest.raises(ValueError, match="steps"):
        CP.chain_dot(a0, torch.zeros((48, 48), dtype=torch.int8), -1)


# ---------------------------------------------------------------------------
# P7: the chained roll+add
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(128, 128), (8, 1024)], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("random", [False, True], ids=["script_inputs", "random_inputs"])
def test_chain_roll_add_plain_matches_tpu_bench_roll_add(scripts, shape, random):
    """With the script's ones the chain doubles every step and is 0 mod 2^32
    after 32 of them, so the random inputs carry the comparison."""
    _, bench = scripts
    shim = _RandomOnes(108)
    if random:
        bench.jnp = shim
    bench.kept.clear()
    try:
        bench.bench_roll_add(*shape)
    finally:
        bench.jnp = jnp
    x = shim.made[0] if random else np.ones(shape, np.int32)
    out = CP.chain_roll_add(_t(x), 8).numpy()  # TARGET_SECS = 0 -> 8 grid steps of 16
    np.testing.assert_array_equal(out, bench.kept[-1])
    assert out.any() == random


def test_chain_roll_add_plain_matches_numpy_transcription():
    x = _rand(np.random.default_rng(109), (3, 40), np.int32)
    want = x.astype(np.int64)
    for _ in range(2):
        for i in range(16):
            want = (want + np.roll(want, 1 + i, axis=1)) % (1 << 32)
    np.testing.assert_array_equal(_u32(CP.chain_roll_add(_t(x), 2).numpy()), want)
    with pytest.raises(TypeError):
        CP.chain_roll_add(_t(x).to(torch.int16), 1)
