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


#: Shapes of the byte-limb dot's plain version: the probe shape, one that is
#: ragged against the kernel's 128 x 128 tile with K = 48 (no multiple of its
#: 128-byte stage), and K = 1.
_LIMB_SHAPES = [(128, 1024, 256), (80, 48, 72), (7, 1, 9)]


def _extremes(rng, shape, dtype):
    """Full-range operands with the type's minimum, maximum and -1 (all bits
    set) planted: 0x8000 / 0x7FFF / 0xFFFF for s16, 0x80000000 / 0x7FFFFFFF /
    0xFFFFFFFF for s32."""
    info = np.iinfo(dtype)
    x = _rand(rng, shape, dtype)
    x.flat[:3] = (info.min, info.max, -1)
    x.flat[-1] = info.min
    return x


@pytest.mark.parametrize("horner", [True, False], ids=["in_tile", "split"])
@pytest.mark.parametrize("shape", _LIMB_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [np.int16, np.int32], ids=["s16", "s32"])
def test_dot_limbs_plain_matches_dot_plain_and_int64(dtype, shape, horner):
    """The tensor-core kernel's arithmetic (byte limbs, their products in the
    kernel's order, Horner's recombination or the split instance's weighted
    sum) equals the plain dot and the exact product mod 2^32."""
    m, k, n = shape
    rng = np.random.default_rng(110 + k)
    a, b = _extremes(rng, (m, k), dtype), _extremes(rng, (k, n), dtype)
    want = np.array((a.astype(object) @ b.astype(object)) % (1 << 32), dtype=np.int64)
    got = CP.dot_limbs_plain(_t(a), _t(b), horner=horner)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u32(got.numpy()), want)
    np.testing.assert_array_equal(got.numpy(), CP.dot_plain(_t(a), _t(b)).numpy())


def test_dot_limbs_plain_matches_tpu_probe_dot_s32(scripts):
    """The ten byte-limb products of an s32 dot against the TPU probe on
    seeded full-range operands."""
    probe, _ = scripts
    shim = _RandomOnes(111)
    probe.jnp = shim
    try:
        ref = np.asarray(probe.probe_dot(jnp.dtype(np.int32), 128, 1024, 256))
    finally:
        probe.jnp = jnp
    a, b = shim.made
    np.testing.assert_array_equal(CP.dot_limbs_plain(_t(a), _t(b)).numpy(), ref)


def test_limb_pairs_and_planes():
    """s16: hi.hi at 2^16, hi.lo and lo.hi at 2^8, lo.lo at 1; s32: the ten
    pairs with i + j <= 3, largest weight first; the planes recombine to the
    operand mod 2^32, the s16 high limb signed."""
    assert CP.limb_pairs(2) == [(1, 1, 2), (0, 1, 1), (1, 0, 1), (0, 0, 0)]
    pairs = CP.limb_pairs(4)
    assert len(pairs) == 10 and all(i + j == w <= 3 for i, j, w in pairs)
    assert [w for _, _, w in pairs] == sorted((w for _, _, w in pairs), reverse=True)
    rng = np.random.default_rng(112)
    for dtype in (np.int16, np.int32):
        x = _extremes(rng, (4, 9), dtype)
        planes = CP.limb_planes(_t(x))
        assert len(planes) == np.dtype(dtype).itemsize
        total = sum(p << (8 * i) for i, p in enumerate(planes))
        np.testing.assert_array_equal(_u32(total.numpy()), _u32(x))
        assert int(min(p.min() for p in planes)) >= (-128 if dtype == np.int16 else 0)
        assert int(max(p.max() for p in planes)) <= 255


def test_limb_k_rounds_up_to_the_tile_rows():
    assert [CP.limb_k(k) for k in (1, 15, 16, 17, 48, 1000, 1024)] == [16, 16, 16, 32, 48, 1008, 1024]
    with pytest.raises(TypeError):
        CP.dot_limbs_plain(torch.zeros((2, 2), dtype=torch.int8), torch.zeros((2, 2), dtype=torch.int8))


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


#: Shifts that sit at the roll kernel's edges: none, one element, around a
#: 16-byte vector of int8, the last column, past a whole turn, negative.
_EDGE_SHIFTS = (0, 1, 15, 16, 17, "C-1", "C+3", -3)


def _shift(shift, cols):
    return {"C-1": cols - 1, "C+3": cols + 3}.get(shift, shift)


@pytest.mark.parametrize("shift", _EDGE_SHIFTS, ids=str)
@pytest.mark.parametrize("cols", [1, 3, 17, 1000])
def test_roll_plain_ragged_columns(cols, shift):
    """Rows whose byte length is no multiple of 16 (and rows of one element),
    every element size, full-range words."""
    rng = np.random.default_rng(106 + cols)
    for dtype in (np.int8, np.int16, np.int32):
        x = _rand(rng, (3, cols), dtype)
        s = _shift(shift, cols)
        np.testing.assert_array_equal(CP.probe_roll(_t(x), s).numpy(), np.roll(x, s, axis=1))


@pytest.mark.parametrize("shift", _EDGE_SHIFTS, ids=str)
def test_roll_plain_rows_past_48_kb(shift):
    """int32 rows of 16384 columns (64 KB, above the 48 KB of shared memory a
    block gets without opting in)."""
    x = _rand(np.random.default_rng(107), (2, 16384), np.int32)
    s = _shift(shift, 16384)
    np.testing.assert_array_equal(CP.probe_roll(_t(x), s).numpy(), np.roll(x, s, axis=1))


@pytest.mark.parametrize("rows_first", [False, True], ids=["one_row", "one_column"])
@pytest.mark.parametrize("count", [1, 3, 5, 257])
def test_bitcast_plain_every_count(count, rows_first):
    """Word counts that leave a partial 16-byte vector, as one row or one
    column, with the sign bit alone and all bits set among the words."""
    words = _rand(np.random.default_rng(108 + count), count, np.int32)
    words[0] = np.int32(-(1 << 31))  # 0x80000000
    words[-1] = np.int32(-1)         # 0xFFFFFFFF
    x = words.reshape((count, 1) if rows_first else (1, count))
    out = CP.probe_bitcast_i32_to_i8(_t(x))
    assert out.dtype == torch.int8 and tuple(out.shape) == (x.shape[0], 4 * x.shape[1])
    np.testing.assert_array_equal(out.numpy(), x.view(np.int8))


@pytest.mark.parametrize("fault", ["dtype", "three_dims", "non_contiguous", "empty"])
@pytest.mark.parametrize("wrapper", ["probe_roll", "probe_bitcast_i32_to_i8"])
def test_roll_and_bitcast_reject_what_they_do_not_take(wrapper, fault):
    """The wrappers' argument errors on CPU tensors."""
    fn = getattr(CP, wrapper)
    x = torch.zeros((4, 8), dtype=torch.int32)
    bad, error = {
        "dtype": (x.to(torch.int64), TypeError),
        "three_dims": (x.reshape(2, 2, 8), ValueError),
        "non_contiguous": (x.t(), ValueError),
        "empty": (x[:0], ValueError),
    }[fault]
    with pytest.raises(error, match="dtype" if error is TypeError else None):
        fn(bad)


def test_library_load_is_one_object_without_the_lock_once_loaded(monkeypatch):
    """`_build.load()` returns the loaded library as it is, the same object
    each call, and takes its lock only until the library is loaded."""
    from rs_tfhe_tpu_torch import _build

    class Refused:
        def __enter__(self):
            raise AssertionError("load() took the lock after the library was loaded")

        def __exit__(self, *exc):
            return False

    loaded = object()
    monkeypatch.setattr(_build, "_lib", loaded)
    monkeypatch.setattr(_build, "_lock", Refused())
    assert _build.load() is loaded
    assert _build.load() is _build.load()


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


@pytest.mark.parametrize("rows_first", [False, True], ids=["one_row", "one_column"])
@pytest.mark.parametrize("count", [1, 7, 9, 8 * 125 + 3])
def test_unpack_plain_every_count(count, rows_first):
    """Word counts that are no multiple of the kernel's 8-word vector, as one
    row or one column, with 0x80000000, 0x7FFFFFFF, 0x8000 and 0xFFFFFFFF
    among the words."""
    words = _rand(np.random.default_rng(113 + count), count, np.int32)
    words[:4] = (-(1 << 31), (1 << 31) - 1, 1 << 15, -1)[:count]
    x = words.reshape((count, 1) if rows_first else (1, count))
    lo, hi = CP.probe_unpack_s16(_t(x))
    assert lo.dtype == hi.dtype == torch.int16 and lo.shape == hi.shape == x.shape
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
# P1, P6: what the wrappers of the tensor-core tile compute in Python
# ---------------------------------------------------------------------------

def test_dot_tiles_by_unit():
    """128 x 128 tiles on the tensor cores, 64 x 64 on the CUDA cores; a
    ragged edge is a tile of its own."""
    assert CP.DOT_TILE == {"tensor": 128, "imad": 64}
    assert CP.dot_tiles(129, 257) == 2 * 3
    assert CP.dot_tiles(129, 257, "imad") == 3 * 5
    assert CP.dot_tiles(80, 72) == 1
    assert CP.dot_tiles(4096, 4096) == 1024 and CP.dot_tiles(4096, 4096, "imad") == 4096


@pytest.mark.parametrize("unit", ["tensor", "imad"])
def test_bench_tile_loop_rate(unit):
    """scripts/bench_hopper_prims.py turns the tile loop's statistics into
    multiply-adds a clock and SM with the unit's tile: every shape it runs,
    one SM running all its tiles at one tile per 1000 cycles."""
    bench = _load_script("bench_hopper_prims")
    edge = CP.DOT_TILE[unit]
    for _, shapes in bench.DOT_SHAPES:
        for m, k, n, _label in shapes:
            tiles = -(-m // edge) * -(-n // edge)
            assert CP.dot_tiles(m, n, unit) == tiles
            rate = CP.tile_loop_rate(m, k, n, unit, cycles=1000 * tiles, busiest=tiles)
            assert rate == pytest.approx(m * k * n / tiles / 1000)


def test_tensor_core_operand_checks():
    """What the tensor-core tile's copies refuse: K not a multiple of 16
    (TMA's row stride), a base off 16 bytes. The wrappers refuse other
    operand types before (test_dot_rejects_what_it_does_not_take)."""
    CP.check_tensor_core_operands(torch.zeros((4, 32), dtype=torch.int8), torch.zeros((8, 16), dtype=torch.int8))
    with pytest.raises(ValueError, match="multiple of 16"):
        CP.check_tensor_core_operands(torch.zeros((4, 24), dtype=torch.int8))
    with pytest.raises(ValueError, match="16-byte aligned"):
        CP.check_tensor_core_operands(torch.zeros(4 * 32 + 1, dtype=torch.int8)[1:].view(4, 32))


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


# P7's register instance: a row of 32 E words as 32 lanes of E registers, each
# step's sources fixed at compile time (cuda_probes.roll_add_source)

_REGISTER_COLS = [32 * e for e in CP.ROLL_ADD_WORDS]


def _roll_add_input(rng, shape):
    """Full-range random int32 with 0x80000000 and 0xFFFFFFFF planted."""
    x = _rand(rng, shape, np.int32)
    x[0, :2] = [np.iinfo(np.int32).min, -1]
    return x


class _RandomOnesWithExtremes(_RandomOnes):
    def ones(self, shape, dtype):
        arr = self.rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max + 1, shape).astype(np.int32)
        arr[0, :2] = [np.iinfo(np.int32).min, -1]
        self.made.append(arr)
        return jnp.asarray(arr)


@pytest.mark.parametrize("words", CP.ROLL_ADD_WORDS)
def test_roll_add_source_is_the_cyclic_roll(words):
    """Register j of lane l reads word (l E + j - s) mod 32 E, for every
    lane, register and shift, the shifts above E (E = 1, 2, 4, 8) included:
    the lane wraps mod 32 as the roll wraps within the row."""
    cols = 32 * words
    for shift in range(1, 17):
        for j in range(words):
            q, r = CP.roll_add_source(words, shift, j)
            assert 0 <= r < words and 0 <= q <= -(-shift // words)
            assert (q == 0) == (j >= shift)
            for lane in range(32):
                assert ((lane - q) % 32) * words + r == (lane * words + j - shift) % cols


@pytest.mark.parametrize("reps", [0, 1, 3])
@pytest.mark.parametrize("cols", _REGISTER_COLS)
def test_roll_add_lane_map_matches_chain_roll_add_plain(cols, reps):
    x = _t(_roll_add_input(np.random.default_rng(110 + cols + reps), (3, cols)))
    assert torch.equal(CP.chain_roll_add_lanes_plain(x, reps), CP.chain_roll_add_plain(x, reps))


@pytest.mark.parametrize("cols", _REGISTER_COLS)
def test_roll_add_lane_map_matches_tpu_bench_roll_add(scripts, cols):
    """The TPU kernel at its own chain length (TARGET_SECS = 0: 8 grid steps
    of 16), on random full-range rows with the extremes planted."""
    _, bench = scripts
    shim = _RandomOnesWithExtremes(111)
    bench.jnp = shim
    bench.kept.clear()
    try:
        bench.bench_roll_add(4, cols)
    finally:
        bench.jnp = jnp
    out = CP.chain_roll_add_lanes_plain(_t(shim.made[0]), 8).numpy()
    np.testing.assert_array_equal(out, bench.kept[-1])


def test_roll_add_plan_selects_the_instance_by_shape():
    """Register instance (E) at cols = 32 E for E in ROLL_ADD_WORDS, whatever
    the rows; shared memory (0) at other widths up to 6144; wider rows raise.
    A CPU tensor takes the plain version and counts no launch."""
    assert [CP.roll_add_words(c) for c in (1024, 128, 1024, 2048)] == [32, 4, 32, 64]
    assert [CP.roll_add_words(c) for c in _REGISTER_COLS] == list(CP.ROLL_ADD_WORDS)
    for cols in (17, 96, 4096, 2080, 6144):
        assert CP.roll_add_words(cols) == 0
    for cols in (6145, 8192):
        with pytest.raises(ValueError, match="6144"):
            CP.roll_add_words(cols)
    before = CP.roll_add_launches.copy()
    x = _t(_roll_add_input(np.random.default_rng(112), (2, 64)))
    assert torch.equal(CP.chain_roll_add(x, 2), CP.chain_roll_add_plain(x, 2))
    assert CP.roll_add_launches == before
