"""PyTorch port: the multi-device paths (rs_tfhe_tpu_torch.parallel) on a
mesh of CPU devices, held bit for bit (tolerance 0) against the JAX package's
rs_tfhe_tpu.parallel on its 8 virtual CPU devices.

The JAX outputs come from the committed fixture
tests/vectors/torch_port_tiny_parallel.npz (scripts/gen_torch_port_vectors.py
`make_vectors_parallel`), which the first test regenerates with JAX and
compares with the file; every case of tests/test_parallel.py is mirrored on
the fixture's keys and ciphertexts, beside the port's own single-device
outputs. chip_smoke.py replays the fixture on the card."""

import importlib.util
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from rs_tfhe_tpu_torch import bootstrap, gates, key, parallel  # noqa: E402
from rs_tfhe_tpu_torch.params import TEST_TINY  # noqa: E402
from rs_tfhe_tpu_torch.parallel import dryrun  # noqa: E402
from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_bool, lwe_decrypt_message  # noqa: E402
from rs_tfhe_tpu_torch.torus import to_numpy, to_torch  # noqa: E402
from rs_tfhe_tpu_torch.utils import profiling  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port: the suite runs six workers on the
    machine's cores, and torch's default of a thread a core oversubscribes
    them (the JAX side keeps its own pool)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VEC = os.path.join(ROOT, "tests", "vectors", "torch_port_tiny_parallel.npz")
CPU8 = ["cpu"] * 8


def _load_generator():
    path = os.path.join(ROOT, "scripts", "gen_torch_port_vectors.py")
    spec = importlib.util.spec_from_file_location("gen_torch_port_vectors", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fx():
    """The fixture's arrays, its keys on the CPU (the standard key is the
    multi-bit key without bsk_mb) and its ciphertexts as tensors."""
    v = np.load(VEC)
    ck_mb = key.cloud_key_from_numpy(v, TEST_TINY, "cpu")
    ck = key.cloud_key_from_numpy({k: v[k] for k in ("testvec", "bsk", "ksk_limbs")}, TEST_TINY, "cpu")
    sk = key.secret_key_from_numpy({"lv0": v["sk_lv0"], "lv1": v["sk_lv1"]}, TEST_TINY, "cpu")
    ct = {n: to_torch(v[n], "cpu") for n in ("ct_a", "ct_b", "ct_c", "ct_m3", "ct_m2")}
    return v, sk, ck, ck_mb, ct


def _mesh(n, tp=1):
    return parallel.make_mesh(n, tp=tp, devices=CPU8)


def _equal(out, v, name):
    np.testing.assert_array_equal(to_numpy(out), v[name], err_msg=name)


def test_parallel_fixture_matches_jax_regeneration():
    stored = np.load(VEC)
    fresh = _load_generator().make_vectors_parallel()
    assert sorted(stored.files) == sorted(fresh)
    for name, arr in fresh.items():
        assert stored[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(stored[name], arr, err_msg=name)


def test_data_parallel_nand_matches_plaintext(fx):
    """B = 11 on 8 devices: padded to 16, pad rows dropped."""
    v, sk, ck, _, ct = fx
    out = parallel.data_parallel_gate("nand", ct["ct_a"][:11], ct["ct_b"][:11], ck, _mesh(8))
    _equal(out, v, "dp_nand_b11_on8")
    bits = v["bits"]
    np.testing.assert_array_equal(lwe_decrypt_bool(out, sk.lv0).numpy(), ~(bits[0, :11] & bits[1, :11]))


def test_data_parallel_matches_single_device(fx):
    v, _, ck, _, ct = fx
    a, b = ct["ct_a"][:8], ct["ct_b"][:8]
    out = parallel.data_parallel_gate("xor", a, b, ck, _mesh(4))
    _equal(out, v, "dp_xor_b8_on4")
    assert torch.equal(out, gates.xor(a, b, ck))


@pytest.mark.parametrize("tp", [2])  # tp must divide 2L = 6 and N = 64 (TEST_TINY)
def test_tensor_parallel_bitexact_vs_single_device(fx, tp):
    """The shards' partial products, all-reduced, equal the single-device
    bootstrap bit for bit; with J = 2L/tp = 3 rows a shard."""
    v, _, ck, _, ct = fx
    a, b = ct["ct_a"][:8], ct["ct_b"][:8]
    before = profiling.counters()["k5.launches"]
    out = parallel.tensor_parallel_gate("and", a, b, ck, _mesh(8, tp=tp))
    assert profiling.counters()["k5.launches"] == before  # the plain product on CPU tensors
    _equal(out, v, "tp_and_b8_on4x2")
    assert torch.equal(out, gates.and_(a, b, ck))


def test_tensor_parallel_gate_decrypts(fx):
    v, sk, ck, _, ct = fx
    out = parallel.tensor_parallel_gate("or", ct["ct_a"][:8], ct["ct_b"][:8], ck, _mesh(8, tp=2))
    _equal(out, v, "tp_or_b8_on4x2")
    bits = v["bits"]
    np.testing.assert_array_equal(lwe_decrypt_bool(out, sk.lv0).numpy(), bits[0, :8] | bits[1, :8])


def test_data_parallel_mux_matches_single_device(fx):
    v, sk, ck, _, ct = fx
    s, x, y = ct["ct_a"][:8], ct["ct_b"][:8], ct["ct_c"][:8]
    out = parallel.data_parallel_mux(s, x, y, ck, _mesh(4))
    _equal(out, v, "dp_mux_b8_on4")
    assert torch.equal(out, gates.mux(s, x, y, ck))
    bits = v["bits"][:, :8]
    np.testing.assert_array_equal(lwe_decrypt_bool(out, sk.lv0).numpy(), np.where(bits[0], bits[1], bits[2]))


def test_data_parallel_lut_bootstrap(fx):
    v, sk, ck, _, ct = fx
    f = _load_generator().PARALLEL_DP_LUT
    out = parallel.data_parallel_lut_bootstrap(ct["ct_m3"], f, 4, ck, _mesh(4))
    _equal(out, v, "dp_lut_b8_on4")
    np.testing.assert_array_equal(lwe_decrypt_message(out, sk.lv0, 4), (3 * v["msgs"]) % 4)


def test_tensor_parallel_lut_bootstrap_bitexact(fx):
    v, sk, ck, _, ct = fx
    f = _load_generator().PARALLEL_TP_LUT
    out = parallel.tensor_parallel_lut_bootstrap(ct["ct_m2"], f, 4, ck, _mesh(8, tp=2))
    _equal(out, v, "tp_lut_b8_on4x2")
    assert torch.equal(out, bootstrap.LutBootstrap().bootstrap_func(ct["ct_m2"], f, 4, ck))
    np.testing.assert_array_equal(lwe_decrypt_message(out, sk.lv0, 4), (v["msgs"] + 2) % 4)


def test_data_parallel_mb_key_routes_by_local_batch(fx):
    """With a multi-bit key, B = 16 on 4 devices gives 4-row shards, each at
    or below mb_route_batch_cap (4 at TEST_TINY): every shard takes the
    multi-bit rotation, as under JAX's shard_map, while one device at B = 16
    takes the standard one. The output equals JAX's data-parallel output and
    differs from the single-device one."""
    v, sk, _, ck_mb, ct = fx
    a, b = ct["ct_a"], ct["ct_b"]
    out = parallel.data_parallel_gate("nand", a, b, ck_mb, _mesh(4))
    _equal(out, v, "dp_nand_mb_b16_on4")
    assert not torch.equal(out, gates.nand(a, b, ck_mb))
    assert torch.equal(out, torch.cat([gates.nand(a[i:i + 4], b[i:i + 4], ck_mb) for i in range(0, 16, 4)]))
    bits = v["bits"]
    np.testing.assert_array_equal(lwe_decrypt_bool(out, sk.lv0).numpy(), ~(bits[0] & bits[1]))


def test_data_parallel_mb_key_padded_shards(fx):
    """B = 11 on 8 devices pads to 16: 2-row shards, each on the multi-bit
    rotation; the last shard's pad row takes part in its route, as in JAX."""
    v, sk, _, ck_mb, ct = fx
    a, b = ct["ct_a"][:11], ct["ct_b"][:11]
    out = parallel.data_parallel_gate("nand", a, b, ck_mb, _mesh(8))
    a16, _ = parallel.pad_to_multiple(a, 8)
    b16, _ = parallel.pad_to_multiple(b, 8)
    want = torch.cat([gates.nand(a16[i:i + 2], b16[i:i + 2], ck_mb) for i in range(0, 16, 2)])[:11]
    assert torch.equal(out, want)
    assert not torch.equal(out, gates.nand(a, b, ck_mb))
    bits = v["bits"]
    np.testing.assert_array_equal(lwe_decrypt_bool(out, sk.lv0).numpy(), ~(bits[0, :11] & bits[1, :11]))


def test_tensor_parallel_ignores_bsk_mb(fx):
    """Tensor parallel always takes the CMUX rotation: a multi-bit key gives
    the standard key's output (JAX's fixture)."""
    v, _, _, ck_mb, ct = fx
    out = parallel.tensor_parallel_gate("and", ct["ct_a"][:8], ct["ct_b"][:8], ck_mb, _mesh(8, tp=2))
    _equal(out, v, "tp_and_b8_on4x2")


@pytest.mark.parametrize("tp", [3, 4, 6])
def test_tensor_parallel_needs_tp_dividing_2l_and_n(fx, tp):
    """TEST_TINY: 2L = 6, N = 64. tp = 3 and 6 divide 2L but not N; 4 divides
    N but not 2L."""
    _, _, ck, _, ct = fx
    mesh = parallel.make_mesh(tp, tp=tp, devices=["cpu"] * tp)
    with pytest.raises(ValueError, match="must divide"):
        parallel.tensor_parallel_gate("and", ct["ct_a"][:2], ct["ct_b"][:2], ck, mesh)


def test_tensor_parallel_needs_a_divisible_batch(fx):
    _, _, ck, _, ct = fx
    with pytest.raises(ValueError, match="not divisible"):
        parallel.tensor_parallel_gate("and", ct["ct_a"][:5], ct["ct_b"][:5], ck, _mesh(8, tp=2))


def test_make_mesh_shapes_and_errors():
    mesh = parallel.make_mesh(8, tp=2, devices=CPU8)
    assert mesh.shape == {parallel.BATCH_AXIS: 4, parallel.MODEL_AXIS: 2}
    assert len(mesh.devices) == 4 and all(len(row) == 2 for row in mesh.devices)
    assert mesh.flat == tuple(torch.device("cpu") for _ in range(8))
    assert parallel.make_mesh(devices=["cpu"] * 3).shape == {"batch": 3, "model": 1}
    assert parallel.make_mesh(4, devices=CPU8).shape == {"batch": 4, "model": 1}
    with pytest.raises(ValueError, match="not divisible"):
        parallel.make_mesh(6, tp=4, devices=CPU8)
    with pytest.raises(ValueError, match="devices given"):
        parallel.make_mesh(9, devices=CPU8)
    assert parallel.batch_spec(2) == (parallel.BATCH_AXIS, None)
    assert hash(mesh) == hash(parallel.make_mesh(8, tp=2, devices=CPU8))


def test_make_mesh_without_devices_needs_cuda(monkeypatch):
    """make_mesh() and make_multihost_mesh() take every visible CUDA device
    and raise where there is none (no silent CPU mesh)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_multihost_mesh(tp=2)


def test_pad_shard_replicate_and_all_reduce(fx):
    _, _, ck, _, _ = fx
    x = torch.arange(22, dtype=torch.int32).reshape(11, 2)
    padded, size = parallel.pad_to_multiple(x, 4)
    assert size == 11 and padded.shape == (12, 2)
    assert torch.equal(padded[:11], x) and not padded[11:].any()
    assert parallel.pad_to_multiple(x, 11)[0] is x
    mesh = _mesh(4)
    parts = parallel.shard_batch(padded, mesh)
    assert [p.shape[0] for p in parts] == [3] * 4 and torch.equal(torch.cat(parts), padded)
    with pytest.raises(ValueError, match="not divisible"):
        parallel.shard_batch(x, mesh)
    keys = parallel.replicate(ck, mesh)
    assert list(keys) == [torch.device("cpu")]  # one copy for the repeated device
    k = keys[torch.device("cpu")]
    assert k.bsk is ck.bsk and k.ksk_limbs is ck.ksk_limbs and k.bsk_mb is None  # nothing to move
    big = torch.tensor([(1 << 31) - 1, -(1 << 31)], dtype=torch.int32)
    sums = parallel.all_reduce_sum([big, big, torch.ones(2, dtype=torch.int32)])
    assert all(s is sums[0] for s in sums)
    assert torch.equal(sums[0], torch.tensor([-1, 1], dtype=torch.int32))  # wraps mod 2^32
    assert torch.equal(parallel.reduce_sum([big, big, big], torch.device("cpu")),
                       torch.tensor([(1 << 31) - 3, -(1 << 31)], dtype=torch.int32))


def test_keys_placed_once_equal_keys_placed_per_call(fx):
    """A key placed once (replicate for data parallel, shard_key for tensor
    parallel) gives the fixture's outputs; a placed key made for another mesh,
    or missing a device, is refused."""
    v, _, ck, _, ct = fx
    a, b = ct["ct_a"][:8], ct["ct_b"][:8]
    mesh4, mesh42 = _mesh(4), _mesh(8, tp=2)
    placed = parallel.replicate(ck, mesh4)
    _equal(parallel.data_parallel_gate("xor", a, b, placed, mesh4), v, "dp_xor_b8_on4")
    _equal(parallel.data_parallel_mux(a, b, ct["ct_c"][:8], placed, mesh4), v, "dp_mux_b8_on4")
    f = _load_generator().PARALLEL_DP_LUT
    _equal(parallel.data_parallel_lut_bootstrap(ct["ct_m3"], f, 4, placed, mesh4), v, "dp_lut_b8_on4")
    sharded = parallel.shard_key(ck, mesh42)
    _equal(parallel.tensor_parallel_gate("and", a, b, sharded, mesh42), v, "tp_and_b8_on4x2")
    _equal(parallel.tensor_parallel_gate("or", a, b, sharded, mesh42), v, "tp_or_b8_on4x2")
    f = _load_generator().PARALLEL_TP_LUT
    _equal(parallel.tensor_parallel_lut_bootstrap(ct["ct_m2"], f, 4, sharded, mesh42), v, "tp_lut_b8_on4x2")
    with pytest.raises(ValueError, match="another mesh"):
        parallel.tensor_parallel_gate("and", a, b, sharded, _mesh(4, tp=2))
    with pytest.raises(ValueError, match="no copy"):
        parallel.data_parallel_gate("xor", a, b, {}, mesh4)


def test_dryrun_multichip_on_cpu_devices():
    dryrun.dryrun_multichip(8, CPU8)


def test_parallel_and_nussbaumer_run_with_jax_blocked():
    """`parallel` (mesh, sharded, dryrun), `ops.nussbaumer` and the port's
    example import and run with `jax` and the JAX package blocked: the
    card's machine has no JAX, and the port keeps its own helpers."""
    import subprocess
    import sys

    code = """
import runpy, sys
sys.modules["jax"] = None
sys.modules["rs_tfhe_tpu"] = None
import torch
from rs_tfhe_tpu_torch import config, gates, key, tlwe
from rs_tfhe_tpu_torch.ops import nussbaumer
from rs_tfhe_tpu_torch.parallel import dryrun, mesh, sharded
runpy.run_path("examples/torch/multi_chip_scaling.py", run_name="not_main")
dryrun.dryrun_multichip(2, ["cpu"] * 2)
p = __import__("rs_tfhe_tpu_torch").TEST_TINY
g = torch.Generator().manual_seed(0)
sk = key.SecretKey.generate(p, g)
ck = key.CloudKey.generate(sk, g)
a = tlwe.lwe_encrypt_bool(g, sk.lv0, [True, True, False, False], p.tlwe_lv0.alpha)
b = tlwe.lwe_encrypt_bool(g, sk.lv0, [True, False, True, False], p.tlwe_lv0.alpha)
config.config.step_impl = "nussbaumer"
assert tlwe.lwe_decrypt_bool(gates.nand(a, b, ck), sk.lv0).tolist() == [False, True, True, True]
assert not any(m == "jax" or m.startswith(("jax.", "rs_tfhe_tpu.")) for m in sys.modules if sys.modules[m] is not None)
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
