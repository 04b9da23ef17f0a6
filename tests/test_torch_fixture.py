"""PyTorch port: the committed JAX fixtures (tests/vectors/torch_port_tiny.npz,
torch_port_tiny_mb.npz, torch_port_tiny_circuits.npz and
torch_port_tiny_radix.npz) that hold the port against the reference on
machines without JAX.

Each fixture is regenerated with JAX and compared with its file, so it cannot
drift; the port reproduces every stored output word for word from the stored
keys and ciphertexts (tolerance 0). chip_smoke.py runs the same comparison on
the card."""

import importlib.util
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from rs_tfhe_tpu_torch import bit_utils, bootstrap, fhe, gates, key, lut  # noqa: E402
from rs_tfhe_tpu_torch.models import arithmetic, circuits, netlist, sort  # noqa: E402
from rs_tfhe_tpu_torch.ops.blind_rotate import (  # noqa: E402
    blind_rotate,
    blind_rotate_mb_plain,
    rotation_exponents,
)
from rs_tfhe_tpu_torch.ops.extract import sample_extract  # noqa: E402
from rs_tfhe_tpu_torch.ops.keyswitch import identity_key_switch  # noqa: E402
from rs_tfhe_tpu_torch.params import TEST_TINY  # noqa: E402
from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_bool, lwe_decrypt_message  # noqa: E402
from rs_tfhe_tpu_torch.torus import to_numpy, to_torch  # noqa: E402


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
VEC = os.path.join(ROOT, "tests", "vectors", "torch_port_tiny.npz")
VEC_MB = os.path.join(ROOT, "tests", "vectors", "torch_port_tiny_mb.npz")
VEC_CIRCUITS = os.path.join(ROOT, "tests", "vectors", "torch_port_tiny_circuits.npz")
VEC_RADIX = os.path.join(ROOT, "tests", "vectors", "torch_port_tiny_radix.npz")


def _load_generator():
    path = os.path.join(ROOT, "scripts", "gen_torch_port_vectors.py")
    spec = importlib.util.spec_from_file_location("gen_torch_port_vectors", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fixture_matches_jax_regeneration():
    stored = np.load(VEC)
    fresh = _load_generator().make_vectors()
    assert sorted(stored.files) == sorted(fresh)
    for name, arr in fresh.items():
        assert stored[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(stored[name], arr, err_msg=name)


def test_mb_fixture_matches_jax_regeneration():
    stored = np.load(VEC_MB)
    fresh = _load_generator().make_vectors_mb()
    assert sorted(stored.files) == sorted(fresh)
    for name, arr in fresh.items():
        assert stored[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(stored[name], arr, err_msg=name)


def test_circuit_fixture_matches_jax_regeneration():
    stored = np.load(VEC_CIRCUITS)
    fresh = _load_generator().make_vectors_circuits()
    assert sorted(stored.files) == sorted(fresh)
    for name, arr in fresh.items():
        assert stored[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(stored[name], arr, err_msg=name)


def test_radix_fixture_matches_jax_regeneration():
    stored = np.load(VEC_RADIX)
    fresh = _load_generator().make_vectors_radix()
    assert sorted(stored.files) == sorted(fresh)
    for name, arr in fresh.items():
        assert stored[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(stored[name], arr, err_msg=name)


def test_port_reproduces_radix_fixture():
    """add_radix (with the multi-bit key, and multi-value with the standard
    one), sub_radix, mul_radix, compare_radix, select_radix, the bit casts,
    sort_radix and the two typed expressions, from the stored JAX keys and
    ciphertexts; the additions decrypt to their sums (the other outputs need
    margins TEST_TINY's N=64 ring does not have: they are held bit for bit)."""
    v = np.load(VEC_RADIX)
    bb = _load_generator().RADIX_BASE_BITS
    sk = key.secret_key_from_numpy({"lv0": v["sk_lv0"], "lv1": v["sk_lv1"]}, TEST_TINY, "cpu")
    ck_mb = key.cloud_key_from_numpy(v, TEST_TINY, "cpu")
    ck = key.cloud_key_from_numpy({k: v[k] for k in ("testvec", "bsk", "ksk_limbs")}, TEST_TINY, "cpu")
    assert ck_mb.bsk_mb is not None and ck.bsk_mb is None
    x, y, sel, srt, u, w = (to_torch(v[n], "cpu") for n in ("ct_x", "ct_y", "ct_sel", "ct_sort", "ct_u", "ct_v"))
    bits = arithmetic.radix_to_bits(x, ck, bb)
    xr, yr = fhe.FheUintRadix(x, bb, ck_mb), fhe.FheUintRadix(y, bb, ck_mb)
    fu, fw = fhe.FheUint(u, ck), fhe.FheUint(w, ck)
    outputs = {
        "add_radix_mv": arithmetic.add_radix(x, y, ck, bb, multi_value=True),
        "sub_radix": arithmetic.sub_radix(x, y, ck, bb),
        "compare_radix": torch.stack(arithmetic.compare_radix(x, y, ck, bb)),
        "radix_to_bits": bits,
        "bits_to_radix": arithmetic.bits_to_radix(bits, ck, bb),
        "add_radix": arithmetic.add_radix(x, y, ck_mb, bb),
        "mul_radix": arithmetic.mul_radix(x, y, ck_mb, bb),
        "select_radix": arithmetic.select_radix(sel, x, y, ck_mb, bb),
        "sort_radix": sort.sort_radix(srt, ck_mb, bb, descending=True),
        "fhe_radix_expr": (xr + yr).max(xr).digits,
        "fhe_uint_expr": ((fu + fw) ^ fw).bits,
    }
    for name, out in outputs.items():
        np.testing.assert_array_equal(to_numpy(out), v[name], err_msg=name)
    total = (v["x"] + v["y"]) % (1 << (2 * bb))
    for name in ("add_radix", "add_radix_mv"):
        np.testing.assert_array_equal(arithmetic.decrypt_radix(outputs[name], sk.lv0, bb), total, err_msg=name)


def test_port_reproduces_circuit_fixture():
    """The netlist evaluator (plain and compiled) on the 4-bit adder,
    add_kogge_stone, mul_csa and multi_value_bootstrap, from the stored JAX
    key and ciphertexts; each decrypts to the integers it should."""
    v = np.load(VEC_CIRCUITS)
    sk = key.secret_key_from_numpy({"lv0": v["sk_lv0"], "lv1": v["sk_lv1"]}, TEST_TINY, "cpu")
    ck = key.cloud_key_from_numpy(v, TEST_TINY, "cpu")
    xs, ys, m, luts = (to_torch(v[n], "cpu") for n in ("ct_x", "ct_y", "ct_m", "luts"))
    width = xs.shape[1]
    ckt, _, _, sums = netlist.ripple_carry_adder(width)
    adder_in = torch.cat([xs[0], ys[0]])
    outputs = {
        "adder_wires": netlist.evaluate(ckt, adder_in, ck),
        "add_kogge_stone": circuits.add_kogge_stone(xs, ys, ck),
        "mul_csa": circuits.mul_csa(xs, ys, ck),
        "multi_value": lut.multi_value_bootstrap(m, lut.factor_test_vectors(list(luts)), ck),
    }
    for name, out in outputs.items():
        np.testing.assert_array_equal(to_numpy(out), v[name], err_msg=name)
    np.testing.assert_array_equal(to_numpy(netlist.compile_circuit(ckt)(adder_in, ck)), v["adder_wires"])
    gen = _load_generator()
    mask = (1 << width) - 1
    (x0, y0) = v["pairs"][0]
    assert bit_utils.decrypt_uint(outputs["adder_wires"][sums], sk.lv0) == (x0 + y0) & mask
    for i, (x, y) in enumerate(v["pairs"]):
        assert bit_utils.decrypt_uint(outputs["add_kogge_stone"][i], sk.lv0) == (x + y) & mask
        assert bit_utils.decrypt_uint(outputs["mul_csa"][i], sk.lv0) == (x * y) & mask
    for k, f in enumerate(gen.MV_FUNCTIONS):
        got = lwe_decrypt_message(outputs["multi_value"][:, k], sk.lv0, gen.MV_MODULUS)
        np.testing.assert_array_equal(got, f(v["msgs"]))


def test_port_reproduces_mb_fixture():
    """The multi-bit rotation, a NAND at B=1 (the multi-bit route), a NAND at
    B=5 (above the route's batch cap: the standard rotation) and LUT
    bootstraps with and without the multi-bit route, from the stored JAX
    multi-bit key."""
    v = np.load(VEC_MB)
    sk = key.secret_key_from_numpy({"lv0": v["sk_lv0"], "lv1": v["sk_lv1"]}, TEST_TINY, "cpu")
    ck = key.cloud_key_from_numpy(v, TEST_TINY, "cpu")
    a, b, m, a5, b5 = (to_torch(v[n], "cpu") for n in ("ct_a", "ct_b", "ct_m", "ct_a5", "ct_b5"))
    lut, lut_per_ct = to_torch(v["lut"], "cpu"), to_torch(v["lut_per_ct"], "cpu")
    b_til, a_til = rotation_exponents(a, TEST_TINY)
    outputs = {
        "blind_rotate_mb": blind_rotate_mb_plain(b_til, a_til, ck.testvec, ck.bsk_mb, TEST_TINY),
        "nand_b1": gates.nand(a[:1], b[:1], ck),
        "nand_b5": gates.nand(a5, b5, ck),
        "pbs_mb": bootstrap.bootstrap_with_testvec(m, lut, ck, allow_mb=True),
        "pbs_std": bootstrap.bootstrap_with_testvec(m, lut, ck, allow_mb=False),
        "pbs_mb_per_ct": bootstrap.bootstrap_with_testvec(m, lut_per_ct, ck, allow_mb=True),
    }
    for name, out in outputs.items():
        np.testing.assert_array_equal(to_numpy(out), v[name], err_msg=name)
    bits, msgs, modulus = v["bits"], v["msgs"], _load_generator().MB_MODULUS
    np.testing.assert_array_equal(lwe_decrypt_bool(outputs["nand_b1"], sk.lv0).numpy(), ~(bits[0, :1] & bits[1, :1]))
    bits5 = v["bits5"]
    np.testing.assert_array_equal(lwe_decrypt_bool(outputs["nand_b5"], sk.lv0).numpy(), ~(bits5[0] & bits5[1]))
    for name in ("pbs_mb", "pbs_std"):
        np.testing.assert_array_equal(lwe_decrypt_message(outputs[name], sk.lv0, modulus), (msgs + 1) % modulus)


def test_port_reproduces_fixture():
    v = np.load(VEC)
    sk = key.secret_key_from_numpy({"lv0": v["sk_lv0"], "lv1": v["sk_lv1"]}, TEST_TINY, "cpu")
    ck = key.cloud_key_from_numpy(v, TEST_TINY, "cpu")
    a, b, c = (to_torch(v[n], "cpu") for n in ("ct_a", "ct_b", "ct_c"))
    acc = blind_rotate(a, ck.testvec, ck.bsk, TEST_TINY)
    lv1 = sample_extract(acc, 0)
    outputs = {
        "blind_rotate": acc,
        "sample_extract": lv1,
        "identity_key_switch": identity_key_switch(lv1, ck.ksk_limbs, TEST_TINY),
        "nand": gates.nand(a, b, ck),
        "mux": gates.mux(a, b, c, ck),
    }
    for name, out in outputs.items():
        np.testing.assert_array_equal(to_numpy(out), v[name], err_msg=name)
    bits = v["bits"]
    np.testing.assert_array_equal(lwe_decrypt_bool(outputs["nand"], sk.lv0).numpy(), ~(bits[0] & bits[1]))


def test_port_reproduces_golden_tiny():
    """Second anchor: the JAX package's own pinned vectors
    (tests/vectors/golden_tiny.npz, scripts/gen_golden_vectors.py). Its keys
    are regenerated from the generator's seeds and carried into the port."""
    import jax
    import jax.numpy as jnp

    from rs_tfhe_tpu.key import CloudKey as JCloudKey
    from rs_tfhe_tpu.key import SecretKey as JSecretKey
    from rs_tfhe_tpu.params import TEST_TINY as J_TINY
    from rs_tfhe_tpu.tlwe import lwe_encrypt_bool as j_encrypt

    gold = np.load(os.path.join(ROOT, "tests", "vectors", "golden_tiny.npz"))
    jsk = JSecretKey.generate(jax.random.key(777), J_TINY)
    jck = JCloudKey.generate(jax.random.key(778), jsk)
    np.testing.assert_array_equal(np.asarray(jsk.lv0), gold["sk_lv0"])
    bits = jnp.asarray([True, False, True, True, False, False, True, False])
    jb = j_encrypt(jax.random.key(780), jsk.lv0, ~bits, J_TINY.tlwe_lv0.alpha)
    ck = key.cloud_key_from_numpy(
        {"testvec": np.asarray(jck.testvec), "bsk": np.asarray(jck.bsk),
         "ksk_limbs": np.asarray(jck.ksk_limbs)},
        TEST_TINY, "cpu",
    )
    a, b = to_torch(gold["ct_a"], "cpu"), to_torch(np.asarray(jb), "cpu")
    acc = blind_rotate(gates._nand_lin(a, b), ck.testvec, ck.bsk, TEST_TINY)
    lv1 = sample_extract(acc, 0)
    outputs = {
        "blind_rotate_out": acc,
        "extract_out": lv1,
        "keyswitch_out": identity_key_switch(lv1, ck.ksk_limbs, TEST_TINY),
        "nand_out": gates.nand(a, b, ck),
        "mux_out": gates.mux(a, b, a, ck),
    }
    for name, out in outputs.items():
        np.testing.assert_array_equal(to_numpy(out), gold[name], err_msg=name)


def test_port_runs_with_jax_blocked():
    """`import rs_tfhe_tpu_torch`, every module of the circuit, radix, sort
    and typed-API paths, the probe wrappers, the probe and bench scripts and
    chip_smoke.py, and one TEST_TINY NAND, with `jax` and the JAX package
    `rs_tfhe_tpu` blocked from import (the GPU machine has no JAX, and the
    port keeps its own copy of what it needs)."""
    code = """
import runpy, sys
sys.modules["jax"] = None
sys.modules["rs_tfhe_tpu"] = None
import torch
import rs_tfhe_tpu_torch as pt
from rs_tfhe_tpu_torch import bit_utils, fhe, gates, key, lut, models, tlwe
from rs_tfhe_tpu_torch.lut import multi_value
from rs_tfhe_tpu_torch.models import arithmetic, circuits, netlist, sort
from rs_tfhe_tpu_torch.ops import cuda_probes
for script in ("scripts/probe_hopper.py", "scripts/bench_hopper_prims.py", "scripts/bench_hopper_rotation.py",
               "chip_smoke.py"):
    runpy.run_path(script, run_name="not_main")
p = pt.TEST_TINY
g = torch.Generator().manual_seed(0)
sk = key.SecretKey.generate(p, g)
ck = key.CloudKey.generate(sk, g)
a = tlwe.lwe_encrypt_bool(g, sk.lv0, [True, True, False, False], p.tlwe_lv0.alpha)
b = tlwe.lwe_encrypt_bool(g, sk.lv0, [True, False, True, False], p.tlwe_lv0.alpha)
out = tlwe.lwe_decrypt_bool(gates.nand(a, b, ck), sk.lv0).tolist()
assert out == [False, True, True, True], out
assert not any(m == "jax" or m.startswith(("jax.", "rs_tfhe_tpu.")) for m in sys.modules if sys.modules[m] is not None)
print("ok")
"""
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
