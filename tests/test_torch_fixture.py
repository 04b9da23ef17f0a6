"""PyTorch port: the committed JAX fixture (tests/vectors/torch_port_tiny.npz)
that holds the port against the reference on machines without JAX.

The fixture is regenerated with JAX and compared with the file, so it cannot
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

from rs_tfhe_tpu_torch import gates, key  # noqa: E402
from rs_tfhe_tpu_torch.ops.blind_rotate import blind_rotate  # noqa: E402
from rs_tfhe_tpu_torch.ops.extract import sample_extract  # noqa: E402
from rs_tfhe_tpu_torch.ops.keyswitch import identity_key_switch  # noqa: E402
from rs_tfhe_tpu_torch.params import TEST_TINY  # noqa: E402
from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_bool  # noqa: E402
from rs_tfhe_tpu_torch.torus import to_numpy, to_torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VEC = os.path.join(ROOT, "tests", "vectors", "torch_port_tiny.npz")


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


def test_port_reproduces_fixture():
    v = np.load(VEC)
    sk = key.secret_key_from_numpy({"lv0": v["sk_lv0"], "lv1": v["sk_lv1"]}, TEST_TINY)
    ck = key.cloud_key_from_numpy(v, TEST_TINY)
    a, b, c = (to_torch(v[n]) for n in ("ct_a", "ct_b", "ct_c"))
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
        TEST_TINY,
    )
    a, b = to_torch(gold["ct_a"]), to_torch(np.asarray(jb))
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
    """`import rs_tfhe_tpu_torch` and one TEST_TINY NAND with `jax` blocked
    from import (the GPU machine has no JAX)."""
    code = """
import sys
sys.modules["jax"] = None
import torch
import rs_tfhe_tpu_torch as pt
from rs_tfhe_tpu_torch import gates, key, tlwe
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
