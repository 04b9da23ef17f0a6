"""Generate tests/vectors/torch_port_tiny.npz — JAX-made TEST_TINY key
material, ciphertexts and pipeline outputs that the PyTorch port must
reproduce bit for bit.

The file lets a machine without JAX (the one with the GPU) hold the port
against the reference: `chip_smoke.py` loads the keys and ciphertexts into
the port on the card and compares its outputs with the stored ones.
tests/test_torch_fixture.py regenerates the arrays with JAX and asserts they
equal the file, so the fixture cannot drift from the reference.

Usage: python scripts/gen_torch_port_vectors.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")  # TEST_TINY is bit-exact on every backend

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rs_tfhe_tpu import gates  # noqa: E402
from rs_tfhe_tpu.key import CloudKey, SecretKey  # noqa: E402
from rs_tfhe_tpu.ops.blind_rotate import blind_rotate  # noqa: E402
from rs_tfhe_tpu.ops.extract import sample_extract  # noqa: E402
from rs_tfhe_tpu.ops.keyswitch import identity_key_switch  # noqa: E402
from rs_tfhe_tpu.params import TEST_TINY  # noqa: E402
from rs_tfhe_tpu.tlwe import lwe_encrypt_bool  # noqa: E402

OUT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "tests", "vectors", "torch_port_tiny.npz"
)


def make_vectors() -> dict:
    """All fixture arrays as numpy, from fixed seeds."""
    p = TEST_TINY
    sk = SecretKey.generate(jax.random.key(2024), p)
    ck = CloudKey.generate(jax.random.key(2025), sk)
    rng = np.random.default_rng(2026)
    bits = rng.integers(0, 2, (3, 8)).astype(bool)
    ka, kb, kc = jax.random.split(jax.random.key(2027), 3)
    a = lwe_encrypt_bool(ka, sk.lv0, jnp.asarray(bits[0]), p.tlwe_lv0.alpha)
    b = lwe_encrypt_bool(kb, sk.lv0, jnp.asarray(bits[1]), p.tlwe_lv0.alpha)
    c = lwe_encrypt_bool(kc, sk.lv0, jnp.asarray(bits[2]), p.tlwe_lv0.alpha)

    acc = blind_rotate(a, ck.testvec, ck.bsk, p)
    lv1 = sample_extract(acc, 0)
    out = {
        "sk_lv0": sk.lv0, "sk_lv1": sk.lv1,
        "testvec": ck.testvec, "bsk": ck.bsk, "ksk_limbs": ck.ksk_limbs,
        "bits": bits, "ct_a": a, "ct_b": b, "ct_c": c,
        "blind_rotate": acc,
        "sample_extract": lv1,
        "identity_key_switch": identity_key_switch(lv1, ck.ksk_limbs, p),
        "nand": gates.nand(a, b, ck),
        "mux": gates.mux(a, b, c, ck),
    }
    return {k: np.asarray(v) for k, v in out.items()}


def main():
    np.savez_compressed(OUT, **make_vectors())
    print(f"wrote {os.path.normpath(OUT)} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
