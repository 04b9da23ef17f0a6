"""Generate the JAX-made TEST_TINY fixtures that the PyTorch port must
reproduce bit for bit:

  tests/vectors/torch_port_tiny.npz     key material, ciphertexts and the
                                        gate pipeline's outputs;
  tests/vectors/torch_port_tiny_mb.npz  a multi-bit key, the multi-bit
                                        rotation's output, a NAND at B=1
                                        through the multi-bit route, and LUT
                                        programmable bootstraps with and
                                        without the multi-bit route.

The files let a machine without JAX (the one with the GPU) hold the port
against the reference: `chip_smoke.py` loads the keys and ciphertexts into
the port on the card and compares its outputs with the stored ones.
tests/test_torch_fixture.py regenerates the arrays with JAX and asserts they
equal the files, so the fixtures cannot drift from the reference.

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
from rs_tfhe_tpu.bootstrap import bootstrap_with_testvec  # noqa: E402
from rs_tfhe_tpu.key import CloudKey, SecretKey  # noqa: E402
from rs_tfhe_tpu.lut.generator import Generator  # noqa: E402
from rs_tfhe_tpu.ops.blind_rotate import blind_rotate, blind_rotate_mb  # noqa: E402
from rs_tfhe_tpu.ops.extract import sample_extract  # noqa: E402
from rs_tfhe_tpu.ops.keyswitch import identity_key_switch  # noqa: E402
from rs_tfhe_tpu.params import TEST_TINY  # noqa: E402
from rs_tfhe_tpu.tlwe import lwe_encrypt_bool, lwe_encrypt_message  # noqa: E402

VECTORS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests", "vectors")
OUT = os.path.join(VECTORS, "torch_port_tiny.npz")
OUT_MB = os.path.join(VECTORS, "torch_port_tiny_mb.npz")
#: message modulus of the LUT bootstraps in the multi-bit fixture
MB_MODULUS = 4


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


def make_vectors_mb() -> dict:
    """The multi-bit fixture's arrays as numpy, from fixed seeds. Batches
    are 1 and 2, which both packages route through the multi-bit rotation."""
    p = TEST_TINY
    sk = SecretKey.generate(jax.random.key(3024), p)
    ck = CloudKey.generate(jax.random.key(3025), sk, multibit=True)
    rng = np.random.default_rng(3026)
    bits = rng.integers(0, 2, (2, 2)).astype(bool)
    msgs = rng.integers(0, MB_MODULUS, 2)
    ka, kb, km = jax.random.split(jax.random.key(3027), 3)
    a = lwe_encrypt_bool(ka, sk.lv0, jnp.asarray(bits[0]), p.tlwe_lv0.alpha)
    b = lwe_encrypt_bool(kb, sk.lv0, jnp.asarray(bits[1]), p.tlwe_lv0.alpha)
    m = lwe_encrypt_message(km, sk.lv0, jnp.asarray(msgs), MB_MODULUS, p.tlwe_lv0.alpha)
    gen = Generator(MB_MODULUS, p)
    lut = gen.generate_lookup_table(lambda x: (x + 1) % MB_MODULUS).poly
    lut_per_ct = jnp.stack([
        gen.generate_lookup_table(lambda x: (3 * x) % MB_MODULUS).poly,
        gen.generate_lookup_table(lambda x: (x * x) % MB_MODULUS).poly,
    ])
    out = {
        "sk_lv0": sk.lv0, "sk_lv1": sk.lv1,
        "testvec": ck.testvec, "bsk": ck.bsk, "ksk_limbs": ck.ksk_limbs, "bsk_mb": ck.bsk_mb,
        "bits": bits, "msgs": msgs, "ct_a": a, "ct_b": b, "ct_m": m,
        "lut": lut, "lut_per_ct": lut_per_ct,
        "blind_rotate_mb": blind_rotate_mb(a, ck.testvec, ck.bsk_mb, p),
        "nand_b1": gates.nand(a[:1], b[:1], ck),
        "pbs_mb": bootstrap_with_testvec(m, lut, ck, allow_mb=True),
        "pbs_std": bootstrap_with_testvec(m, lut, ck, allow_mb=False),
        "pbs_mb_per_ct": bootstrap_with_testvec(m, lut_per_ct, ck, allow_mb=True),
    }
    return {k: np.asarray(v) for k, v in out.items()}


def main():
    for path, make in ((OUT, make_vectors), (OUT_MB, make_vectors_mb)):
        np.savez_compressed(path, **make())
        print(f"wrote {os.path.normpath(path)} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main()
