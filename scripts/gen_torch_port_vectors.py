"""Generate the JAX-made TEST_TINY fixtures that the PyTorch port must
reproduce bit for bit:

  tests/vectors/torch_port_tiny.npz     key material, ciphertexts and the
                                        gate pipeline's outputs;
  tests/vectors/torch_port_tiny_mb.npz  a multi-bit key, the multi-bit
                                        rotation's output, a NAND at B=1
                                        through the multi-bit route, a NAND
                                        at B=5 (above the route's batch cap:
                                        the standard rotation), and LUT
                                        programmable bootstraps with and
                                        without the multi-bit route;
  tests/vectors/torch_port_tiny_circuits.npz
                                        a key, encrypted integers and the
                                        outputs of the circuit path: the
                                        netlist evaluator on a 4-bit
                                        ripple-carry adder, add_kogge_stone,
                                        mul_csa and multi_value_bootstrap;
  tests/vectors/torch_port_tiny_radix.npz
                                        a standard and a multi-bit key,
                                        radix ciphertexts and the outputs of
                                        radix arithmetic (add_radix both
                                        ways, sub_radix, mul_radix,
                                        compare_radix, select_radix, the
                                        bit casts, sort_radix) and of one
                                        FheUintRadix and one FheUint
                                        expression;
  tests/vectors/torch_port_tiny_parallel.npz
                                        a multi-bit key (whose bsk and
                                        ksk_limbs are also the standard key),
                                        ciphertexts and the multi-device
                                        paths' outputs on JAX's virtual CPU
                                        devices: data-parallel NAND (B=11 on
                                        8 devices, padded), XOR, MUX and LUT
                                        (B=8 on 4), the multi-bit key's
                                        data-parallel NAND (B=16 on 4: 4-row
                                        shards, each on the multi-bit
                                        rotation), tensor-parallel AND, OR
                                        and LUT (B=8 on a (4, 2) mesh), and a
                                        NAND at B=4 under
                                        step_impl="nussbaumer".

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

# the parallel fixture runs on 8 virtual CPU devices; XLA reads the flag once,
# before jax is first imported (tests/conftest.py sets it for the tests)
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")  # TEST_TINY is bit-exact on every backend

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rs_tfhe_tpu import bit_utils, config, fhe, gates, parallel  # noqa: E402
from rs_tfhe_tpu.bootstrap import bootstrap_with_testvec  # noqa: E402
from rs_tfhe_tpu.key import CloudKey, SecretKey  # noqa: E402
from rs_tfhe_tpu.lut.generator import Generator  # noqa: E402
from rs_tfhe_tpu.lut.multi_value import factor_test_vectors, multi_value_bootstrap  # noqa: E402
from rs_tfhe_tpu.models import arithmetic, circuits, netlist, sort  # noqa: E402
from rs_tfhe_tpu.ops.blind_rotate import blind_rotate, blind_rotate_mb  # noqa: E402
from rs_tfhe_tpu.ops.extract import sample_extract  # noqa: E402
from rs_tfhe_tpu.ops.keyswitch import identity_key_switch  # noqa: E402
from rs_tfhe_tpu.params import TEST_TINY  # noqa: E402
from rs_tfhe_tpu.tlwe import lwe_encrypt_bool, lwe_encrypt_message  # noqa: E402

VECTORS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests", "vectors")
OUT = os.path.join(VECTORS, "torch_port_tiny.npz")
OUT_MB = os.path.join(VECTORS, "torch_port_tiny_mb.npz")
OUT_CIRCUITS = os.path.join(VECTORS, "torch_port_tiny_circuits.npz")
OUT_RADIX = os.path.join(VECTORS, "torch_port_tiny_radix.npz")
OUT_PARALLEL = os.path.join(VECTORS, "torch_port_tiny_parallel.npz")
#: digit base and operands of the radix fixture (two base-4 digits)
RADIX_BASE_BITS = 2
RADIX_X, RADIX_Y = (13, 6), (9, 11)
RADIX_SORT = (1, 3)
UINT_WIDTH = 3
#: bit width, operand pairs and LUT family of the circuit fixture
CIRCUIT_WIDTH = 4
CIRCUIT_PAIRS = ((11, 6), (5, 13))
MV_MODULUS = 4
MV_FUNCTIONS = (lambda x: (x + 1) % MV_MODULUS, lambda x: (3 * x) % MV_MODULUS)
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
    """The multi-bit fixture's arrays as numpy, from fixed seeds. Batches 1
    and 2 take the multi-bit rotation in both packages; the NAND at B=5 is
    above `mb_route_batch_cap` (4 at TEST_TINY) and takes the standard one."""
    p = TEST_TINY
    sk = SecretKey.generate(jax.random.key(3024), p)
    ck = CloudKey.generate(jax.random.key(3025), sk, multibit=True)
    rng = np.random.default_rng(3026)
    bits = rng.integers(0, 2, (2, 2)).astype(bool)
    msgs = rng.integers(0, MB_MODULUS, 2)
    bits5 = rng.integers(0, 2, (2, 5)).astype(bool)
    ka, kb, km = jax.random.split(jax.random.key(3027), 3)
    ka5, kb5 = jax.random.split(jax.random.key(3028), 2)
    a5 = lwe_encrypt_bool(ka5, sk.lv0, jnp.asarray(bits5[0]), p.tlwe_lv0.alpha)
    b5 = lwe_encrypt_bool(kb5, sk.lv0, jnp.asarray(bits5[1]), p.tlwe_lv0.alpha)
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
        "bits5": bits5, "ct_a5": a5, "ct_b5": b5,
        "nand_b5": gates.nand(a5, b5, ck),
        "pbs_mb": bootstrap_with_testvec(m, lut, ck, allow_mb=True),
        "pbs_std": bootstrap_with_testvec(m, lut, ck, allow_mb=False),
        "pbs_mb_per_ct": bootstrap_with_testvec(m, lut_per_ct, ck, allow_mb=True),
    }
    return {k: np.asarray(v) for k, v in out.items()}


def make_vectors_circuits() -> dict:
    """The circuit fixture's arrays as numpy, from fixed seeds: a standard
    key; the pairs of CIRCUIT_PAIRS encrypted bit by bit ([pair, W, n0+1]);
    every wire of ripple_carry_adder(W) on the first pair (python planner);
    add_kogge_stone and mul_csa on the batch of pairs; multi_value_bootstrap
    of the messages 0..MV_MODULUS-1 with the MV_FUNCTIONS family."""
    p = TEST_TINY
    sk = SecretKey.generate(jax.random.key(4024), p)
    ck = CloudKey.generate(jax.random.key(4025), sk)
    keys = jax.random.split(jax.random.key(4026), 2 * len(CIRCUIT_PAIRS) + 1)

    def enc(i, val):
        return bit_utils.encrypt_uint(keys[i], sk.lv0, val, CIRCUIT_WIDTH, p.tlwe_lv0.alpha)

    xs = jnp.stack([enc(2 * i, x) for i, (x, _) in enumerate(CIRCUIT_PAIRS)])
    ys = jnp.stack([enc(2 * i + 1, y) for i, (_, y) in enumerate(CIRCUIT_PAIRS)])
    ckt, _, _, _ = netlist.ripple_carry_adder(CIRCUIT_WIDTH)
    msgs = np.arange(MV_MODULUS)
    ct_m = lwe_encrypt_message(keys[-1], sk.lv0, jnp.asarray(msgs), MV_MODULUS, p.tlwe_lv0.alpha)
    gen = Generator(MV_MODULUS, p)
    luts = jnp.stack([gen.generate_lookup_table(f).poly for f in MV_FUNCTIONS])
    out = {
        "sk_lv0": sk.lv0, "sk_lv1": sk.lv1,
        "testvec": ck.testvec, "bsk": ck.bsk, "ksk_limbs": ck.ksk_limbs,
        "pairs": np.asarray(CIRCUIT_PAIRS), "ct_x": xs, "ct_y": ys, "msgs": msgs, "ct_m": ct_m, "luts": luts,
        "adder_wires": netlist.evaluate(ckt, jnp.concatenate([xs[0], ys[0]]), ck, netlist.plan_python(ckt)),
        "add_kogge_stone": circuits.add_kogge_stone(xs, ys, ck),
        "mul_csa": circuits.mul_csa(xs, ys, ck),
        "multi_value": multi_value_bootstrap(ct_m, factor_test_vectors(list(luts)), ck),
    }
    return {k: np.asarray(v) for k, v in out.items()}


def make_vectors_radix() -> dict:
    """The radix fixture's arrays as numpy, from fixed seeds. One secret key;
    a multi-bit cloud key whose `bsk` and `ksk_limbs` are also the standard
    key (the JAX package draws them first, so they equal those of a
    standard key from the same seed). The multi-bit outputs (add_radix,
    mul_radix, select_radix, sort_radix, the FheUintRadix expression) mix
    batches of at most 4 ciphertexts, which take the multi-bit rotation,
    with larger ones. The radix calls run under jax.jit, their LUT caches
    filled first; the FheUint expression runs eagerly (its gates are jitted).
    TEST_TINY's N=64 ring is too small for the comparison and product LUTs'
    margins, so those outputs are held bit for bit, not decrypted."""
    p, bb = TEST_TINY, RADIX_BASE_BITS
    sk = SecretKey.generate(jax.random.key(5024), p)
    ck_mb = CloudKey.generate(jax.random.key(5025), sk, multibit=True)
    ck = CloudKey(testvec=ck_mb.testvec, ksk_limbs=ck_mb.ksk_limbs, bsk=ck_mb.bsk, params=p)
    for fill in (arithmetic._add_mv, arithmetic._cmp_luts, arithmetic._sel_luts, arithmetic._cast_luts):
        fill(bb, p)
    keys = jax.random.split(jax.random.key(5026), 6)
    x = arithmetic.encrypt_radix(keys[0], sk.lv0, np.asarray(RADIX_X), 2, p, bb)
    y = arithmetic.encrypt_radix(keys[1], sk.lv0, np.asarray(RADIX_Y), 2, p, bb)
    sel_bits = np.array([True, False])
    sel = lwe_encrypt_bool(keys[2], sk.lv0, jnp.asarray(sel_bits), p.tlwe_lv0.alpha)
    srt = arithmetic.encrypt_radix(keys[3], sk.lv0, np.asarray(RADIX_SORT), 1, p, bb)
    u = fhe.FheUint.encrypt(keys[4], sk.lv0, np.asarray(RADIX_X) % (1 << UINT_WIDTH), UINT_WIDTH, ck)
    v = fhe.FheUint.encrypt(keys[5], sk.lv0, np.asarray(RADIX_Y) % (1 << UINT_WIDTH), UINT_WIDTH, ck)

    def with_std(a, b, ck):
        bits = arithmetic.radix_to_bits(a, ck, bb)
        return {
            "add_radix_mv": arithmetic.add_radix(a, b, ck, bb, multi_value=True),
            "sub_radix": arithmetic.sub_radix(a, b, ck, bb),
            "compare_radix": jnp.stack(arithmetic.compare_radix(a, b, ck, bb)),
            "radix_to_bits": bits,
            "bits_to_radix": arithmetic.bits_to_radix(bits, ck, bb),
        }

    def with_mb(a, b, s, srt, ck):
        xr, yr = fhe.FheUintRadix(a, bb, ck), fhe.FheUintRadix(b, bb, ck)
        return {
            "add_radix": arithmetic.add_radix(a, b, ck, bb),
            "mul_radix": arithmetic.mul_radix(a, b, ck, bb),
            "select_radix": arithmetic.select_radix(s, a, b, ck, bb),
            "sort_radix": sort.sort_radix(srt, ck, bb, descending=True),
            "fhe_radix_expr": (xr + yr).max(xr).digits,
        }

    out = {
        "sk_lv0": sk.lv0, "sk_lv1": sk.lv1, "testvec": ck_mb.testvec, "bsk": ck_mb.bsk,
        "ksk_limbs": ck_mb.ksk_limbs, "bsk_mb": ck_mb.bsk_mb,
        "x": np.asarray(RADIX_X), "y": np.asarray(RADIX_Y), "sel_bits": sel_bits, "sort_vals": np.asarray(RADIX_SORT),
        "ct_x": x, "ct_y": y, "ct_sel": sel, "ct_sort": srt, "ct_u": u.bits, "ct_v": v.bits,
        **jax.jit(with_std)(x, y, ck),
        **jax.jit(with_mb)(x, y, sel, srt, ck_mb),
        "fhe_uint_expr": ((u + v) ^ v).bits,
    }
    return {k: np.asarray(v) for k, v in out.items()}


def PARALLEL_DP_LUT(x):
    """The parallel fixture's data-parallel LUT (message modulus 4)."""
    return (3 * x) % 4


def PARALLEL_TP_LUT(x):
    """The parallel fixture's tensor-parallel LUT (message modulus 4)."""
    return (x + 2) % 4


def make_vectors_parallel() -> dict:
    """The parallel fixture's arrays as numpy, from fixed seeds, the cases of
    tests/test_parallel.py on the 8 virtual CPU devices: mesh sizes 8 and 4
    (data parallel) and 8 with tp = 2 (tensor parallel). The multi-bit key's
    NAND at B=16 on 4 devices runs each 4-row shard on the multi-bit rotation
    (4 <= mb_route_batch_cap at TEST_TINY), where one device at B=16 takes the
    standard one. The Nussbaumer NAND runs on one device."""
    p = TEST_TINY
    sk = SecretKey.generate(jax.random.key(6024), p)
    ck_mb = CloudKey.generate(jax.random.key(6025), sk, multibit=True)
    ck = CloudKey(testvec=ck_mb.testvec, ksk_limbs=ck_mb.ksk_limbs, bsk=ck_mb.bsk, params=p)
    rng = np.random.default_rng(6026)
    bits = rng.integers(0, 2, (3, 16)).astype(bool)
    k = jax.random.split(jax.random.key(6027), 5)
    a = lwe_encrypt_bool(k[0], sk.lv0, jnp.asarray(bits[0]), p.tlwe_lv0.alpha)
    b = lwe_encrypt_bool(k[1], sk.lv0, jnp.asarray(bits[1]), p.tlwe_lv0.alpha)
    c = lwe_encrypt_bool(k[2], sk.lv0, jnp.asarray(bits[2]), p.tlwe_lv0.alpha)
    msgs = np.arange(8, dtype=np.uint32) % 4
    m3 = lwe_encrypt_message(k[3], sk.lv0, jnp.asarray(msgs), 4, p.tlwe_lv0.alpha)
    m2 = lwe_encrypt_message(k[4], sk.lv0, jnp.asarray(msgs), 4, p.tlwe_lv0.alpha)
    mesh8, mesh4, mesh_tp = parallel.make_mesh(8), parallel.make_mesh(4), parallel.make_mesh(8, tp=2)
    saved = config.config.step_impl
    config.config.step_impl = "nussbaumer"
    try:
        nand_nussbaumer = gates.nand(a[:4], b[:4], ck)
    finally:
        config.config.step_impl = saved
    out = {
        "sk_lv0": sk.lv0, "sk_lv1": sk.lv1, "testvec": ck_mb.testvec, "bsk": ck_mb.bsk,
        "ksk_limbs": ck_mb.ksk_limbs, "bsk_mb": ck_mb.bsk_mb,
        "bits": bits, "msgs": msgs, "ct_a": a, "ct_b": b, "ct_c": c, "ct_m3": m3, "ct_m2": m2,
        "dp_nand_b11_on8": parallel.data_parallel_gate("nand", a[:11], b[:11], ck, mesh8),
        "dp_xor_b8_on4": parallel.data_parallel_gate("xor", a[:8], b[:8], ck, mesh4),
        "dp_mux_b8_on4": parallel.data_parallel_mux(a[:8], b[:8], c[:8], ck, mesh4),
        "dp_lut_b8_on4": parallel.data_parallel_lut_bootstrap(m3, PARALLEL_DP_LUT, 4, ck, mesh4),
        "dp_nand_mb_b16_on4": parallel.data_parallel_gate("nand", a, b, ck_mb, mesh4),
        "tp_and_b8_on4x2": parallel.tensor_parallel_gate("and", a[:8], b[:8], ck, mesh_tp),
        "tp_or_b8_on4x2": parallel.tensor_parallel_gate("or", a[:8], b[:8], ck, mesh_tp),
        "tp_lut_b8_on4x2": parallel.tensor_parallel_lut_bootstrap(m2, PARALLEL_TP_LUT, 4, ck, mesh_tp),
        "nand_nussbaumer_b4": nand_nussbaumer,
    }
    return {k: np.asarray(v) for k, v in out.items()}


def main():
    for path, make in ((OUT, make_vectors), (OUT_MB, make_vectors_mb), (OUT_CIRCUITS, make_vectors_circuits),
                       (OUT_RADIX, make_vectors_radix), (OUT_PARALLEL, make_vectors_parallel)):
        np.savez_compressed(path, **make())
        print(f"wrote {os.path.normpath(path)} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main()
