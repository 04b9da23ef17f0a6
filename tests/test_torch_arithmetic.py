"""PyTorch port: radix arithmetic (`models/arithmetic.py`: the helpers, the
LUT families, add_radix, sub_radix, apply_lut_radix, shift_digits, the
client side and the multi-bit route) against the JAX package with tolerance
0, on JAX keys carried into the port, with a standard and with a multi-bit
key. tests/test_torch_mul_radix.py holds mul_radix,
tests/test_torch_radix_compare.py the comparisons, selection and casts.

Every test runs on the N=512 tiny set of tests/test_mul_radix.py (copied,
not imported): its LUT margins let every function decrypt to the numpy
answer, and with n0 = 16 the JAX side stays cheap. The JAX calls are jitted
(a whole radix operation compiles once, instead of a scan per bootstrap);
their LUT caches are filled eagerly first, since a cache filled inside a
trace would hold tracers. With a multi-bit key, batches of at most 4
ciphertexts take the multi-bit rotation in both packages, so these tests
also pin how each function groups its ciphertexts into bootstrap batches.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rs_tfhe_tpu.key import CloudKey as JCloudKey  # noqa: E402
from rs_tfhe_tpu.key import SecretKey as JSecretKey  # noqa: E402
from rs_tfhe_tpu.models import arithmetic as JA  # noqa: E402
from rs_tfhe_tpu.ops import blind_rotate as JBR  # noqa: E402
from rs_tfhe_tpu.params import TfheParams, TlweParams, TrgswParams, TrlweParams  # noqa: E402
from rs_tfhe_tpu_torch import key as PK  # noqa: E402
from rs_tfhe_tpu_torch.models import arithmetic as PA  # noqa: E402
from rs_tfhe_tpu_torch.ops import blind_rotate as PBR  # noqa: E402
from rs_tfhe_tpu_torch.params import params_from  # noqa: E402
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


#: tests/test_mul_radix.py:25-33
MP = TfheParams(
    security_bits=0,
    description="insecure tiny set with modulus-32 LUT margins (N=512)",
    tlwe_lv0=TlweParams(n=16, alpha=1.0e-9),
    tlwe_lv1=TlweParams(n=512, alpha=1.0e-12),
    trlwe_lv1=TrlweParams(n=512, alpha=1.0e-12),
    trgsw_lv1=TrgswParams(n=512, nbit=9, bgbit=6, l=3, basebit=2, iks_t=8, alpha=1.0e-12),
)
PMP = params_from(MP)
_JAX_CACHES = (JA._add_mv, JA._mul_mv, JA._cmp_luts, JA._cmp_mv, JA._sel_luts, JA._cast_luts)


def jax_run(fn, *args):
    """fn(*args) under jax.jit, as numpy (a tuple stays a tuple)."""
    out = jax.jit(fn)(*args)
    return tuple(np.asarray(o) for o in out) if isinstance(out, tuple) else np.asarray(out)


@pytest.fixture(scope="module", params=["standard", "multibit"])
def keys(request):
    """(JAX secret key, JAX cloud key, port secret key, port cloud key)."""
    mb = request.param == "multibit"
    jsk = JSecretKey.generate(jax.random.key(150), MP)
    jck = JCloudKey.generate(jax.random.key(151), jsk, multibit=mb)
    arrays = {"lv0": np.asarray(jsk.lv0), "lv1": np.asarray(jsk.lv1), "testvec": np.asarray(jck.testvec),
              "bsk": np.asarray(jck.bsk), "ksk_limbs": np.asarray(jck.ksk_limbs)}
    if mb:
        arrays["bsk_mb"] = np.asarray(jck.bsk_mb)
    for base_bits in (1, 2):
        for fill in _JAX_CACHES:
            fill(base_bits, MP)
    return jsk, jck, PK.secret_key_from_numpy(arrays, PMP, "cpu"), PK.cloud_key_from_numpy(arrays, PMP, "cpu")


def _enc(keys, seed, vals, d, base_bits):
    """JAX-made radix ciphertexts of vals, and the same words in the port."""
    jct = JA.encrypt_radix(jax.random.key(seed), keys[0].lv0, np.asarray(vals), d, MP, base_bits)
    return jct, to_torch(np.asarray(jct), "cpu")


def _same(out, ref):
    np.testing.assert_array_equal(to_numpy(out), ref)


# ---------------------------------------------------------------------------
# Host-side helpers and LUT families
# ---------------------------------------------------------------------------

def test_pure_helpers_match_jax():
    """_col_bounds, _greedy_chunks, _tri, _tri_combine, _raw and _bool_raw
    equal the JAX package's, the raw encodings at and above 2^31 included."""
    for d in range(1, 9):
        for base in (2, 4, 8, 16):
            assert PA._col_bounds(d, base) == JA._col_bounds(d, base)
    rng = np.random.default_rng(151)
    for cap_val, cap_terms in ((7, 8), (31, 8), (31, 3), (127, 8)):
        terms = [(i, int(m)) for i, m in enumerate(rng.integers(0, 9, 24))]
        assert PA._greedy_chunks(terms, cap_val, cap_terms) == JA._greedy_chunks(terms, cap_val, cap_terms)
    assert [PA._tri_combine(w) for w in range(16)] == [JA._tri_combine(w) for w in range(16)]
    assert [PA._tri(v, 8) for v in range(16)] == [JA._tri(v, 8) for v in range(16)]
    raws = [PA._raw(v, m) for m in (4, 8, 16, 32) for v in range(2 * m)]
    assert raws == [JA._raw(v, m) for m in (4, 8, 16, 32) for v in range(2 * m)]
    assert max(raws) >= 1 << 31
    assert (PA._bool_raw(True), PA._bool_raw(False)) == (JA._bool_raw(True), JA._bool_raw(False))
    assert PA._bool_raw(False) >= 1 << 31


def _flat_tables(tables):
    if isinstance(tables, dict):
        return {f"{k}.{kk}": v for k, t in tables.items() for kk, v in _flat_tables(t).items()}
    if hasattr(tables, "tv0"):
        return {"tv0": tables.tv0, "terms": tables.terms, "norms": tables.norms}
    return {"": tables}


@pytest.mark.parametrize("family", ["_add_mv", "_mul_mv", "_cmp_luts", "_cmp_mv", "_sel_luts", "_cast_luts"])
def test_lut_families_match_jax(family):
    """Every LUT family word for word at base_bits 1-3 (words or factor
    coefficients at and above 2^31 present), built once per (base_bits, params, device): a second call
    returns the cached objects, and a table cached for one device is never
    handed to a call on another."""
    seen_high = False
    for base_bits in (1, 2, 3):
        ref = _flat_tables(getattr(JA, family)(base_bits, MP))
        got = _flat_tables(getattr(PA, family)(base_bits, PMP, "cpu"))
        assert sorted(got) == sorted(ref)
        for name, val in got.items():
            if isinstance(val, torch.Tensor):
                assert val.device.type == "cpu"
                words = to_numpy(val)
                np.testing.assert_array_equal(words, np.asarray(ref[name]).astype(np.uint32), err_msg=name)
                seen_high |= bool((words >= 1 << 31).any())
            else:
                assert val == ref[name], name
                if name.endswith("terms"):  # negative factor coefficients, mod 2^32
                    seen_high |= any(c >= 1 << 31 for t in val for _, c in t)
        assert getattr(PA, family)(base_bits, PMP, torch.device("cpu")) is getattr(PA, family)(base_bits, PMP, "cpu")
    assert seen_high or family == "_sel_luts"  # the select LUTs' words all stay below 2^30
    meta = torch.device("meta")
    on_meta = _flat_tables(getattr(PA, family)(2, PMP, meta))
    assert all(v.device == meta for v in on_meta.values() if isinstance(v, torch.Tensor))
    on_cpu = _flat_tables(getattr(PA, family)(2, PMP, "cpu"))
    assert all(v.device.type == "cpu" for v in on_cpu.values() if isinstance(v, torch.Tensor))


# ---------------------------------------------------------------------------
# Radix operations, bit for bit and decrypted
# ---------------------------------------------------------------------------

#: (key, multi_value) cases: multi_value_bootstrap rotates with the standard
#: key whatever the key holds, so its cases need one key
KEY_MV = pytest.mark.parametrize(
    "keys, mv", [("standard", False), ("multibit", False), ("standard", True)], indirect=["keys"],
    ids=["standard-pbs", "multibit-pbs", "standard-multi_value"],
)


@KEY_MV
def test_add_radix_matches_jax(keys, mv):
    jsk, jck, psk, pck = keys
    xs, ys = np.array([15, 9, 0]), np.array([15, 12, 7])  # 15 + 15 carries out of the top digit
    ja, pa = _enc(keys, 152, xs, 2, 2)
    jb, pb = _enc(keys, 153, ys, 2, 2)
    ref = jax_run(lambda a, b, ck: JA.add_radix(a, b, ck, 2, multi_value=mv), ja, jb, jck)
    out = PA.add_radix(pa, pb, pck, 2, multi_value=mv)
    _same(out, ref)
    np.testing.assert_array_equal(PA.decrypt_radix(out, psk.lv0, 2), (xs + ys) % 16)


@KEY_MV
def test_sub_radix_matches_jax(keys, mv):
    """sub_radix, through add_radix's carry_in."""
    jsk, jck, psk, pck = keys
    xs, ys = np.array([3, 60]), np.array([9, 60])
    ja, pa = _enc(keys, 154, xs, 3, 2)
    jb, pb = _enc(keys, 155, ys, 3, 2)
    ref = jax_run(lambda a, b, ck: JA.sub_radix(a, b, ck, 2, multi_value=mv), ja, jb, jck)
    out = PA.sub_radix(pa, pb, pck, 2, multi_value=mv)
    _same(out, ref)
    np.testing.assert_array_equal(PA.decrypt_radix(out, psk.lv0, 2), (xs - ys) % 64)


def test_apply_lut_radix_matches_jax(keys):
    jsk, jck, psk, pck = keys
    xs = np.array([27, 6])
    ja, pa = _enc(keys, 156, xs, 3, 2)

    def f(v):
        return (3 * v + 1) % 4

    ref = jax_run(lambda a, ck: JA.apply_lut_radix(a, f, ck, 2), ja, jck)
    out = PA.apply_lut_radix(pa, f, pck, 2)
    _same(out, ref)
    want = [sum(f((x >> (2 * i)) & 3) << (2 * i) for i in range(3)) for x in xs]
    np.testing.assert_array_equal(PA.decrypt_radix(out, psk.lv0, 2), want)


@pytest.mark.parametrize("k", [-4, -1, 0, 2, 3])
def test_shift_digits_matches_jax(k):
    """Free digit moves, k < 0, 0, > 0 and |k| >= D; the input is not written."""
    ct = np.random.default_rng(174).integers(0, 1 << 32, (2, 3, 17), dtype=np.uint32)
    pct = to_torch(ct, "cpu")
    out = PA.shift_digits(pct, k, 2)
    _same(out, np.asarray(JA.shift_digits(jnp.asarray(ct), k, 2)))
    np.testing.assert_array_equal(to_numpy(pct), ct)


def test_encrypt_decrypt_radix_roundtrip():
    """The port's own client side, with values that need int64 (D*b = 63)."""
    g = torch.Generator().manual_seed(175)
    sk = PK.SecretKey.generate(PMP, g)
    vals = np.array([(1 << 62) + 12345, 7, (1 << 63) - 1])
    ct = PA.encrypt_radix(g, sk.lv0, vals, 21, PMP, 3)
    assert tuple(ct.shape) == (3, 21, PMP.n0 + 1)
    np.testing.assert_array_equal(PA.decrypt_radix(ct, sk.lv0, 3), vals)


# ---------------------------------------------------------------------------
# Which rotation a batch takes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keys", ["multibit"], indirect=True)
@pytest.mark.parametrize("batch", [1, 5])
def test_add_radix_multibit_route_matches_jax(keys, batch, monkeypatch):
    """add_radix with a multi-bit key: at B=1 every bootstrap batch (2, then
    1) takes the multi-bit rotation in both packages; at B=5 (10, then 5,
    above the cap of 4) both take the standard rotation. Spies count the
    multi-bit calls on each side (the JAX ones while tracing)."""
    jsk, jck, psk, pck = keys
    xs = np.arange(batch) * 5 % 16
    ys = np.arange(batch) * 3 % 16
    ja, pa = _enc(keys, 176 + batch, xs, 2, 2)
    jb, pb = _enc(keys, 178 + batch, ys, 2, 2)
    calls = {"jax": [], "port": []}
    jax_mb, port_mb = JBR.blind_rotate_mb, PBR.blind_rotate_mb_plain
    monkeypatch.setattr(JBR, "blind_rotate_mb", lambda ct, *a, **k: calls["jax"].append(ct.shape[0]) or jax_mb(ct, *a, **k))
    monkeypatch.setattr(PBR, "blind_rotate_mb_plain",
                        lambda b, *a, **k: calls["port"].append(b.shape[0]) or port_mb(b, *a, **k))
    ref = jax_run(lambda a, b, ck: JA.add_radix(a, b, ck, 2), ja, jb, jck)
    out = PA.add_radix(pa, pb, pck, 2)
    _same(out, ref)
    np.testing.assert_array_equal(PA.decrypt_radix(out, psk.lv0, 2), (xs + ys) % 16)
    assert calls["port"] == calls["jax"] == ([2, 1] if batch == 1 else [])
