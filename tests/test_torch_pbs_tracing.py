"""PyTorch port: the programmable bootstrap's and the radix layer's spans
and counters (`tfhe.pbs`, `tfhe.radix.<op>`; `pbs.*`, `radix.ops.*` in
`utils/profiling.counters`) at TEST_TINY on the CPU, with a standard and a
multi-bit cloud key: `tfhe.pbs` opens once a LUT bootstrap and encloses its
rotation, extract and key switch; a D-digit add opens `tfhe.radix.add` once
and counts D calls of 2D-1 ciphertexts, D-1 of them with a test vector a
ciphertext; the gate path opens neither span and counts nothing here."""

import collections

import pytest

torch = pytest.importorskip("torch")

import rs_tfhe_tpu_torch as pt  # noqa: E402
from rs_tfhe_tpu_torch import bootstrap, gates, key, lut, tlwe  # noqa: E402
from rs_tfhe_tpu_torch.models import arithmetic, netlist  # noqa: E402
from rs_tfhe_tpu_torch.utils import profiling  # noqa: E402

P = pt.TEST_TINY
KINDS = ["standard", "multi-bit"]
PBS_KEYS = ("pbs.calls", "pbs.ciphertexts", "pbs.per_row_luts")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def keys():
    g = torch.Generator().manual_seed(2222)
    sk = key.SecretKey.generate(P, g)
    return sk, {"standard": key.CloudKey.generate(sk, g), "multi-bit": key.CloudKey.generate(sk, g, multibit=True)}


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name.startswith("tfhe.")]


def _span_parent(ev):
    parent = ev.cpu_parent
    while parent is not None and not parent.name.startswith("tfhe."):
        parent = parent.cpu_parent
    return parent


def _moved(fn):
    """fn's result, its spans, and the counters it moved."""
    before = profiling.counters()
    out, spans = _profiled(fn)
    after = profiling.counters()
    return out, spans, {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def _messages(sk, values, seed):
    g = torch.Generator().manual_seed(seed)
    return tlwe.lwe_encrypt_message(g, sk.lv0, values, 4, P.tlwe_lv0.alpha)


def _increment(v):
    return (v + 1) % 4


def _route(kind, batch):
    mb = kind == "multi-bit" and batch <= 4
    return "tfhe.rotate.plain_mb" if mb else "tfhe.rotate.plain"


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("batch", [1, 2, 5])
@pytest.mark.parametrize("per_row", [False, True])
def test_pbs_span_encloses_rotation_extract_and_key_switch(keys, kind, batch, per_row):
    sk, cks = keys
    ck = cks[kind]
    m = _messages(sk, [i % 4 for i in range(batch)], 30 + batch)
    poly = lut.Generator(4, P).generate_lookup_table(_increment).poly
    tv = poly.expand(batch, 2, P.n1) if per_row else poly
    out, spans, moved = _moved(lambda: bootstrap.bootstrap_with_testvec(m, tv, ck))
    assert tlwe.lwe_decrypt_message(out, sk.lv0, 4).tolist() == [(i + 1) % 4 for i in range(batch)]
    route = _route(kind, batch)
    assert collections.Counter(e.name for e in spans) == {
        "tfhe.pbs": 1, route: 1, "tfhe.extract": 1, "tfhe.keyswitch": 1}
    for ev in spans:
        parent = _span_parent(ev)
        assert (parent.name if parent is not None else None) == (None if ev.name == "tfhe.pbs" else "tfhe.pbs")
    assert {k: moved.get(k, 0) for k in PBS_KEYS} == {
        "pbs.calls": 1, "pbs.ciphertexts": batch, "pbs.per_row_luts": int(per_row)}


@pytest.mark.parametrize("kind", KINDS)
def test_multi_value_bootstrap_is_one_pbs(keys, kind):
    """One rotation for two LUTs: one `tfhe.pbs`, the standard rotation
    whatever the key, its ciphertexts counted once."""
    sk, cks = keys
    gen = lut.Generator(4, P)
    mv = lut.factor_test_vectors([gen.generate_lookup_table(f).poly for f in (_increment, lambda v: 3 - v)])
    m = _messages(sk, [0, 1, 2], 40)
    _, spans, moved = _moved(lambda: lut.multi_value_bootstrap(m, mv, cks[kind]))
    assert collections.Counter(e.name for e in spans) == {
        "tfhe.pbs": 1, "tfhe.rotate.plain": 1, "tfhe.extract": 1, "tfhe.keyswitch": 1}
    assert {k: moved.get(k, 0) for k in PBS_KEYS} == {"pbs.calls": 1, "pbs.ciphertexts": 3, "pbs.per_row_luts": 0}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("digits", [1, 2, 4])
def test_radix_add_opens_one_span_and_counts_its_bootstraps(keys, kind, digits):
    """An FheUintRadix add of D digits: `tfhe.radix.add` once, D `tfhe.pbs`
    inside it; D calls of 2D-1 ciphertexts, D-1 with per-row tables."""
    sk, cks = keys
    ck = cks[kind]
    g = torch.Generator().manual_seed(50 + digits)
    x = pt.FheUintRadix.encrypt(g, sk.lv0, 5, digits, ck, base_bits=1)
    y = pt.FheUintRadix.encrypt(g, sk.lv0, 6, digits, ck, base_bits=1)
    out, spans, moved = _moved(lambda: (x + y).digits)
    assert out.shape == x.digits.shape
    names = collections.Counter(e.name for e in spans)
    assert names["tfhe.radix.add"] == 1 and names["tfhe.pbs"] == digits
    assert all(_span_parent(e).name == "tfhe.radix.add" for e in spans if e.name == "tfhe.pbs")
    assert {k: moved.get(k, 0) for k in PBS_KEYS + ("radix.ops.add",)} == {
        "pbs.calls": digits, "pbs.ciphertexts": 2 * digits - 1, "pbs.per_row_luts": digits - 1, "radix.ops.add": 1}
    rotations = sum(v for k, v in names.items() if k.startswith("tfhe.rotate."))
    assert rotations == digits


def test_sub_counts_as_a_sub_alone(keys):
    """sub_radix adds through add_radix's body: one `tfhe.radix.sub`, no
    `tfhe.radix.add`, `radix.ops.sub` alone moves among the radix ops."""
    sk, cks = keys
    g = torch.Generator().manual_seed(60)
    a = arithmetic.encrypt_radix(g, sk.lv0, 3, 2, P, base_bits=1)
    b = arithmetic.encrypt_radix(g, sk.lv0, 1, 2, P, base_bits=1)
    _, spans, moved = _moved(lambda: arithmetic.sub_radix(a, b, cks["standard"], base_bits=1))
    names = collections.Counter(e.name for e in spans)
    assert names["tfhe.radix.sub"] == 1 and "tfhe.radix.add" not in names
    assert {k: v for k, v in moved.items() if k.startswith("radix.ops.")} == {"radix.ops.sub": 1}
    assert moved["pbs.calls"] == names["tfhe.pbs"] == 3  # the complement, then two digits


@pytest.mark.parametrize("kind", KINDS)
def test_gate_path_opens_no_pbs_span(keys, kind):
    """`batch_gate` and a compiled netlist: no `tfhe.pbs` or `tfhe.radix.*`
    span, and no PBS or radix counter moves."""
    sk, cks = keys
    ck = cks[kind]
    g = torch.Generator().manual_seed(70)
    a = tlwe.lwe_encrypt_bool(g, sk.lv0, [True, False, True], P.tlwe_lv0.alpha)
    b = tlwe.lwe_encrypt_bool(g, sk.lv0, [True, True, False], P.tlwe_lv0.alpha)
    run = netlist.compile_circuit(netlist.ripple_carry_adder(2)[0])
    inputs = torch.cat([a[:2], b[:2]])
    _, spans, moved = _moved(lambda: (gates.batch_gate("nand", a, b, ck), run(inputs, ck)))
    assert spans and not [e.name for e in spans if e.name == "tfhe.pbs" or e.name.startswith("tfhe.radix.")]
    assert not {k for k in moved if k.startswith(("pbs.", "radix."))}


def test_counters_hold_the_pbs_and_radix_counters():
    got = profiling.counters()
    assert set(PBS_KEYS) | {f"radix.ops.{op}" for op in ("add", "sub", "compare", "mul")} <= set(got)
    assert all(isinstance(got[k], int) for k in PBS_KEYS)
