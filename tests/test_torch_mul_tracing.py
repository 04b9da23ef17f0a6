"""PyTorch port: the product's stage spans and column counters
(`tfhe.radix.mul.encode`, `.pairs`, `.columns`; `radix.mul.column_calls`,
`radix.mul.norm_rounds` in `utils/profiling.counters`) on the N=512 tiny set
of examples/torch/ciphertext_multiply.py (copied), on the CPU.

`tfhe.radix.mul` opens once a product and encloses the three stage spans in
order, each enclosing its own `tfhe.pbs` spans; the counters equal the plan
of `models/arithmetic.mul_radix` (worked out below by hand); the products
still decrypt to x * y; the add, the comparison and a netlist open no
`tfhe.radix.mul.*` span."""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rs_tfhe_tpu_torch as pt  # noqa: E402
from rs_tfhe_tpu_torch import key, tlwe  # noqa: E402
from rs_tfhe_tpu_torch.models import arithmetic, netlist  # noqa: E402
from rs_tfhe_tpu_torch.params import TfheParams, TlweParams, TrgswParams, TrlweParams  # noqa: E402
from rs_tfhe_tpu_torch.utils import profiling  # noqa: E402

TINY_MUL = TfheParams(
    security_bits=0,
    description="insecure tiny set with modulus-32 LUT margins (N=512)",
    tlwe_lv0=TlweParams(n=16, alpha=1.0e-9),
    tlwe_lv1=TlweParams(n=512, alpha=1.0e-12),
    trlwe_lv1=TrlweParams(n=512, alpha=1.0e-12),
    trgsw_lv1=TrgswParams(n=512, nbit=9, bgbit=6, l=3, basebit=2, iks_t=8, alpha=1.0e-12),
)
STAGES = ("tfhe.radix.mul.encode", "tfhe.radix.mul.pairs", "tfhe.radix.mul.columns")

#: (digits, base_bits) -> the plan's LUT calls by stage, their ciphertexts a
#: product, and the normalization rounds. D=2 at base 4: the columns take 3,
#: 9 + 0, 3 + 6 + 2 and 3 + 2, a single, two pairs and the last single.
#: D=3 at base 2: column 3 holds 5 products and a carry of 3, 8 > 7, so one
#: round splits it into two chunks (a call of 4) before its pair.
PLANS = {
    (2, 2): {"encode": [4], "pairs": [8], "columns": [1, 2, 2, 1], "norm_rounds": 0},
    (3, 1): {"encode": [6], "pairs": [18], "columns": [1, 2, 2, 4, 2, 2, 1], "norm_rounds": 1},
}
CASES = {(2, 2): ([15, 6], [15, 11]), (3, 1): ([7, 5], [7, 6])}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def keys():
    g = torch.Generator().manual_seed(2626)
    sk = key.SecretKey.generate(TINY_MUL, g)
    return sk, key.CloudKey.generate(sk, g)


def _traced(fn):
    """fn's result, its `tfhe.*` spans in the order they opened, and the
    counters it moved."""
    from torch.profiler import ProfilerActivity, profile

    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    after = profiling.counters()
    spans = sorted((e for e in prof.events() if e.name.startswith("tfhe.")), key=lambda e: e.time_range.start)
    return out, spans, {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def _span_parent(ev):
    parent = ev.cpu_parent
    while parent is not None and not parent.name.startswith("tfhe."):
        parent = parent.cpu_parent
    return parent


def _encrypt(sk, seed, vals, digits, base_bits):
    g = torch.Generator().manual_seed(seed)
    return arithmetic.encrypt_radix(g, sk.lv0, vals, digits, TINY_MUL, base_bits)


@pytest.fixture(scope="module")
def products(keys):
    """A case's product, traced at its first use: (x, y, product digits,
    spans, moved)."""
    sk, ck = keys
    done = {}

    def product(case):
        if case not in done:
            (d, bb), (xs, ys) = case, CASES[case]
            a, b = _encrypt(sk, 10 + d, xs, d, bb), _encrypt(sk, 20 + d, ys, d, bb)
            done[case] = (np.array(xs), np.array(ys), *_traced(lambda: arithmetic.mul_radix(a, b, ck, bb)))
        return done[case]

    return product


@pytest.mark.parametrize("case", list(CASES), ids=["D2-base4", "D3-base2"])
def test_mul_opens_its_stage_spans_in_order(products, case):
    _, _, _, spans, _ = products(case)
    names = collections.Counter(e.name for e in spans)
    assert names["tfhe.radix.mul"] == 1 and all(names[s] == 1 for s in STAGES)
    stages = [e for e in spans if e.name in STAGES]
    assert [e.name for e in stages] == list(STAGES)
    assert all(_span_parent(e).name == "tfhe.radix.mul" for e in stages)
    assert all(a.time_range.end <= b.time_range.start for a, b in zip(stages, stages[1:]))


@pytest.mark.parametrize("case", list(CASES), ids=["D2-base4", "D3-base2"])
def test_each_stage_encloses_its_pbs_calls(products, case):
    plan = PLANS[case]
    _, _, _, spans, moved = products(case)
    by_stage = collections.defaultdict(list)
    for e in spans:
        if e.name == "tfhe.pbs":
            by_stage[_span_parent(e).name.rsplit(".", 1)[-1]].append(e)
    assert {k: len(v) for k, v in by_stage.items()} == {s: len(plan[s]) for s in ("encode", "pairs", "columns")}
    assert moved["pbs.calls"] == sum(len(plan[s]) for s in ("encode", "pairs", "columns"))
    assert moved["pbs.ciphertexts"] == 2 * sum(sum(plan[s]) for s in ("encode", "pairs", "columns"))


@pytest.mark.parametrize("case", list(CASES), ids=["D2-base4", "D3-base2"])
def test_column_counters_equal_the_plan(products, case):
    _, _, _, _, moved = products(case)
    plan = PLANS[case]
    got = {k: moved.get(k, 0) for k in ("radix.mul.column_calls", "radix.mul.norm_rounds", "radix.ops.mul")}
    assert got == {"radix.mul.column_calls": len(plan["columns"]), "radix.mul.norm_rounds": plan["norm_rounds"],
                   "radix.ops.mul": 1}


@pytest.mark.parametrize("case", list(CASES), ids=["D2-base4", "D3-base2"])
def test_products_still_decrypt(keys, products, case):
    sk, _ = keys
    xs, ys, out, _, _ = products(case)
    d, bb = case
    assert out.shape[-2] == 2 * d
    np.testing.assert_array_equal(arithmetic.decrypt_radix(out, sk.lv0, bb), xs * ys)


def test_multi_value_product_opens_the_same_spans(keys):
    """The pair stage through one rotation a pair: the same three spans, one
    `tfhe.pbs` in `.pairs`, the same column plan."""
    sk, ck = keys
    xs, ys = CASES[2, 2]
    a, b = _encrypt(sk, 31, xs, 2, 2), _encrypt(sk, 32, ys, 2, 2)
    out, spans, moved = _traced(lambda: arithmetic.mul_radix(a, b, ck, 2, multi_value=True))
    stages = [e.name for e in spans if e.name in STAGES]
    assert stages == list(STAGES)
    pbs = collections.Counter(_span_parent(e).name for e in spans if e.name == "tfhe.pbs")
    assert pbs == {"tfhe.radix.mul.encode": 1, "tfhe.radix.mul.pairs": 1, "tfhe.radix.mul.columns": 4}
    assert moved["radix.mul.column_calls"] == 4 and moved.get("radix.mul.norm_rounds", 0) == 0
    np.testing.assert_array_equal(arithmetic.decrypt_radix(out, sk.lv0, 2), np.array(xs) * np.array(ys))


def _add(sk, ck):
    a, b = _encrypt(sk, 41, [3, 9], 2, 2), _encrypt(sk, 42, [5, 2], 2, 2)
    return lambda: arithmetic.add_radix(a, b, ck, 2)


def _compare(sk, ck):
    a, b = _encrypt(sk, 43, [3, 9], 2, 2), _encrypt(sk, 44, [5, 2], 2, 2)
    return lambda: arithmetic.compare_radix(a, b, ck, 2)


def _netlist(sk, ck):
    g = torch.Generator().manual_seed(45)
    bits = tlwe.lwe_encrypt_bool(g, sk.lv0, [True, False, True, True], TINY_MUL.tlwe_lv0.alpha)
    run = netlist.compile_circuit(netlist.ripple_carry_adder(2)[0])
    return lambda: run(bits, ck)


@pytest.mark.parametrize("path", [_add, _compare, _netlist], ids=["add", "compare", "netlist"])
def test_other_paths_open_no_mul_span(keys, path):
    sk, ck = keys
    _, spans, moved = _traced(path(sk, ck))
    assert spans and not [e.name for e in spans if e.name.startswith("tfhe.radix.mul")]
    assert not {k for k in moved if k.startswith("radix.mul.")}


def test_counters_hold_the_mul_counters():
    got = profiling.counters()
    assert {"radix.mul.column_calls", "radix.mul.norm_rounds"} <= set(got)
    assert all(isinstance(got[k], int) for k in ("radix.mul.column_calls", "radix.mul.norm_rounds"))


def test_typed_api_product_is_the_traced_product(keys):
    """`FheUintRadix` `*`, the benchmark's entry: one `tfhe.radix.mul` with
    its three stages, the D=2 plan's counts."""
    sk, ck = keys
    xs, ys = CASES[2, 2]
    x = pt.FheUintRadix(_encrypt(sk, 51, xs, 2, 2), 2, ck)
    y = pt.FheUintRadix(_encrypt(sk, 52, ys, 2, 2), 2, ck)
    out, spans, moved = _traced(lambda: x * y)
    assert [e.name for e in spans if e.name.startswith("tfhe.radix.")] == ["tfhe.radix.mul", *STAGES]
    assert moved["radix.mul.column_calls"] == len(PLANS[2, 2]["columns"]) and moved["radix.ops.mul"] == 1
    np.testing.assert_array_equal(out.decrypt(sk.lv0), np.array(xs) * np.array(ys))
