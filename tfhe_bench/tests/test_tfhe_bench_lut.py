"""The LUT cells' harness on the CPU: the plain LUT reference
(reference_lut.py) against the program bit for bit, the two kinds' checks,
their control, two coefficients worked by hand, the rotation's bound at
the radix set, and the `tfhe.pbs` readers.

The configuration `tiny_radix.json` is the N=512 tiny set of
tests/test_mul_radix.py, where the 16-slot LUTs decode; the program knows
it under the name the file gives (`TINY_RADIX`, set here on its parameter
module)."""

from __future__ import annotations

import json
import math

import pytest
import torch

from tfhe_bench import keygen, roofline, run
from tfhe_bench import reference as R
from tfhe_bench import reference_lut as RL
from tfhe_bench.control import control_program
from tfhe_bench.kinds.lut_layers import FUNCTIONS
from tfhe_bench.program import Program

from .conftest import ROOT, load
from .test_tfhe_bench_spans import StandIn

SEED = 2**31 + 8080
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
PER_LAYER = {m["name"]: m for m in MANIFEST["per_layer"]}
MIXES = ["pbs_b8", "pbs_b3", "add8_b1"]


@pytest.fixture(autouse=True, scope="module")
def _tiny_radix_set():
    import rs_tfhe_tpu_torch.params as tp
    from rs_tfhe_tpu_torch.params import TfheParams, TlweParams, TrgswParams, TrlweParams

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tp, "TINY_RADIX", TfheParams(
            security_bits=0, description="insecure tiny set with modulus-32 LUT margins (N=512)",
            tlwe_lv0=TlweParams(n=16, alpha=1.0e-9), tlwe_lv1=TlweParams(n=512, alpha=1.0e-12),
            trlwe_lv1=TrlweParams(n=512, alpha=1.0e-12),
            trgsw_lv1=TrgswParams(n=512, nbit=9, bgbit=6, l=3, basebit=2, iks_t=8, alpha=1.0e-12)),
            raising=False)
        yield


@pytest.fixture(scope="module")
def setup():
    cfg = load("tiny_radix")
    p = R.Params.from_config(cfg)
    keys = keygen.make_keys(SEED, p, "cpu")
    return cfg, p, keys, Program(cfg, keys, "cpu")


def _radix_params() -> R.Params:
    return R.Params.from_config(json.loads((ROOT / "tfhe_bench" / "configs" / "radix_mb.json").read_text()))


@pytest.mark.parametrize("batch", [1, 3, 4, 5, 8])
@pytest.mark.parametrize("per_row", [False, True])
def test_lut_bootstrap_equals_reference_on_both_routes(setup, batch, per_row):
    """Batches on both sides of the multi-bit cap (4), a shared test vector
    and one a ciphertext (the four functions in turn)."""
    from rs_tfhe_tpu_torch import bootstrap

    cfg, p, keys, prog = setup
    g = keygen.generator(batch + 10 * per_row, "cpu")
    msgs = torch.randint(0, 16, (batch,), generator=g)
    ct = RL.encrypt(g, keys.lv0, msgs, 16, p.alpha_lv0)
    fs = [FUNCTIONS[name] for name in ("inc", "affine3", "square", "reflect")]
    if per_row:
        tv = torch.stack([RL.testvec_of(fs[i % 4], 16, p, "cpu") for i in range(batch)])
    else:
        tv = RL.testvec_of(fs[0], 16, p, "cpu")
    out = bootstrap.bootstrap_with_testvec(ct, tv, prog.ck)
    assert torch.equal(out, RL.lut_bootstrap(ct, tv, keys, p, batch))
    want = [fs[i % 4 if per_row else 0](int(m)) for i, m in enumerate(msgs)]
    assert RL.decode(out, keys.lv0, 16).tolist() == want


def test_reference_test_vectors_are_the_program_tables(setup):
    from rs_tfhe_tpu_torch.lut.generator import Generator
    from rs_tfhe_tpu_torch.params import SECURITY_128_BIT_RADIX

    for params, p in ((setup[3].params, setup[1]), (SECURITY_128_BIT_RADIX, _radix_params())):
        for f in FUNCTIONS.values():
            assert torch.equal(RL.testvec_of(f, 16, p, "cpu"), Generator(16, params).generate_lookup_table(f).poly)


def test_two_coefficients_worked_by_hand():
    """At N=2048, modulus 16: a box is 128 coefficients and the rotation
    64. Coefficient 64 reads message 1's box, (1+1) mod 8 = 2 -> 2 * 2^32/32
    = 2^28; coefficient 2047 wraps onto message 0's box, negated: -(0+1) *
    2^27."""
    tv = RL.testvec_of(FUNCTIONS["inc"], 16, _radix_params(), "cpu")
    assert tv[0].abs().sum() == 0
    assert int(tv[1, 64]) == 1 << 28
    assert int(tv[1, 2047]) == -(1 << 27)


@pytest.mark.parametrize("digits", [1, 3])
def test_radix_add_equals_reference(setup, digits):
    """A D-digit add through the typed API against the reference's digit
    loop, two requests, each on its own (D-1 pairs of 2 on the multi-bit
    rotation, one of 1)."""
    from rs_tfhe_tpu_torch.fhe import FheUintRadix

    cfg, p, keys, prog = setup
    g = keygen.generator(77 + digits, "cpu")
    vals = torch.tensor([[200, 311], [7, 504]]) % (1 << (3 * digits))
    cts = RL.encrypt(g, keys.lv0, RL.digits_of(vals, digits, 3), 16, p.alpha_lv0)  # [2, 2, D, n0+1]
    ref = RL.add_radix(cts[:, 0], cts[:, 1], keys, p, 3)
    for r in range(2):
        out = (FheUintRadix(cts[r, 0], 3, prog.ck) + FheUintRadix(cts[r, 1], 3, prog.ck)).digits
        assert torch.equal(out, ref[r])
        total = int(vals[r].sum()) % (1 << (3 * digits))
        assert RL.decode(out, keys.lv0, 16).tolist() == RL.digits_of(torch.tensor(total), digits, 3).tolist()


@pytest.mark.parametrize("mix", MIXES)
def test_kind_checks_at_zero(mix):
    result, lines = run.run_cell(load("tiny_radix"), load(mix), SEED, 0.2, False, "cpu", [])
    assert result["correct"], lines
    assert result["checks"]["words_differ"]["value"] == 0 and result["checks"]["bits_wrong"]["value"] == 0
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("mix", ["pbs_b8", "add8_b1"])
def test_control_is_not_correct(mix):
    result, lines = run.run_cell(load("tiny_radix"), load(mix), SEED, 0.1, False, "cpu", [],
                                 make_program=control_program)
    assert not result["correct"], lines
    assert result["checks"]["words_differ"]["value"] > 0


def test_rotation_bound_at_the_radix_set():
    """K1's work at B=2048: 8.45e13 multiply-adds in four s8 limbs at
    989.5 TMAC/s; at B=2 the multi-bit key's."""
    p = _radix_params()
    assert round(roofline.rotation_bound_s(p, 2048), 4) == 0.3417
    assert round(roofline.rotation_bound_s(p, 2) * 1e3, 3) == 0.167


def test_float64_bounds_hold_at_the_radix_set():
    p = _radix_params()
    assert 2 * p.l * p.n1 * (1 << (p.bgbit - 1)) * (1 << 31) < 1 << 53
    assert p.n1 * p.iks_t * (1 << 31) < 1 << 53


def _traced(monkeypatch, mix: str, names: list[str]) -> dict:
    monkeypatch.setattr(run, "Trace", StandIn)
    result, lines = run.run_cell(load("tiny_radix"), load(mix), SEED, 0.1, True, "cpu", [PER_LAYER[n] for n in names])
    assert result["correct"], lines
    return {k: v["value"] for k, v in result["metrics"].items()}


@pytest.mark.parametrize("mix, names", [
    ("pbs_b8", ["rotation.span_roofline.pbs", "pbs.rest_share.pbs"]),
    ("add8_b1", ["rotation.span_roofline.radix", "pbs.host_ms.radix", "gate.host_ms.add"]),
])
def test_pbs_readers_read_the_spans(monkeypatch, mix, names):
    got = _traced(monkeypatch, mix, names)
    assert set(got) == set(names) - {"gate.host_ms.add"}, got  # the LUT path opens no gate span
    assert all(math.isfinite(v) and v > 0 for v in got.values()), got
    if "pbs.rest_share.pbs" in got:
        assert got["pbs.rest_share.pbs"] < 100


def test_a_program_without_the_pbs_span_reads_nothing(monkeypatch):
    from rs_tfhe_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: False)
    assert _traced(monkeypatch, "add8_b1", ["rotation.span_roofline.radix", "pbs.host_ms.radix"]) == {}
