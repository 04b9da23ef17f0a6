"""The product cell's harness on the CPU: the plain product reference
(reference_mul.py) against the program bit for bit, the kind's check, its
control, its tables against the program's and coefficients worked by hand,
the plan of a request at the cell's set, the rotation's bound and the
float64 bounds there, and the two readers of the cell's per-layer metrics.

The configuration `tiny_mul.json` is the N=512 tiny set of
examples/torch/ciphertext_multiply.py, where the modulus-32 column LUTs
decode; the program knows it under the name the file gives (`TINY_MUL`, set
here on its parameter module)."""

from __future__ import annotations

import json
import math

import pytest
import torch

from tfhe_bench import keygen, roofline, run
from tfhe_bench import reference as R
from tfhe_bench import reference_lut as RL
from tfhe_bench import reference_mul as RM
from tfhe_bench.control import control_program
from tfhe_bench.program import Program

from .conftest import ROOT, load
from .test_tfhe_bench_spans import StandIn

SEED = 2**31 + 2626
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
PER_LAYER = {m["name"]: m for m in MANIFEST["per_layer"]}
READERS = ["rotation.span_roofline.mul", "mul.columns_device_ms.mul"]


@pytest.fixture(autouse=True, scope="module")
def _tiny_mul_set():
    import rs_tfhe_tpu_torch.params as tp
    from rs_tfhe_tpu_torch.params import TfheParams, TlweParams, TrgswParams, TrlweParams

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tp, "TINY_MUL", TfheParams(
            security_bits=0, description="insecure tiny set with modulus-32 LUT margins (N=512)",
            tlwe_lv0=TlweParams(n=16, alpha=1.0e-9), tlwe_lv1=TlweParams(n=512, alpha=1.0e-12),
            trlwe_lv1=TrlweParams(n=512, alpha=1.0e-12),
            trgsw_lv1=TrgswParams(n=512, nbit=9, bgbit=6, l=3, basebit=2, iks_t=8, alpha=1.0e-12)),
            raising=False)
        yield


@pytest.fixture(scope="module")
def setup():
    cfg = load("tiny_mul")
    p = R.Params.from_config(cfg)
    keys = keygen.make_keys(SEED, p, "cpu")
    return cfg, p, keys, Program(cfg, keys, "cpu")


def _nibble() -> R.Params:
    return R.Params.from_config(json.loads((ROOT / "tfhe_bench" / "configs" / "nibble_std.json").read_text()))


@pytest.mark.parametrize("digits, base_bits", [(2, 2), (3, 1)], ids=["D2-base4", "D3-base2-normalized"])
def test_product_equals_reference(setup, digits, base_bits):
    """Two requests of two pairs through the typed API's `*` against one
    reference pass over both; D=3 at base 2 takes a normalization round."""
    from rs_tfhe_tpu_torch.fhe import FheUintRadix

    cfg, p, keys, prog = setup
    g = keygen.generator(100 + digits, "cpu")
    top = 1 << (base_bits * digits)
    vals = torch.tensor([[[top - 1, 6], [top - 1, 11]], [[3, 1], [2, 0]]]) % top  # [R, 2, M]
    cts = RL.encrypt(g, keys.lv0, RL.digits_of(vals, digits, base_bits), 2 << base_bits, p.alpha_lv0)
    ref = RM.mul_radix(cts[:, 0], cts[:, 1], keys, p, base_bits)
    for r in range(2):
        out = (FheUintRadix(cts[r, 0], base_bits, prog.ck) * FheUintRadix(cts[r, 1], base_bits, prog.ck)).digits
        assert torch.equal(out, ref[r])
        want = RL.digits_of(vals[r, 0] * vals[r, 1], 2 * digits, base_bits)
        assert torch.equal(RL.decode(out, keys.lv0, 2 << base_bits), want)


@pytest.mark.parametrize("base_bits", [1, 2])
def test_reference_tables_are_the_program_tables(setup, base_bits):
    from rs_tfhe_tpu_torch.models import arithmetic
    from rs_tfhe_tpu_torch.params import SECURITY_128_BIT_NIBBLE

    for params, p in ((setup[3].params, setup[1]), (SECURITY_128_BIT_NIBBLE, _nibble())):
        ours, theirs = RM.tables(base_bits, p, "cpu"), arithmetic._mul_luts.host(base_bits, params)
        assert set(ours) == set(theirs)
        assert all(torch.equal(ours[k], theirs[k]) for k in ours)


def test_coefficients_worked_by_hand():
    """At N=4096, base 4. The lo/hi tables have m_pair = 16 boxes of 256
    coefficients, rotated left by 128: coefficient 3712 reads box 15, w = 15
    = 4*3 + 3, 3*3 = 9: hi 9 div 4 = 2 at modulus 32 -> 2 * 2^32/64 = 2^27,
    lo 9 mod 4 = 1 -> 2^26; coefficient 3711 reads box 14, 3*2 = 6: hi 1,
    lo 2; coefficient 4095 wraps onto box 0 (w = 0), negated: 0. The carry
    table has m_col = 32 boxes of 128, rotated by 64: coefficient 4031 reads
    box 31, 31 div 4 = 7 -> 7 * 2^26; 4032 wraps onto box 0. The re-encode
    table a has m_enc = 8 boxes of 512, rotated by 256: coefficient 256
    reads box 1 -> 1 at modulus 4, 2^32/8 = 2^29."""
    tv = RM.tables(2, _nibble(), "cpu")
    assert all(t[0].abs().sum() == 0 for t in tv.values())
    assert int(tv["hi"][1, 3712]) == 1 << 27 and int(tv["lo"][1, 3712]) == 1 << 26
    assert int(tv["hi"][1, 3711]) == 1 << 26 and int(tv["lo"][1, 3711]) == 1 << 27
    assert int(tv["hi"][1, 4095]) == 0 and int(tv["lo"][1, 4095]) == 0
    assert int(tv["car"][1, 4031]) == 7 << 26 and int(tv["car"][1, 4032]) == 0
    assert int(tv["a"][1, 256]) == 1 << 29 and int(tv["a"][1, 255]) == 0


def test_a_request_at_the_cell_makes_ten_calls_of_864():
    """8x8 bits in 4 base-4 digits, 16 pairs: no normalization round; the
    first column alone (3 < 4) and the last take one ciphertext a pair."""
    assert RM.call_batches(4, 2, 16) == [128, 512, 16, 32, 32, 32, 32, 32, 32, 16]
    assert sum(RM.call_batches(4, 2, 16)) == 864
    assert not [s for s in RM.column_plan(4, 4) if s.kind == "norm"]
    assert [s.kind for s in RM.column_plan(3, 2)].count("norm") == 1


def test_kind_checks_at_zero(setup):
    result, lines = run.run_cell(load("tiny_mul"), load("mul4x4_b2"), SEED, 0.2, False, "cpu", [])
    assert result["correct"], lines
    assert result["checks"]["words_differ"]["value"] == 0 and result["checks"]["bits_wrong"]["value"] == 0
    assert result["attempted"] >= 1 and result["failed"] == 0


def test_control_is_not_correct(setup):
    result, lines = run.run_cell(load("tiny_mul"), load("mul4x4_b2"), SEED, 0.1, False, "cpu", [],
                                 make_program=control_program)
    assert not result["correct"], lines
    assert result["checks"]["words_differ"]["value"] > 0


def test_rotation_bound_at_the_nibble_set():
    """K1's work at N=4096, n0=1160, L=3: 1160 * 6 * 2 * 4096^2
    multiply-adds a ciphertext in four s8 limbs at 989.5 TMAC/s."""
    p = _nibble()
    assert round(roofline.rotation_bound_s(p, 1) * 1e3, 4) == 0.9441
    assert round(roofline.rotation_bound_s(p, 512), 4) == 0.4834
    assert sum(roofline.rotation_bound_s(p, b) for b in RM.call_batches(4, 2, 16)) == pytest.approx(0.8157, abs=1e-4)


def test_float64_bounds_hold_at_the_nibble_set():
    p = _nibble()
    assert 2 * p.l * p.n1 * (1 << (p.bgbit - 1)) * (1 << 31) < 1 << 53
    assert p.n1 * p.iks_t * (1 << 31) < 1 << 53


def _traced(monkeypatch) -> dict:
    monkeypatch.setattr(run, "Trace", StandIn)
    result, lines = run.run_cell(load("tiny_mul"), load("mul4x4_b2"), SEED, 0.1, True, "cpu",
                                 [PER_LAYER[n] for n in READERS])
    assert result["correct"], lines
    return {k: v["value"] for k, v in result["metrics"].items()}


def test_mul_readers_read_the_spans(setup, monkeypatch):
    got = _traced(monkeypatch)
    assert set(got) == set(READERS), got
    assert all(math.isfinite(v) and v > 0 for v in got.values()), got


def test_a_program_without_the_spans_reads_nothing(setup, monkeypatch):
    from rs_tfhe_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: False)
    assert _traced(monkeypatch) == {}
