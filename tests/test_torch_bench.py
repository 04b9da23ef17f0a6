"""PyTorch port: the measurement entry points of scripts/torch/ (bench.py,
bench_suite.py, bench_latency_sweep.py, bench_multichip.py) on the CPU, at
TEST_TINY and small batches.

The ops the suite times, fed key material and ciphertexts carried across
from JAX, give JAX's outputs bit for bit (tolerance 0): the NAND batch, the
rotation of the NAND linear form, the key switch of its extraction, the
external-product step (the JAX suite's build_step_matrix and
polymul_small_by_torus_multi), which the Nussbaumer step equals; the chain carry
(`xor_into_body`) equals the JAX suite's scripts/bench_suite.py:117-122,
re-implemented here from those lines (the JAX script configures a compile
cache at import). Each script runs end to end on the CPU: bench.py's line
has BENCH_r05.json's fields, the suite's table BENCH_SUITE.json's 38 names,
the sweep a row per route with `auto_mb` changing rotation at the cap, the
multi-device harness decrypts every point on 2 virtual devices; without a
card and without --cpu each raises. The committed H100 artifacts are read by
tests/test_torch_bench_artifact.py."""

import importlib.util
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rs_tfhe_tpu import gates as JG  # noqa: E402
from rs_tfhe_tpu import tlwe as JT  # noqa: E402
from rs_tfhe_tpu.key import CloudKey as JCloudKey  # noqa: E402
from rs_tfhe_tpu.key import SecretKey as JSecretKey  # noqa: E402
from rs_tfhe_tpu.ops.blind_rotate import blind_rotate as j_blind_rotate  # noqa: E402
from rs_tfhe_tpu.ops.decompose import gadget_decompose as j_gadget_decompose  # noqa: E402
from rs_tfhe_tpu.ops.extract import sample_extract as j_sample_extract  # noqa: E402
from rs_tfhe_tpu.ops.keyswitch import identity_key_switch as j_identity_key_switch  # noqa: E402
from rs_tfhe_tpu.ops.poly import build_step_matrix, polymul_small_by_torus_multi  # noqa: E402
from rs_tfhe_tpu.params import TEST_TINY  # noqa: E402
from rs_tfhe_tpu_torch import key as PK  # noqa: E402
from rs_tfhe_tpu_torch.ops import blind_rotate as PBR  # noqa: E402
from rs_tfhe_tpu_torch.ops.extract import sample_extract  # noqa: E402
from rs_tfhe_tpu_torch.ops.keyswitch import identity_key_switch  # noqa: E402
from rs_tfhe_tpu_torch.params import params_from  # noqa: E402
from rs_tfhe_tpu_torch.torus import to_numpy, to_torch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = ROOT / "scripts" / "torch"
PTINY = params_from(TEST_TINY)
CPU = torch.device("cpu")


def _load(name):
    """scripts/torch/<name>.py as a module of its own name (the root bench.py
    is the JAX bench)."""
    if str(SCRIPTS) not in sys.path:
        sys.path.insert(0, str(SCRIPTS))
    spec = importlib.util.spec_from_file_location(f"_torch_bench_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bench = _load("bench")
suite = _load("bench_suite")
sweep = _load("bench_latency_sweep")
multichip = _load("bench_multichip")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port: the suite runs six workers on the
    machine's cores, and torch's default of a thread a core oversubscribes
    them (the JAX side keeps its own pool)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def keys():
    """(JAX secret key, JAX cloud key, port secret key, port cloud key) at TEST_TINY."""
    jsk = JSecretKey.generate(jax.random.key(42), TEST_TINY)
    jck = JCloudKey.generate(jax.random.key(8), jsk)
    arrays = {"lv0": np.asarray(jsk.lv0), "lv1": np.asarray(jsk.lv1), "testvec": np.asarray(jck.testvec),
              "bsk": np.asarray(jck.bsk), "ksk_limbs": np.asarray(jck.ksk_limbs)}
    return jsk, jck, PK.secret_key_from_numpy(arrays, PTINY, "cpu"), PK.cloud_key_from_numpy(arrays, PTINY, "cpu")


def _j_xor_into_body(out, cur):
    """scripts/bench_suite.py:117-122, as written there."""
    s = jnp.sum(jnp.ravel(out).astype(jnp.uint32)) & jnp.uint32(1)
    a = cur[0].at[..., -1].add(s + jnp.uint32(1))
    return (a, *cur[1:])


# ---------------------------------------------------------------------------
# bench.py
# ---------------------------------------------------------------------------

def test_bench_measure_and_line_have_the_jax_fields():
    """`measure` at TEST_TINY on the CPU decrypts every gate right, both
    keys; the line assembled from a headline and a strict pass has exactly
    the fields of BENCH_r05.json "parsed" (no correctness field at 1.0)."""
    res = bench.measure("TEST_TINY", 4, 2, CPU)
    assert res["correctness"] == 1.0 and "mb_correct" not in res
    assert {"gates_per_sec", "latency_ms_b1", "latency_ms_b1_mb", "keygen_warm_ms"} <= res.keys()
    line = bench.bench_line("SECURITY_128_BIT_FAST", res, res)
    parsed = json.loads((ROOT / "BENCH_r05.json").read_text())["parsed"]
    assert set(line) == set(parsed)
    assert line["vs_baseline"] == round(res["gates_per_sec"] / (1000.0 / 15.0), 2)
    bad = {**res, "correctness": 0.5, "mb_correct": False}
    line = bench.bench_line("SECURITY_128_BIT_FAST", bad, bad)
    assert line["correctness"] == line["strict_correctness"] == 0.5 and line["mb_correct"] is False


def test_bench_params_variable_skips_the_strict_pass(monkeypatch):
    """bench.py:273-276: RS_TFHE_BENCH_PARAMS names the one set measured;
    without it the strict pass follows unless RS_TFHE_BENCH_STRICT=0. The
    defaults are bench.py's (B = 4096, 5 iterations)."""
    calls = []
    canned = {"gates_per_sec": 1.0, "latency_ms_b1": 1.0, "keygen_warm_ms": 1.0, "correctness": 1.0}
    monkeypatch.setattr(bench, "measure", lambda p, b, i, d: calls.append((p, b, i)) or canned)
    for var in ("RS_TFHE_BENCH_PARAMS", "RS_TFHE_BENCH_STRICT", "RS_TFHE_BENCH_BATCH", "RS_TFHE_BENCH_ITERS"):
        monkeypatch.delenv(var, raising=False)
    assert "strict_params" in bench.run(CPU)["line"]
    assert calls == [("SECURITY_128_BIT_FAST", 4096, 5), ("SECURITY_128_BIT", 4096, 5)]
    calls.clear()
    monkeypatch.setenv("RS_TFHE_BENCH_PARAMS", "SECURITY_128_BIT")
    assert "strict_params" not in bench.run(CPU)["line"] and calls == [("SECURITY_128_BIT", 4096, 5)]
    calls.clear()
    monkeypatch.delenv("RS_TFHE_BENCH_PARAMS")
    monkeypatch.setenv("RS_TFHE_BENCH_STRICT", "0")
    bench.run(CPU)
    assert calls == [("SECURITY_128_BIT_FAST", 4096, 5)]


# ---------------------------------------------------------------------------
# bench_suite.py
# ---------------------------------------------------------------------------

def test_suite_lists_the_38_metrics_of_the_jax_suite():
    metrics = json.loads((ROOT / "BENCH_SUITE.json").read_text())["metrics"]
    assert len(metrics) == 38
    assert [(n, u) for n, u, _ in suite.CASES] == [(m["name"], m["unit"]) for m in metrics]
    assert suite.EXTRA[0] == "radix_nibble_add8_b64_RADIX" and len(suite.EXTRA) == 13


def test_xor_into_body_equals_the_jax_suite():
    """Words near 2^32 wrap; the parity covers every word of the output."""
    rng = np.random.default_rng(3)
    out = rng.integers(0, 1 << 32, (5, 2, 17), dtype=np.uint32)
    cur = rng.integers(0, 1 << 32, (5, 17), dtype=np.uint32)
    cur[0, -1], cur[1, -1] = 0xFFFFFFFF, 0xFFFFFFFE
    for flip in (0, 1):
        out[0, 0, 0] ^= flip
        ref = _j_xor_into_body(jnp.asarray(out), (jnp.asarray(cur), jnp.asarray(cur)))
        got = suite.xor_into_body(to_torch(out, "cpu"), (to_torch(cur, "cpu"), to_torch(cur, "cpu")))
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(to_numpy(g), np.asarray(r))
    j_step = (jnp.asarray(cur) + (jnp.sum(jnp.asarray(out)) & jnp.uint32(1)),)  # scripts/bench_suite.py:261
    np.testing.assert_array_equal(to_numpy(suite.add_parity(to_torch(out, "cpu"), (to_torch(cur, "cpu"),))[0]),
                                  np.asarray(j_step[0]))


def test_suite_ops_equal_jax(keys):
    """The NAND, the rotation of the NAND linear form and the key switch of
    its extraction, with the JAX key carried across, at B = 4."""
    jsk, jck, _, pck = keys
    bits = np.array([True, False, True, True])
    ja = JT.lwe_encrypt_bool(jax.random.key(1), jsk.lv0, jnp.asarray(bits), TEST_TINY.tlwe_lv0.alpha)
    jb = JT.lwe_encrypt_bool(jax.random.key(2), jsk.lv0, jnp.asarray(~bits), TEST_TINY.tlwe_lv0.alpha)
    pa, pb = to_torch(np.asarray(ja), "cpu"), to_torch(np.asarray(jb), "cpu")
    np.testing.assert_array_equal(to_numpy(suite.gates.nand(pa, pb, pck)), np.asarray(JG.nand(ja, jb, jck)))
    jlin = JG._nand_lin(ja, JG._lin(ja))  # scripts/bench_suite.py:200
    plin = suite.rotation_input(pa)
    np.testing.assert_array_equal(to_numpy(plin), np.asarray(jlin))
    jacc = j_blind_rotate(jlin, jck.testvec, jck.bsk, TEST_TINY)
    pacc = suite.blind_rotate(plin, pck.testvec, pck.bsk, PTINY)
    np.testing.assert_array_equal(to_numpy(pacc), np.asarray(jacc))
    jks = j_identity_key_switch(j_sample_extract(jacc), jck.ksk_limbs, TEST_TINY)
    np.testing.assert_array_equal(to_numpy(identity_key_switch(sample_extract(pacc), pck.ksk_limbs, PTINY)),
                                  np.asarray(jks))


def test_suite_steps_equal_jax():
    """The external-product step (scripts/bench_suite.py:255-258, jitted
    here as in the JAX suite's chains) on the JAX suite's kind of random
    operands; the Nussbaumer step (:265-267) computes the same exact product,
    so it equals the port's external-product step bit for bit."""
    rng = np.random.default_rng(0)
    g = TEST_TINY.trgsw_lv1
    step_polys = rng.integers(0, 1 << 32, (2 * g.l, 2, TEST_TINY.n1), dtype=np.uint32)
    trlwe = rng.integers(0, 1 << 32, (6, 2, TEST_TINY.n1), dtype=np.uint32)

    @jax.jit
    def j_ext_step(x, polys):
        d = j_gadget_decompose(x, TEST_TINY)
        return polymul_small_by_torus_multi(d, build_step_matrix(polys), TEST_TINY.digit_limbs, 2)

    ref = np.asarray(j_ext_step(jnp.asarray(trlwe), jnp.asarray(step_polys)))
    ps, pt = to_torch(step_polys, "cpu"), to_torch(trlwe, "cpu")
    got = suite.ext_step(pt, ps, PTINY)
    np.testing.assert_array_equal(to_numpy(got), ref)
    assert suite.nussbaumer.check_bounds(PTINY)
    assert torch.equal(suite.nuss_step(pt, ps, PTINY), got)


def test_suite_draws_follow_the_jax_order():
    """The plaintexts come from one default_rng(0) in the JAX suite's order:
    the first draw is B = 1's bit, the step polynomials follow the radix
    values, the 110-bit set's bits come last."""
    d = suite.draw_plaintexts(np.random.default_rng(0), PTINY)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(d["b1"], rng.integers(0, 2, 1).astype(bool))
    np.testing.assert_array_equal(d["b128"], rng.integers(0, 2, 128).astype(bool))
    assert d["step_polys"].shape == (2 * PTINY.trgsw_lv1.l, 2, PTINY.n1) and d["trlwe"].shape == (2048, 2, PTINY.n1)
    assert [len(d[k]) for k in ("STRICT", "80BIT", "110BIT")] == [4096] * 3


def test_suite_cases_run_at_a_small_size(tmp_path):
    """A subset of the table end to end at TEST_TINY, batches capped at 4:
    one row per name, in table order, merged into an artifact by name with
    the sweep's rows beside it attached."""
    names = ["keygen_warm", "gate_nand_b128", "blind_rotate_b2048", "keyswitch_b2048",
             "external_product_step_b2048", "mux_b1024"]
    rows = suite.run_cases(suite.Suite(CPU, "TEST_TINY", max_batch=4), names)
    assert [r["name"] for r in rows] == [n for n in suite.NAMES if n in names]
    assert all(r["value"] > 0 and r["kernels"] == {} for r in rows)
    with pytest.raises(ValueError, match="unknown metrics"):
        suite.run_cases(suite.Suite(CPU, "TEST_TINY", max_batch=4), ["gate_nand_b3"])
    path = tmp_path / "suite.json"
    (tmp_path / "LATENCY_SWEEP_torch_h100.json").write_text(json.dumps({"rows": [{"impl": "auto"}]}))
    fields = {"device": "cpu", "power_limit": None, "torch": "x", "cuda": None}
    suite.merge(str(path), "TEST_TINY", rows[2:], fields)
    art = suite.merge(str(path), "TEST_TINY", [{**rows[0], "value": 1.0}, rows[3]], fields)
    assert [m["name"] for m in art["metrics"]] == [r["name"] for r in [rows[0], *rows[2:]]]
    assert art["metrics"][0]["value"] == 1.0 and art["latency_vs_batch"] == [{"impl": "auto"}]


# ---------------------------------------------------------------------------
# bench_latency_sweep.py
# ---------------------------------------------------------------------------

def test_sweep_rows_for_every_route_and_the_cap(monkeypatch, tmp_path):
    """One row per port route at B = 1 and 2, each decrypted and with the
    JAX sweep's fields; `auto_mb` takes the multi-bit rotation up to the cap
    (4 at TEST_TINY) and the standard one above it."""
    rows = sweep.sweep(CPU, ["TEST_TINY"], list(sweep.ROUTES), [1, 2])
    assert [(r["batch"], r["impl"]) for r in rows] == [(b, i) for b in (1, 2) for i in sweep.ROUTES]
    assert all(r["correctness"] == 1.0 and r["kernels"] == "plain" for r in rows)
    jax_fields = set(json.loads((ROOT / "LATENCY_SWEEP_r05.json").read_text())["rows"][0])
    assert jax_fields <= rows[0].keys()
    ran = []
    for fn in ("blind_rotate_plain", "blind_rotate_mb_plain"):
        real = getattr(PBR, fn)
        monkeypatch.setattr(PBR, fn, lambda *a, _real=real, _fn=fn: ran.append((_fn, a[0].shape[0])) or _real(*a))
    assert PBR.mb_route_batch_cap(PTINY) == 4
    sk = PK.SecretKey.generate(PTINY, torch.Generator().manual_seed(42))
    ck_mb = PK.CloudKey.generate(sk, torch.Generator().manual_seed(7), multibit=True)
    for batch in (4, 8):
        ct = torch.zeros(batch, PTINY.n0 + 1, dtype=torch.int32)
        with sweep.route("auto"):
            sweep.gates.nand(ct, ct, ck_mb)
    assert ran == [("blind_rotate_mb_plain", 4), ("blind_rotate_plain", 8)]
    path = tmp_path / "sweep.json"
    fields = {"device": "cpu", "power_limit": None, "torch": "x", "cuda": None}
    sweep.merge(str(path), rows[5:], fields)
    art = sweep.merge(str(path), rows[:5] + [{**rows[5], "ms_per_gate_dispatch": 1.0}], fields)
    assert [(r["batch"], r["impl"]) for r in art["rows"]] == [(r["batch"], r["impl"]) for r in rows]
    assert art["rows"][5]["ms_per_gate_dispatch"] == 1.0 and "fused_tile" in art["note"]


# ---------------------------------------------------------------------------
# bench_multichip.py
# ---------------------------------------------------------------------------

def test_multichip_on_two_virtual_devices():
    """Strong, weak and TP-vs-DP points on 2 virtual CPU devices, each
    decrypted right and marked virtual, with the JAX artifact's keys."""
    out = multichip.run(CPU, n_devices=2, total_b=8, per_dev=4, tp_batches=(1, 2))
    jax_keys = set(json.loads((ROOT / "SCALING_r05.json").read_text()))
    assert jax_keys <= out.keys() and out["virtual"] is True
    points = out["dp_strong_scaling"] + out["dp_weak_scaling"]
    assert [r["devices"] for r in points] == [1, 2, 1, 2]
    assert all(r["correctness"] == 1.0 and r["virtual"] for r in points)
    for row in out["tp_vs_dp_latency"]:
        assert row["virtual"] and row["dp_correctness"] == 1.0
        assert row["tp_model_axis"] == 2 and row["tp_correctness"] == 1.0


# ---------------------------------------------------------------------------
# No card, no --cpu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["bench", "bench_suite", "bench_latency_sweep", "bench_multichip"])
def test_scripts_need_a_card_without_cpu(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    mod = {"bench": bench, "bench_suite": suite, "bench_latency_sweep": sweep, "bench_multichip": multichip}[name]
    args = [] if name == "bench_multichip" else ["--out", str(tmp_path / "x.json")]  # RS_TFHE_SCALING_OUT there
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(args)
    assert not (tmp_path / "x.json").exists()
