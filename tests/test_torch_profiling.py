"""PyTorch port: `utils/profiling` (force, Timer, gate_throughput, trace)
against the JAX package's on the same spans and at TEST_TINY, and the
package exports of `utils` and the new modules."""

import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import rs_tfhe_tpu  # noqa: E402
import rs_tfhe_tpu.params as JP  # noqa: E402
import rs_tfhe_tpu_torch  # noqa: E402
from rs_tfhe_tpu import utils as JU  # noqa: E402
from rs_tfhe_tpu.key import SecretKey as JSecretKey  # noqa: E402
from rs_tfhe_tpu.key import CloudKey as JCloudKey  # noqa: E402
from rs_tfhe_tpu_torch import gates as PG  # noqa: E402
from rs_tfhe_tpu_torch import key as PK  # noqa: E402
from rs_tfhe_tpu_torch import tlwe as PT  # noqa: E402
from rs_tfhe_tpu_torch import utils as PU  # noqa: E402
from rs_tfhe_tpu_torch.params import params_from  # noqa: E402
from rs_tfhe_tpu_torch.utils import profiling as PP  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port: the suite runs six workers on the
    machine's cores, and torch's default of a thread a core oversubscribes
    them (the JAX side keeps its own pool)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TINY, PTINY = JP.TEST_TINY, params_from(JP.TEST_TINY)


def test_exports_match_the_jax_package():
    for name in ("Timer", "force", "gate_throughput", "trace", "load_cloud_key", "load_secret_key",
                 "save_cloud_key", "save_secret_key"):
        assert hasattr(JU, name) and hasattr(PU, name), name
    assert hasattr(PU, "save_reenc_key") and hasattr(PU, "load_reenc_key")
    assert hasattr(rs_tfhe_tpu, "proxy_reenc") and hasattr(rs_tfhe_tpu_torch, "proxy_reenc")


def test_timer_report_matches_jax():
    spans = {"keygen": [0.25, 0.125, 0.5], "nand": [0.003]}
    assert PP.Timer(spans=dict(spans)).report() == JU.Timer(spans=dict(spans)).report()
    timer = PP.Timer()
    for _ in range(3):
        with timer.span("add", sync_on=torch.ones(4) + 1):
            pass
    assert len(timer.spans["add"]) == 3 and timer.report().startswith("add: n=3 total=")


def test_force_takes_nested_tensors_and_rejects_none():
    PP.force(torch.ones(3))
    PP.force({"a": [1, (torch.zeros(2),)]})
    with pytest.raises(TypeError, match="no tensor"):
        PP.force([1, 2])


def test_gate_throughput_runs_chained_gates():
    """iters chained calls after one warm-up, the batch over the mean call."""
    jsk = JSecretKey.generate(jax.random.key(701), TINY)
    jck = JCloudKey.generate(jax.random.key(702), jsk)
    arrays = {"lv0": np.asarray(jsk.lv0), "lv1": np.asarray(jsk.lv1), "testvec": np.asarray(jck.testvec),
              "bsk": np.asarray(jck.bsk), "ksk_limbs": np.asarray(jck.ksk_limbs)}
    psk, pck = PK.secret_key_from_numpy(arrays, PTINY, "cpu"), PK.cloud_key_from_numpy(arrays, PTINY, "cpu")
    g = torch.Generator().manual_seed(703)
    bits_a, bits_b = np.asarray([True, False, True, True]), np.asarray([True, True, False, True])
    a = PT.lwe_encrypt_bool(g, psk.lv0, bits_a, PTINY.tlwe_lv0.alpha)
    b = PT.lwe_encrypt_bool(g, psk.lv0, bits_b, PTINY.tlwe_lv0.alpha)
    outs = []

    def nand(x, y, ck):
        outs.append(PG.nand(x, y, ck))
        return outs[-1]

    rate = PP.gate_throughput(nand, a, b, pck, iters=3)
    assert np.isfinite(rate) and rate > 0 and len(outs) == 4
    expect = bits_a
    for _ in range(3):
        expect = ~(expect & bits_b)
    np.testing.assert_array_equal(PT.lwe_decrypt_bool(outs[-1], psk.lv0).numpy(), expect)


def test_trace_writes_a_chrome_trace(tmp_path):
    path = tmp_path / "trace.json"
    with PP.trace(path):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_trace_does_not_swallow_a_profiler_failure(monkeypatch, tmp_path):
    def broken(*args, **kwargs):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        with PP.trace(tmp_path / "t.json"):
            pass
