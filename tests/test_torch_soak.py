"""PyTorch port: the reliability entry points (scripts/torch/soak.py and
scripts/torch/measure_mb_noise.py) on the CPU, at TEST_TINY and, for the
NIBBLE phase, the N=512 set of tests/test_torch_arithmetic.py.

The soak's gate chain, fed JAX's ciphertexts and keys carried into the port,
gives JAX's ciphertexts bit for bit (tolerance 0), with a standard key and
with a multi-bit key at B = 2; the noise measurement, fed the JAX script's
inputs, gives JAX's noise array and model std exactly. Each soak phase runs
end to end on the CPU, and two injected faults show that its checks bite: a
flipped low bit of one rotation (a mismatch against the plain version, while
every gate still decrypts) and a flipped decrypted bit (an error). The
committed H100 artifacts are read by tests/test_torch_soak_artifact.py."""

import ast
import functools
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
from rs_tfhe_tpu.params import TEST_TINY, TfheParams, TlweParams, TrgswParams, TrlweParams  # noqa: E402
from rs_tfhe_tpu.torus import f64_to_torus as j_f64_to_torus  # noqa: E402
from rs_tfhe_tpu.utils.noise import estimate as j_estimate  # noqa: E402
from rs_tfhe_tpu.utils.noise import measure_phase_noise as j_measure_phase_noise  # noqa: E402
from rs_tfhe_tpu_torch import config as PC  # noqa: E402
from rs_tfhe_tpu_torch import key as PK  # noqa: E402
from rs_tfhe_tpu_torch.ops import blind_rotate as PBR  # noqa: E402
from rs_tfhe_tpu_torch.params import params_from  # noqa: E402
from rs_tfhe_tpu_torch.torus import to_numpy, to_torch  # noqa: E402

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts" / "torch"
PTINY = params_from(TEST_TINY)
#: tests/test_mul_radix.py:25-33, as tests/test_torch_arithmetic.py copies it: base-16 LUT margins
MP = TfheParams(
    security_bits=0,
    description="insecure tiny set with modulus-32 LUT margins (N=512)",
    tlwe_lv0=TlweParams(n=16, alpha=1.0e-9),
    tlwe_lv1=TlweParams(n=512, alpha=1.0e-12),
    trlwe_lv1=TrlweParams(n=512, alpha=1.0e-12),
    trgsw_lv1=TrgswParams(n=512, nbit=9, bgbit=6, l=3, basebit=2, iks_t=8, alpha=1.0e-12),
)


def _load(name):
    """scripts/torch/<name>.py as a module (measure_mb_noise imports soak beside it)."""
    if str(SCRIPTS) not in sys.path:
        sys.path.insert(0, str(SCRIPTS))
    spec = importlib.util.spec_from_file_location(f"_torch_script_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


soak = _load("soak")
noise = _load("measure_mb_noise")

JAX_GATE_FIELDS = {"params", "multibit", "batch", "gates", "errors", "seconds", "gates_per_s", "p_fail_upper_95"}
JAX_NIBBLE_FIELDS = {"params", "adds", "pbs", "errors", "seconds", "p_fail_per_pbs_upper_95"}
PORT_FIELDS = {"device", "power_limit", "spot_checks", "mismatches"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port: the suite runs six workers on the
    machine's cores, and torch's default of a thread a core oversubscribes
    them (the JAX side keeps its own pool)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def _keys(mb: bool):
    """(JAX secret key, JAX cloud key, port secret key, port cloud key)."""
    jsk = JSecretKey.generate(jax.random.key(170), TEST_TINY)
    jck = JCloudKey.generate(jax.random.key(171), jsk, multibit=mb)
    arrays = {"lv0": np.asarray(jsk.lv0), "lv1": np.asarray(jsk.lv1), "testvec": np.asarray(jck.testvec),
              "bsk": np.asarray(jck.bsk), "ksk_limbs": np.asarray(jck.ksk_limbs)}
    if mb:
        arrays["bsk_mb"] = np.asarray(jck.bsk_mb)
    return jsk, jck, PK.secret_key_from_numpy(arrays, PTINY, "cpu"), PK.cloud_key_from_numpy(arrays, PTINY, "cpu")


@pytest.fixture(params=["standard", "multibit"])
def keys(request):
    return _keys(request.param == "multibit")


def _jax_bits(jsk, shape, seed):
    """Random bits, their JAX ciphertexts, and the same words in the port."""
    bits = np.random.default_rng(seed).integers(0, 2, shape).astype(bool)
    jct = JT.lwe_encrypt_bool(jax.random.key(seed), jsk.lv0, jnp.asarray(bits), TEST_TINY.tlwe_lv0.alpha)
    return bits, jct, to_torch(np.asarray(jct), "cpu")


def test_soak_chain_equals_jax_chain(keys):
    """One dispatch (LAYERS // 2 steps of nand, xor): B = 8 with a standard
    key, B = 2 with a multi-bit key (the multi-bit rotation in both
    packages)."""
    jsk, jck, _, pck = keys
    batch = 2 if pck.bsk_mb is not None else 8
    _, ja, pa = _jax_bits(jsk, batch, 172)
    _, jb, pb = _jax_bits(jsk, batch, 173)
    for _ in range(soak.LAYERS // 2):
        ja, jb = JG.nand(ja, jb, jck), JG.xor(ja, jb, jck)
        pa, pb = soak.layer(pa, pb, pck)
    np.testing.assert_array_equal(to_numpy(pa), np.asarray(ja))
    np.testing.assert_array_equal(to_numpy(pb), np.asarray(jb))


def test_measure_set_equals_jax_on_jax_inputs():
    """K = 16 NANDs at B = 2 with a multi-bit key on the JAX script's inputs:
    the noise array of JAX's `measure_phase_noise` on JAX's outputs and JAX's
    `estimate` (the standard key's control runs the same code)."""
    jsk, jck, psk, pck = _keys(True)
    k_iters = 16
    a_bits, ja, pa = _jax_bits(jsk, (k_iters, 2), 174)
    b_bits, jb, pb = _jax_bits(jsk, (k_iters, 2), 175)
    jouts = np.stack([np.asarray(JG.nand(ja[k], jb[k], jck)) for k in range(k_iters)]).reshape(-1, TEST_TINY.n0 + 1)
    want = ~(a_bits & b_bits).reshape(-1)
    mu = int(j_f64_to_torus(0.125))
    jnoise = j_measure_phase_noise(jnp.asarray(jouts), jsk.lv0,
                                   np.where(want, np.uint32(mu), np.uint32((1 << 32) - mu)))
    row, pnoise = noise.measure_set("TEST_TINY", k_iters, True, psk, pck, inputs=(a_bits, b_bits, pa, pb))
    np.testing.assert_array_equal(pnoise, np.asarray(jnoise))
    assert row["model_std"] == j_estimate(TEST_TINY, mb_group=2).bootstrap_out_std
    assert row["samples"] == 2 * k_iters and row["gate_errors"] == 0
    assert row["measured_std"] == float(np.asarray(jnoise).std())


@pytest.mark.parametrize("multibit", [False, True], ids=["standard", "multibit"])
def test_soak_gates_row(multibit):
    """Two dispatches on the CPU: every field of the JAX row and the port's,
    no error, a spot check at the first dispatch, no mismatch."""
    batch = 2 if multibit else 8
    row = soak.soak_gates(PTINY, 2 * soak.LAYERS * batch, batch=batch, multibit=multibit, device="cpu")
    assert JAX_GATE_FIELDS | PORT_FIELDS <= row.keys()
    assert row["params"] == "TEST_TINY" and row["multibit"] == multibit and row["batch"] == batch
    assert row["gates"] == 2 * soak.LAYERS * batch and row["errors"] == 0
    assert row["spot_checks"] >= 1 and row["mismatches"] == 0
    assert row["device"] == "cpu" and row["power_limit"] is None
    assert row["p_fail_upper_95"] == 3.0 / row["gates"]


def test_soak_nibble_row():
    """The NIBBLE phase at the N=512 set, one dispatch of 8 adds."""
    row = soak.soak_nibble(params_from(MP), 8, batch=8, device="cpu")
    assert JAX_NIBBLE_FIELDS | PORT_FIELDS <= row.keys()
    assert row["adds"] == 8 and row["pbs"] == 24 and row["errors"] == 0
    assert row["spot_checks"] >= 1 and row["mismatches"] == 0


@pytest.fixture
def flipped_rotation(monkeypatch):
    """The route's rotation with bit 0 of one accumulator word of row 0
    flipped: the gate still decrypts, its ciphertext differs. The plain
    standard rotation is flipped only off step_impl="xla" (the spot check's
    reference); the multi-bit one is the CPU route itself (the soak's
    reference is bound apart)."""
    def flip(fn, when):
        def flipped(*args):
            out = fn(*args)
            if when():
                out = out.clone()
                out[0, 1, 0] ^= 1
            return out
        return flipped

    monkeypatch.setattr(PBR, "blind_rotate_plain", flip(PBR.blind_rotate_plain, lambda: PC.config.step_impl != "xla"))
    monkeypatch.setattr(PBR, "blind_rotate_mb_plain", flip(PBR.blind_rotate_mb_plain, lambda: True))


@pytest.mark.parametrize("multibit", [False, True], ids=["standard", "multibit"])
def test_a_flipped_rotation_bit_is_a_mismatch(flipped_rotation, multibit):
    batch = 2 if multibit else 8
    row = soak.soak_gates(PTINY, 4 * soak.LAYERS * batch, batch=batch, multibit=multibit, device="cpu")
    assert row["mismatches"] >= 1 and row["errors"] == 0
    assert row["gates"] == soak.LAYERS * batch  # the phase stopped at the first dispatch


def test_a_mismatch_fails_the_phase(flipped_rotation, tmp_path):
    out = tmp_path / "soak.json"
    argv = ["--cpu", "--params", "TEST_TINY", "--phase", "fast_mb", "--target", "1", "--out", str(out)]
    assert soak.main(argv) == 1
    assert json.loads(out.read_text())["fast_mb"]["mismatches"] >= 1


def test_a_flipped_decrypted_bit_is_an_error(monkeypatch):
    decrypt = soak.decrypt_bits

    def flipped(ct, sk):
        bits = decrypt(ct, sk).clone()
        bits[0] = ~bits[0]
        return bits

    monkeypatch.setattr(soak, "decrypt_bits", flipped)
    row = soak.soak_gates(PTINY, 2 * soak.LAYERS * 8, batch=8, device="cpu")
    assert row["errors"] >= 1 and row["mismatches"] == 0


def test_multibit_chunks_add_up(tmp_path):
    """Chunks of the multi-bit phase merge into one row whose counts add up,
    a rerun chunk replacing its earlier row; other phases stay."""
    path = str(tmp_path / "soak.json")
    base = {"params": "SECURITY_128_BIT_FAST", "multibit": True, "batch": 2, "errors": 0, "device": "d",
            "power_limit": "700.00 W", "spot_checks": 2, "spot_every": 500, "mismatches": 0}
    soak.merge(path, "fast", {**base, "multibit": False, "gates": 10, "seconds": 1.0})
    for chunk, gates in ((0, 100), (1, 60), (1, 50)):
        art = soak.merge(path, "fast_mb", {**base, "gates": gates, "seconds": gates / 10, "chunk": chunk,
                                           "key0": 140 + 4 * chunk})
    mb = art["fast_mb"]
    assert [c["gates"] for c in mb["chunks"]] == [100, 50]
    assert mb["gates"] == 150 and mb["seconds"] == 15.0 and mb["gates_per_s"] == 10.0
    assert mb["spot_checks"] == 4 and mb["p_fail_upper_95"] == 3.0 / 150
    assert json.loads(Path(path).read_text())["fast"]["gates"] == 10


@pytest.mark.parametrize("name", ["soak", "measure_mb_noise"])
def test_scripts_need_a_card_without_cpu(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    args = ["--phase", "fast", "--target", "1"] if name == "soak" else ["--quick"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        (soak if name == "soak" else noise).main([*args, "--out", str(tmp_path / "x.json")])


@pytest.mark.parametrize("path", sorted(SCRIPTS.glob("*.py")), ids=lambda p: p.name)
def test_scripts_import_no_jax(path):
    """No script of scripts/torch/ imports JAX or the JAX package."""
    for node in ast.walk(ast.parse(path.read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "rs_tfhe_tpu"), f"{path.name} imports {name}"
