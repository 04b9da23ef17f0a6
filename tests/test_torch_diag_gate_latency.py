"""PyTorch port: scripts/torch/diag_gate_latency.py, the B=1 gate split by
stage, on the CPU at TEST_TINY.

Each of the four chains (rotation, +extract, +key switch, the public NAND)
at 2 iterations gives JAX's chain bit for bit (tolerance 0): the JAX chains
are re-implemented here from scripts/diag_gate_latency.py:76-110 as written
there (the JAX script configures a compile cache at import), fed the same
ciphertexts, on JAX's keys carried into the port, with a standard key as the
JAX script times and with a multi-bit key (both packages then take the
multi-bit rotation at B = 2). The script runs under --cpu and prints rows
with the JAX script's keys; without a card and without --cpu it raises; it
imports nothing of JAX or of the JAX package."""

import ast
import contextlib
import dataclasses
import importlib.util
import io
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
from rs_tfhe_tpu.ops.extract import sample_extract as j_sample_extract  # noqa: E402
from rs_tfhe_tpu.ops.keyswitch import identity_key_switch as j_identity_key_switch  # noqa: E402
from rs_tfhe_tpu.params import TEST_TINY  # noqa: E402
from rs_tfhe_tpu_torch import key as PK  # noqa: E402
from rs_tfhe_tpu_torch.params import params_from  # noqa: E402
from rs_tfhe_tpu_torch.torus import to_numpy, to_torch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = ROOT / "scripts" / "torch"
JAX_SCRIPT = ROOT / "scripts" / "diag_gate_latency.py"
PTINY = params_from(TEST_TINY)
ITERS = 2


def _load(name):
    """scripts/torch/<name>.py as a module of its own name."""
    if str(SCRIPTS) not in sys.path:
        sys.path.insert(0, str(SCRIPTS))
    spec = importlib.util.spec_from_file_location(f"_torch_diag_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


diag = _load("diag_gate_latency")


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
    """(JAX cloud key, port cloud key) by key kind at TEST_TINY, and the
    JAX script's two ciphertext batches at B = 2 (JAX's, and the port's)."""
    jsk = JSecretKey.generate(jax.random.key(42), TEST_TINY)
    jck = JCloudKey.generate(jax.random.key(7), jsk, multibit=True)
    arrays = {"testvec": np.asarray(jck.testvec), "bsk": np.asarray(jck.bsk),
              "ksk_limbs": np.asarray(jck.ksk_limbs), "bsk_mb": np.asarray(jck.bsk_mb)}
    std = {k: v for k, v in arrays.items() if k != "bsk_mb"}
    bits = np.random.default_rng(0).integers(0, 2, (2, 2)).astype(bool)
    ka, kb = jax.random.split(jax.random.key(3))
    alpha = TEST_TINY.tlwe_lv0.alpha
    ja = JT.lwe_encrypt_bool(ka, jsk.lv0, jnp.asarray(bits[0]), alpha)
    jb = JT.lwe_encrypt_bool(kb, jsk.lv0, jnp.asarray(bits[1]), alpha)
    return {
        "standard": (jck, None, PK.cloud_key_from_numpy(std, PTINY, "cpu")),
        "multibit": (jck, jck.bsk_mb, PK.cloud_key_from_numpy(arrays, PTINY, "cpu")),
        "inputs": (ja, jb, to_torch(np.asarray(ja), "cpu"), to_torch(np.asarray(jb), "cpu")),
    }


@pytest.fixture(scope="module")
def j_steps(keys):
    """The JAX calls of the chains' bodies by key kind, each jitted once
    (an eager JAX rotation compiles anew at every call)."""
    steps = {}
    for kind in ("standard", "multibit"):
        jck, jmb, _ = keys[kind]
        if kind == "standard":
            jck = dataclasses.replace(jck, bsk_mb=None)
        steps[kind] = {
            "rot": jax.jit(lambda x, y, k=jck, mb=jmb: j_blind_rotate(
                JG._nand_lin(x, y), k.testvec, k.bsk, k.params, bsk_packed=k.bsk_packed, bsk_mb=mb)),
            "ext": jax.jit(lambda acc: j_sample_extract(acc, 0)),
            "ks": jax.jit(lambda lv1, k=jck: j_identity_key_switch(lv1, k.ksk_limbs, k.params)),
            "nand": jax.jit(lambda x, y, k=jck: JG.nand(x, y, k)),
        }
    return steps


def _j_chain(stage, x, y, step, iters):
    """scripts/diag_gate_latency.py:76-110 as written there, each call of
    the loop body jitted (`j_steps`), with the key's multi-bit material
    passed to the rotation in the multi-bit case."""
    for _ in range(iters):
        if stage == "nand":
            x = step["nand"](x, y)
            continue
        acc = step["rot"](x, y)
        if stage == "rot":
            x = x + acc[:, 0, : x.shape[1]].astype(jnp.uint32)
            continue
        lv1 = step["ext"](acc)
        x = x + lv1[:, : x.shape[1]] if stage == "rot+ext" else step["ks"](lv1)
    return x


@pytest.mark.parametrize("kind", ["standard", "multibit"])
@pytest.mark.parametrize("stage", ["rot", "rot+ext", "rot+ext+ks", "nand"])
def test_chain_equals_jax(keys, j_steps, stage, kind):
    pck = keys[kind][2]
    ja, jb, pa, pb = keys["inputs"]
    ref = np.asarray(_j_chain(stage, ja, jb, j_steps[kind], ITERS))
    got = diag.STAGES[stage](pa, pb, pck, ITERS)
    np.testing.assert_array_equal(to_numpy(got), ref)


def test_stages_and_row_keys_are_the_jax_scripts(monkeypatch):
    """The stage names in order are the JAX script's (read from its source),
    and --cpu prints a row a batch with exactly the JAX row's keys."""
    tree = ast.parse(JAX_SCRIPT.read_text())
    names = next([e.elts[0].value for e in node.elts] for node in ast.walk(tree)
                 if isinstance(node, ast.List) and node.elts and isinstance(node.elts[0], ast.Tuple))
    assert list(diag.STAGES) == names
    monkeypatch.setenv("RS_TFHE_BENCH_PARAMS", "TEST_TINY")
    monkeypatch.setattr(diag, "ITERS", 2)
    monkeypatch.setattr(diag, "REPEATS", 1)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert diag.main(["--cpu", "1", "2"]) == 0
    rows = [json.loads(line) for line in out.getvalue().splitlines()]
    assert [r["batch"] for r in rows] == [1, 2]
    for r in rows:
        assert set(r) == {"batch", *(n + "_ms" for n in names)}
        assert all(r[n + "_ms"] > 0 for n in names)


def test_without_a_card_it_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the script runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        diag.main(["1"])


def test_imports_no_jax():
    """The script and the scripts/torch/ modules it imports import neither
    JAX nor the JAX package."""
    seen, todo = set(), ["diag_gate_latency"]
    while todo:
        name = todo.pop()
        seen.add(name)
        for node in ast.walk(ast.parse((SCRIPTS / f"{name}.py").read_text())):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "rs_tfhe_tpu"), f"{name}.py imports {mod}"
                if (SCRIPTS / f"{top}.py").exists() and top not in seen:
                    todo.append(top)
    assert {"diag_gate_latency", "bench_common", "soak"} <= seen
