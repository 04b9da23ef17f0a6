"""PyTorch port: scripts/torch/tpu_validation.py, every capability asserted,
on the CPU at tiny sets.

The module-level set table (SETS) is pointed at TEST_TINY (the main set) and
the N=512 set of tests/test_mul_radix.py (the UINT4 stage's modulus-16 LUT),
and --small runs end to end: every check passes, in the JAX script's order
and under its texts, read from scripts/tpu_validation.py by AST (the
tripwire's text the one stated exception: the port's counterpart launches
P1's s16 unit on the card, and the check is skipped on the CPU as JAX's is
off a TPU). --write-golden then a verify passes, the two runs record equal
arrays, and one flipped word fails naming golden[<name>]; a flipped output
bit of one gate makes the run exit non-zero naming that gate. The script
imports nothing of JAX or of the JAX package, and raises without a card and
without --cpu. The committed golden file is read by
tests/test_torch_validation_artifact.py."""

import ast
import contextlib
import importlib.util
import io
import re
import shutil
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from rs_tfhe_tpu_torch.params import TEST_TINY, TfheParams, TlweParams, TrgswParams, TrlweParams  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = ROOT / "scripts" / "torch"
JAX_SCRIPT = ROOT / "scripts" / "tpu_validation.py"
#: tests/test_mul_radix.py:25-33: an N=512 ring with modulus-32 LUT margins
MP = TfheParams(
    security_bits=0,
    description="insecure tiny set with modulus-32 LUT margins (N=512)",
    tlwe_lv0=TlweParams(n=16, alpha=1.0e-9),
    tlwe_lv1=TlweParams(n=512, alpha=1.0e-12),
    trlwe_lv1=TrlweParams(n=512, alpha=1.0e-12),
    trgsw_lv1=TrgswParams(n=512, nbit=9, bgbit=6, l=3, basebit=2, iks_t=8, alpha=1.0e-12),
)
TINY_SETS = {"main": TEST_TINY, "uint4": MP, "radix": MP, "nibble": MP}
SMALL_GOLDEN = ["nand_128", "nand_mb_128", "mux_128", "pbs_square_128", "radix_add_128", "kogge_stone_128",
                "pbs_uint4"]


def _load(name):
    """scripts/torch/<name>.py as a module of its own name."""
    if str(SCRIPTS) not in sys.path:
        sys.path.insert(0, str(SCRIPTS))
    spec = importlib.util.spec_from_file_location(f"_torch_validation_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


V = _load("tpu_validation")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port: the suite runs six workers on the
    machine's cores, and torch's default of a thread a core oversubscribes
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _quiet(fn, *args):
    """fn(*args) with its stdout kept: (result, text)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*args)
    return res, out.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """--small --write-golden, then --small verifying that file, both on the
    CPU at the tiny sets of the module-level table."""
    golden = tmp_path_factory.mktemp("golden") / "golden.npz"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(V, "SETS", TINY_SETS)
        first = V.Validation("cpu", small=True, write_golden=True, golden=str(golden))
        _, log1 = _quiet(first.run)
        second = V.Validation("cpu", small=True, golden=str(golden))
        _, log2 = _quiet(second.run)
    return first, second, golden, log1 + log2


def _templates(path: Path) -> list[str]:
    """The first argument of every check(...) call in source order, an
    f-string's fields as {expression}."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        f = node.func
        if (f.id if isinstance(f, ast.Name) else f.attr if isinstance(f, ast.Attribute) else None) != "check":
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Constant):
            out.append((arg.lineno, arg.value))
        elif isinstance(arg, ast.JoinedStr):
            out.append((arg.lineno, "".join(v.value if isinstance(v, ast.Constant)
                                            else "{" + ast.unparse(v.value) + "}" for v in arg.values)))
    return [t for _, t in sorted(out)]


def _regex(template: str) -> re.Pattern:
    parts = re.split(r"\{[^}]*\}", template)
    return re.compile(".+".join(re.escape(p) for p in parts) + r"\Z")


def test_check_texts_are_the_jax_scripts():
    """Every check text of the JAX script, in its order, is the port's, but
    the tripwire's (the second in both: golden_finalize comes first)."""
    jax_t, port_t = _templates(JAX_SCRIPT), _templates(SCRIPTS / "tpu_validation.py")
    assert len(jax_t) == len(port_t) == 18
    differ = [i for i, (j, p) in enumerate(zip(jax_t, port_t)) if j != p]
    assert differ == [1]
    assert "mosaic" in jax_t[1] and "P1's s16 dot" in port_t[1]


def test_small_run_passes_every_check_in_the_jax_order(runs):
    """--small on the CPU: every check passes; each name matches a JAX
    check text, in the JAX script's order (its loops repeat a text); the
    tripwire and the multi-bit noise stage, card-only, do not run."""
    first, second, _, log = runs
    # golden_finalize is defined first and called last
    texts = _templates(JAX_SCRIPT)
    templates = [_regex(t) for t in texts[1:] + texts[:1]]
    for run in (first, second):
        pos = []
        for name in run.passed:
            idx = [i for i, r in enumerate(templates) if r.match(name)]
            assert idx, f"check {name!r} is not a JAX check text"
            pos.append(idx[0])
        assert pos == sorted(pos)
    gate_names = [n for n in first.passed if n.startswith("gate ") and "multibit" not in n]
    assert gate_names == [f"gate {g}" for g in ("nand", "and", "or", "nor", "xor", "xnor", "and_ny", "and_yn",
                                                 "or_ny", "or_yn")]
    assert len(first.passed) == 20 and second.passed[:20] == first.passed
    assert second.passed[20:] == [f"golden[{n}]" for n in SMALL_GOLDEN]
    assert "ALL 20 CHECKS PASSED (--small subset" in log and "ALL 27 CHECKS PASSED (--small subset" in log
    assert not any("noise" in n or "s16" in n for n in first.passed)
    assert set(first.stage_s) >= {"keygen", "gates", "multibit", "mux_not", "lut", "radix_add", "kogge_stone",
                                  "netlist", "proxy", "reload", "uint4", "golden"}


def test_golden_round_trip_and_determinism(runs, tmp_path):
    """The verify run recorded exactly the written arrays (int32, the
    ciphertexts' shapes); one flipped word in the file fails naming it."""
    first, second, golden, _ = runs
    stored = np.load(golden)
    assert sorted(stored.files) == sorted(SMALL_GOLDEN) == sorted(first.artifacts)
    for name in SMALL_GOLDEN:
        assert first.artifacts[name].dtype == np.int32
        np.testing.assert_array_equal(first.artifacts[name], second.artifacts[name])
    assert first.artifacts["nand_128"].shape == (64, TEST_TINY.n0 + 1)
    assert first.artifacts["pbs_uint4"].shape == (16, MP.n0 + 1)
    bad = tmp_path / "bad.npz"
    shutil.copy(golden, bad)
    arrays = dict(np.load(bad))
    arrays["mux_128"][3, 5] ^= 1
    np.savez_compressed(bad, **arrays)
    check = V.Validation("cpu", small=True, golden=str(bad))
    check.artifacts = second.artifacts
    with pytest.raises(SystemExit, match=re.escape("validation failed at: golden[mux_128]")):
        _quiet(check.golden_finalize)
    assert check.passed == ["golden[nand_128]", "golden[nand_mb_128]"]


def test_a_flipped_gate_output_bit_exits_nonzero_naming_the_gate(monkeypatch, tmp_path):
    """main --cpu --small with one gate's first output flipped (its body
    moved by half the torus): SystemExit naming that gate, before any golden
    file is touched."""
    real = V.gates.batch_gate

    def planted(name, a, b, ck):
        out = real(name, a, b, ck)
        if name == "xor":
            out = out.clone()
            out[0, -1] += -(1 << 31)
        return out

    monkeypatch.setattr(V, "SETS", TINY_SETS)
    monkeypatch.setattr(V, "GOLDEN", str(tmp_path / "never.npz"))
    monkeypatch.setattr(V.gates, "batch_gate", planted)
    with pytest.raises(SystemExit) as err:
        _quiet(V.main, ["--cpu", "--small", "--write-golden"])
    assert str(err.value) == "validation failed at: gate xor"
    assert not (tmp_path / "never.npz").exists()


def test_without_a_card_it_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the script runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        V.main(["--small"])


def test_imports_no_jax():
    """The script and the scripts/torch/ modules it imports import neither
    JAX nor the JAX package."""
    seen, todo = set(), ["tpu_validation"]
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
    assert {"tpu_validation", "soak", "measure_mb_noise"} <= seen
