"""PyTorch port: the native C++ client (`rs_tfhe_tpu_torch.native`, the
port's own ctypes bindings and build) against the JAX package's bindings on
the same inputs, with tolerance 0; `models/netlist.plan_native` against the
JAX package's; the seeded client-server round trip; and the rule that no
module of the port, nor chip_smoke.py, imports JAX or the JAX package."""

import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from rs_tfhe_tpu import native as JNAT  # noqa: E402
from rs_tfhe_tpu.models import netlist as JN  # noqa: E402
from rs_tfhe_tpu_torch import native as PNAT  # noqa: E402
from rs_tfhe_tpu_torch import tlwe as PT  # noqa: E402
from rs_tfhe_tpu_torch import torus as PTo  # noqa: E402
from rs_tfhe_tpu_torch.models import netlist as PN  # noqa: E402
from rs_tfhe_tpu_torch.torus import to_numpy, to_torch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port: the suite runs six workers on the
    machine's cores, and torch's default of a thread a core oversubscribes
    them (the JAX side keeps its own pool)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _u32(rng, *shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint32)


def test_library_is_the_ports_own_build():
    assert PNAT.available()
    path = PNAT.library_path()
    assert path.exists() and path.is_relative_to(ROOT / "rs_tfhe_tpu_torch" / "native" / "_build")
    assert Path(PNAT.load()._name) == path


N, N0 = 64, 16
_CASES = {
    "negacyclic_polymul": lambda m, r: m.negacyclic_polymul(_u32(r, N), r.integers(-3, 4, N).astype(np.uint32)),
    "monomial_rotate": lambda m, r: m.monomial_rotate(_u32(r, N), 77),
    "lwe_encrypt": lambda m, r: m.lwe_encrypt(5, r.integers(0, 2, N0), _u32(r, 9), 1e-6),
    "lwe_phase": lambda m, r: m.lwe_phase(_u32(r, 9, N0 + 1), r.integers(0, 2, N0)),
    "lwe_decrypt_bool": lambda m, r: m.lwe_decrypt_bool(_u32(r, 9, N0 + 1), r.integers(0, 2, N0)),
    "lwe_expand_seeded": lambda m, r: m.lwe_expand_seeded(_u32(r, 2), _u32(r, 9), N0),
    "lwe_encrypt_seeded": lambda m, r: m.lwe_encrypt_seeded(_u32(r, 2), 6, r.integers(0, 2, N0), _u32(r, 9), 1e-6),
    "lwe_encrypt_message": lambda m, r: m.lwe_encrypt_message(7, r.integers(0, 2, N0), r.integers(0, 8, 9), 8, 1e-6),
    "lwe_decrypt_message": lambda m, r: m.lwe_decrypt_message(_u32(r, 9, N0 + 1), r.integers(0, 2, N0), 8),
    "trlwe_encrypt": lambda m, r: m.trlwe_encrypt(8, r.integers(0, 2, N), _u32(r, 3, N), 1e-9),
    "trlwe_phase": lambda m, r: m.trlwe_phase(_u32(r, 3, 2, N), r.integers(0, 2, N)),
    "trlwe_sample_extract": lambda m, r: m.trlwe_sample_extract(_u32(r, 2, N), 5),
    "gadget_decompose": lambda m, r: m.gadget_decompose(_u32(r, 2, N), 3, 6, 0x8208000),
    "identity_key_switch": lambda m, r: m.identity_key_switch(_u32(r, N + 1), _u32(r, N, 4, 4, N0 + 1), N0, 4, 2),
}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_native_client_matches_jax_bindings(name):
    case = _CASES[name]
    np.testing.assert_array_equal(case(PNAT, np.random.default_rng(1)), case(JNAT, np.random.default_rng(1)))


def test_native_bindings_validate_shapes():
    with pytest.raises(ValueError, match="last axis"):
        PNAT.lwe_phase(np.zeros((2, 5), np.uint32), np.zeros(8, np.uint32))
    with pytest.raises(ValueError, match="ksk"):
        PNAT.identity_key_switch(np.zeros(N + 1, np.uint32), np.zeros((N, 4, 4, N0), np.uint32), N0, 4, 2)


def test_native_seeded_client_round_trip():
    """The native client encrypts seeded; the server expands with the port;
    the client decrypts the expanded batch."""
    rng = np.random.default_rng(2)
    s = rng.integers(0, 2, N0).astype(np.uint32)
    bits = rng.integers(0, 2, 40).astype(bool)
    mu = np.where(bits, np.uint32(1 << 29), np.uint32(2**32 - (1 << 29)))
    seed = to_numpy(PTo.key_data(31))
    bodies = PNAT.lwe_encrypt_seeded(seed, 32, s, mu, 1e-9)
    ct = PT.lwe_expand_seeded(seed, to_torch(bodies, "cpu"), N0)
    np.testing.assert_array_equal(to_numpy(ct), PNAT.lwe_expand_seeded(seed, bodies, N0))
    np.testing.assert_array_equal(PNAT.lwe_decrypt_bool(to_numpy(ct), s), bits)
    np.testing.assert_array_equal(PT.lwe_decrypt_bool(ct, to_torch(s, "cpu")).numpy(), bits)


def _random_circuit(module, seed, n_inputs=6, n_gates=40):
    rng = np.random.default_rng(seed)
    ckt = module.Circuit(n_inputs=n_inputs)
    ops = sorted(module.OPS)
    for i in range(n_gates):
        op = ops[i % len(ops)] if i < len(ops) else ops[int(rng.integers(len(ops)))]
        ckt.add(op, *(int(w) for w in rng.integers(0, ckt.n_wires, module.OPS[op][1])))
    return ckt


def _same_plan(port, ref):
    np.testing.assert_array_equal(port.levels, ref.levels)
    np.testing.assert_array_equal(port.order, ref.order)
    assert port.groups == ref.groups and port.n_levels == ref.n_levels


@pytest.mark.parametrize("circuit", ["adder8"] + [f"random{s}" for s in range(7)])
def test_plan_native_matches_jax(circuit):
    if circuit == "adder8":
        pc, jc = PN.ripple_carry_adder(8)[0], JN.ripple_carry_adder(8)[0]
    else:
        seed = int(circuit[len("random"):])
        pc, jc = _random_circuit(PN, seed), _random_circuit(JN, seed)
    _same_plan(PN.plan_native(pc), JN.plan_native(jc))
    _same_plan(PN.plan_native(pc), PN.plan_python(pc))


def test_plan_takes_the_native_planner(monkeypatch):
    calls = []
    monkeypatch.setattr(PN, "plan_native", lambda c: calls.append(c) or PN.plan_python(c))
    pc = PN.ripple_carry_adder(4)[0]
    PN.plan(pc)
    assert calls == [pc]
    monkeypatch.setattr(PNAT, "available", lambda: False)
    PN.plan(pc)
    assert calls == [pc]


def test_plan_native_rejects_what_jax_rejects():
    for module in (PN, JN):
        cycle = module.Circuit(n_inputs=1)
        cycle.add("and", 0, 2, out=1)
        cycle.add("or", 1, 0, out=2)
        with pytest.raises(ValueError, match="circuit_plan failed"):
            module.plan_native(cycle)


def _imported_modules(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value))
    return names


def test_the_port_never_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "rs_tfhe_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    for path in files:
        bad = {m for m in _imported_modules(path)
               if m.split(".")[0] in ("jax", "jaxlib", "rs_tfhe_tpu", "flax")}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
