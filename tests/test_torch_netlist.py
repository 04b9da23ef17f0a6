"""PyTorch port: `models/netlist.py` against the JAX package with tolerance 0:
the scheduler (`plan_python`: levels, order, groups), `evaluate` and
`compile_circuit` on the ripple-carry adder and on a random circuit that uses
every op, on one JAX key at TEST_TINY carried into the port."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import rs_tfhe_tpu.params as JP  # noqa: E402
from rs_tfhe_tpu import bit_utils as JBU  # noqa: E402
from rs_tfhe_tpu import tlwe as JT  # noqa: E402
from rs_tfhe_tpu.key import CloudKey as JCloudKey  # noqa: E402
from rs_tfhe_tpu.key import SecretKey as JSecretKey  # noqa: E402
from rs_tfhe_tpu.models import netlist as JN  # noqa: E402
from rs_tfhe_tpu_torch import bit_utils as PBU  # noqa: E402
from rs_tfhe_tpu_torch import key as PK  # noqa: E402
from rs_tfhe_tpu_torch import models as PM  # noqa: E402
from rs_tfhe_tpu_torch import tlwe as PT  # noqa: E402
from rs_tfhe_tpu_torch.models import netlist as PN  # noqa: E402
from rs_tfhe_tpu_torch.params import params_from  # noqa: E402
from rs_tfhe_tpu_torch.torus import to_numpy, to_torch  # noqa: E402


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


@pytest.fixture(scope="module")
def keys():
    jsk = JSecretKey.generate(jax.random.key(111), TINY)
    jck = JCloudKey.generate(jax.random.key(112), jsk)
    arrays = {"lv0": np.asarray(jsk.lv0), "lv1": np.asarray(jsk.lv1), "testvec": np.asarray(jck.testvec),
              "bsk": np.asarray(jck.bsk), "ksk_limbs": np.asarray(jck.ksk_limbs)}
    return jsk, jck, PK.secret_key_from_numpy(arrays, PTINY, "cpu"), PK.cloud_key_from_numpy(arrays, PTINY, "cpu")


def random_circuit(module, seed, n_inputs=6, n_gates=24):
    """The same random netlist in either package: every op, operands drawn
    from the wires written so far."""
    rng = np.random.default_rng(seed)
    ckt = module.Circuit(n_inputs=n_inputs)
    ops = sorted(module.OPS)
    for i in range(n_gates):
        op = ops[i % len(ops)] if i < len(ops) else ops[int(rng.integers(len(ops)))]
        arity = module.OPS[op][1]
        ins = [int(w) for w in rng.integers(0, ckt.n_wires, arity)]
        ckt.add(op, *ins)
    return ckt


def _same_plan(port, ref):
    np.testing.assert_array_equal(port.levels, ref.levels)
    np.testing.assert_array_equal(port.order, ref.order)
    assert port.groups == ref.groups
    assert port.n_levels == ref.n_levels


def test_ops_and_exports_match_jax():
    assert PN.OPS == JN.OPS
    for name in ("Circuit", "Gate", "Plan", "compile_circuit", "evaluate", "plan", "ripple_carry_adder"):
        assert hasattr(PM, name)


@pytest.mark.parametrize("width", [1, 4, 8, 32])
def test_ripple_carry_adder_and_plan_match_jax(width):
    pc, pa, pb, ps = PN.ripple_carry_adder(width)
    jc, ja, jb, js = JN.ripple_carry_adder(width)
    assert (pa, pb, ps) == (ja, jb, js)
    assert [(g.op, g.a, g.b, g.c, g.out) for g in pc.gates] == [(g.op, g.a, g.b, g.c, g.out) for g in jc.gates]
    _same_plan(PN.plan_python(pc), JN.plan_python(jc))
    _same_plan(PN.plan(pc), JN.plan_python(jc))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_python_matches_jax_on_random_circuits(seed):
    pc, jc = random_circuit(PN, seed, n_gates=60), random_circuit(JN, seed, n_gates=60)
    for p_arr, j_arr in zip(pc._arrays(), jc._arrays()):
        np.testing.assert_array_equal(p_arr, j_arr)
    _same_plan(PN.plan_python(pc), JN.plan_python(jc))


def _bad_circuits(module):
    cycle = module.Circuit(n_inputs=1)
    cycle.add("and", 0, 2, out=1)
    cycle.add("or", 1, 0, out=2)
    twice = module.Circuit(n_inputs=2)
    twice.add("and", 0, 1, out=2)
    twice.add("or", 0, 1, out=2)
    onto_input = module.Circuit(n_inputs=2)
    onto_input.add("and", 0, 1, out=1)
    unwritten = module.Circuit(n_inputs=2)
    unwritten.add("and", 0, 3, out=4)
    return {"cycle": cycle, "written_twice": twice, "onto_input": onto_input, "unwritten": unwritten}


@pytest.mark.parametrize("name", ["cycle", "written_twice", "onto_input", "unwritten"])
def test_plan_python_rejects_what_jax_rejects(name):
    with pytest.raises(ValueError) as jerr:
        JN.plan_python(_bad_circuits(JN)[name])
    with pytest.raises(ValueError) as perr:
        PN.plan_python(_bad_circuits(PN)[name])
    assert str(perr.value) == str(jerr.value)
    missing = PN.Circuit(n_inputs=2)
    missing.add("mux", 0, 1)
    with pytest.raises(ValueError, match="missing operand"):
        PN.plan_python(missing)


def test_adder_through_evaluate_and_compile_matches_jax(keys):
    jsk, jck, psk, pck = keys
    x, y, w = 11, 6, 4
    jin = jax.numpy.concatenate([
        JBU.encrypt_uint(jax.random.key(113), jsk.lv0, x, w, TINY.tlwe_lv0.alpha),
        JBU.encrypt_uint(jax.random.key(114), jsk.lv0, y, w, TINY.tlwe_lv0.alpha)])
    jc, _, _, _ = JN.ripple_carry_adder(w)
    ref = np.asarray(JN.evaluate(jc, jin, jck, JN.plan_python(jc)))
    pc, _, _, sums = PN.ripple_carry_adder(w)
    pin = to_torch(np.asarray(jin), "cpu")
    wires = PN.evaluate(pc, pin, pck)
    np.testing.assert_array_equal(to_numpy(wires), ref)
    assert PBU.decrypt_uint(wires[sums], psk.lv0) == (x + y) % 16
    run = PN.compile_circuit(pc)
    np.testing.assert_array_equal(to_numpy(run(pin, pck)), ref)
    np.testing.assert_array_equal(to_numpy(run(pin, pck)), ref)  # the cached indices serve a second run
    np.testing.assert_array_equal(to_numpy(PN.evaluate(pc, pin, pck, PN.plan_python(pc))), ref)
    with pytest.raises(ValueError, match="key on cpu"):
        run(pin.to("meta"), pck)


def test_random_circuit_through_evaluate_and_compile_matches_jax(keys):
    """Every op, NOT, COPY and MUX among them, against JAX's `evaluate` and
    against the circuit evaluated in the clear."""
    jsk, jck, psk, pck = keys
    bits = np.random.default_rng(115).integers(0, 2, 6).astype(bool)
    jin = JT.lwe_encrypt_bool(jax.random.key(116), jsk.lv0, jax.numpy.asarray(bits), TINY.tlwe_lv0.alpha)
    jc, pc = random_circuit(JN, 7), random_circuit(PN, 7)
    ref = np.asarray(JN.evaluate(jc, jin, jck, JN.plan_python(jc)))
    pin = to_torch(np.asarray(jin), "cpu")
    wires = PN.evaluate(pc, pin, pck)
    np.testing.assert_array_equal(to_numpy(wires), ref)
    np.testing.assert_array_equal(to_numpy(PN.compile_circuit(pc, PN.plan(pc))(pin, pck)), ref)
    clear = {
        "nand": lambda a, b: not (a and b), "and": lambda a, b: a and b, "or": lambda a, b: a or b,
        "nor": lambda a, b: not (a or b), "xor": lambda a, b: a != b, "xnor": lambda a, b: a == b,
        "and_ny": lambda a, b: (not a) and b, "and_yn": lambda a, b: a and not b,
        "or_ny": lambda a, b: (not a) or b, "or_yn": lambda a, b: a or not b,
        "not": lambda a: not a, "copy": lambda a: a, "mux": lambda a, b, c: b if a else c,
    }
    vals = list(bits)
    for g in pc.gates:
        ins = [vals[w] for w in (g.a, g.b, g.c) if w is not None]
        vals.append(bool(clear[g.op](*ins)))
    np.testing.assert_array_equal(PT.lwe_decrypt_bool(wires, psk.lv0).numpy(), np.array(vals))
