"""PyTorch port: the program's spans and counters (`utils/profiling.span`,
`utils/profiling.counters`) at TEST_TINY on the CPU, with a standard and a
multi-bit cloud key: the spans' nesting under `torch.profiler`, that no span
opens a profiler range when nothing traces, and each counter where its
event happens."""

import ast
import collections
import json
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import rs_tfhe_tpu_torch as pt  # noqa: E402
from rs_tfhe_tpu_torch import bit_utils, bootstrap, gates, key, tlwe  # noqa: E402
from rs_tfhe_tpu_torch.models import netlist  # noqa: E402
from rs_tfhe_tpu_torch.ops import blind_rotate, cuda_blind_rotate, cuda_blind_rotate_mb, cuda_probes, cuda_step  # noqa: E402
from rs_tfhe_tpu_torch.ops import cuda_keyswitch  # noqa: E402
from rs_tfhe_tpu_torch.ops import nussbaumer  # noqa: E402
from rs_tfhe_tpu_torch.utils import profiling  # noqa: E402

P = pt.TEST_TINY
KINDS = ["standard", "multi-bit"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def keys():
    g = torch.Generator().manual_seed(2020)
    sk = key.SecretKey.generate(P, g)
    return sk, {"standard": key.CloudKey.generate(sk, g), "multi-bit": key.CloudKey.generate(sk, g, multibit=True)}


def _adder_inputs(sk, seed=7):
    g = torch.Generator().manual_seed(seed)
    x = bit_utils.encrypt_uint(g, sk.lv0, 2, 2, P.tlwe_lv0.alpha)
    y = bit_utils.encrypt_uint(g, sk.lv0, 3, 2, P.tlwe_lv0.alpha)
    return torch.cat([x, y])


def _bits(sk, values, seed):
    g = torch.Generator().manual_seed(seed)
    return tlwe.lwe_encrypt_bool(g, sk.lv0, values, P.tlwe_lv0.alpha)


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, list(prof.events())


def _span_parent(ev):
    """The nearest enclosing `tfhe.` span of a profiler event, or None."""
    parent = ev.cpu_parent
    while parent is not None and not parent.name.startswith("tfhe."):
        parent = parent.cpu_parent
    return parent


@pytest.mark.parametrize("kind", KINDS)
def test_compiled_adder_spans_nest_by_layer(keys, kind):
    """tfhe.netlist.run > tfhe.netlist.group > tfhe.gate > {tfhe.rotate.<route>,
    tfhe.extract, tfhe.keyswitch}: one run, one group span a plan group, one
    gate and one rotation a bootstrapped group; the traced run's outputs
    are the untraced run's."""
    sk, cks = keys
    ck = cks[kind]
    ckt, _, _, sums = netlist.ripple_carry_adder(2)
    the_plan = netlist.plan(ckt)
    boot = sum(op not in ("not", "copy") for _s, _e, op, _lv in the_plan.groups)
    run = netlist.compile_circuit(ckt, the_plan)
    inputs = _adder_inputs(sk)
    plain = run(inputs, ck)
    traced, events = _profiled(lambda: run(inputs, ck))
    assert torch.equal(traced, plain)
    assert bit_utils.decrypt_uint(traced[sums], sk.lv0) == (2 + 3) % 4
    route = "tfhe.rotate.plain_mb" if kind == "multi-bit" else "tfhe.rotate.plain"
    spans = [e for e in events if e.name.startswith("tfhe.")]
    assert collections.Counter(e.name for e in spans) == {
        "tfhe.netlist.run": 1, "tfhe.netlist.group": len(the_plan.groups), "tfhe.gate": boot,
        route: boot, "tfhe.extract": boot, "tfhe.keyswitch": boot}
    outer = {"tfhe.netlist.run": None, "tfhe.netlist.group": "tfhe.netlist.run", "tfhe.gate": "tfhe.netlist.group",
             route: "tfhe.gate", "tfhe.extract": "tfhe.gate", "tfhe.keyswitch": "tfhe.gate"}
    for ev in spans:
        parent = _span_parent(ev)
        assert (parent.name if parent is not None else None) == outer[ev.name], ev.name
    # each bootstrapped group holds exactly one rotation
    per_group = collections.Counter(id(_span_parent(_span_parent(e))) for e in spans if e.name == route)
    assert len(per_group) == boot and set(per_group.values()) == {1}


@pytest.mark.parametrize("kind", KINDS)
def test_every_op_of_a_compiled_run_lies_in_a_span(keys, kind):
    sk, cks = keys
    run = netlist.compile_circuit(netlist.ripple_carry_adder(2)[0])
    inputs = _adder_inputs(sk, seed=8)
    run(inputs, cks[kind])
    _, events = _profiled(lambda: run(inputs, cks[kind]))
    ops = [e for e in events if e.name.startswith("aten::")]
    assert ops
    assert [e.name for e in ops if _span_parent(e) is None] == []


def _raise(*args, **kwargs):
    raise AssertionError("a profiler range was opened with no profiler running")


@pytest.mark.parametrize("kind", KINDS)
def test_spans_open_no_profiler_range_when_nothing_traces(keys, kind, monkeypatch):
    """The same bits from a gate, a MUX, a LUT bootstrap and a compiled run
    with every way of opening a profiler range made to raise."""
    sk, cks = keys
    ck = cks[kind]
    a, b, c = (_bits(sk, [True, False, True, False], s) for s in (11, 12, 13))
    m = tlwe.lwe_encrypt_message(torch.Generator().manual_seed(14), sk.lv0, [0, 1, 2, 3], 4, P.tlwe_lv0.alpha)
    run = netlist.compile_circuit(netlist.ripple_carry_adder(2)[0])
    inputs = _adder_inputs(sk, seed=9)

    def outputs():
        return (gates.batch_gate("nand", a, b, ck), gates.mux(a, b, c, ck),
                bootstrap.LutBootstrap().bootstrap_func(m, _increment, 4, ck), run(inputs, ck))

    want = outputs()
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _raise)
    with pytest.raises(AssertionError, match="no profiler running"):
        torch._C._profiler._RecordFunctionFast("tfhe.x")
    got = outputs()
    assert all(torch.equal(w, g) for w, g in zip(want, got))
    assert tlwe.lwe_decrypt_message(got[2], sk.lv0, 4).tolist() == [1, 2, 3, 0]


def _increment(v):
    return (v + 1) % 4


@pytest.mark.parametrize("extra", [0, 1])
def test_route_counters_at_the_multi_bit_cap(keys, extra):
    """A multi-bit key's batch of `mb_route_batch_cap` ciphertexts takes the
    multi-bit rotation, one more the standard one; each call counts once
    under its route with its ciphertexts, and its span carries the route.
    The key switch counts once under its route (a CPU tensor's: the
    product)."""
    sk, cks = keys
    batch = blind_rotate.mb_route_batch_cap(P) + extra
    route = "plain" if extra else "plain_mb"
    a = _bits(sk, [True] * batch, 21)
    b = _bits(sk, [False] * batch, 22)
    before = profiling.counters()
    _, events = _profiled(lambda: gates.batch_gate("and", a, b, cks["multi-bit"]))
    moved = {k: v - before.get(k, 0) for k, v in profiling.counters().items() if v != before.get(k, 0)}
    assert moved == {f"rotate.route.{route}.calls": 1, f"rotate.route.{route}.ciphertexts": batch,
                     "keyswitch.route.product.calls": 1, "keyswitch.route.product.ciphertexts": batch}
    assert [e.name for e in events if e.name.startswith("tfhe.rotate.")] == [f"tfhe.rotate.{route}"]


def test_compiled_plan_is_placed_once(keys):
    sk, cks = keys
    ck = cks["standard"]
    ckt = netlist.ripple_carry_adder(2)[0]
    run = netlist.compile_circuit(ckt)
    inputs = _adder_inputs(sk, seed=10)
    before = profiling.counters()["netlist.index_placements"]
    first = run(inputs, ck)
    assert torch.equal(run(inputs, ck), first)
    assert profiling.counters()["netlist.index_placements"] - before == 1
    netlist.evaluate(ckt, inputs, ck)  # places its indices on every call, uncounted
    assert profiling.counters()["netlist.index_placements"] - before == 1


def test_grid_check_reads_a_key_once():
    """`key_limbs` under a set whose key lies on the 2^8 grid reads a key
    tensor once; an edit in place reads it again; a set off the grid never
    reads it."""
    fast = pt.SECURITY_128_BIT_FAST
    assert fast.bsk_round_bits == 8 and P.bsk_round_bits < 8
    bsk = torch.arange(64, dtype=torch.int32).reshape(4, 16) << 8
    before = profiling.counters()["bsk.grid_checks"]
    assert cuda_blind_rotate.key_limbs(bsk, fast) == 3
    assert cuda_blind_rotate.key_limbs(bsk, fast) == 3
    assert profiling.counters()["bsk.grid_checks"] - before == 1
    bsk[0, 0] += 1
    assert cuda_blind_rotate.key_limbs(bsk, fast) == 4
    assert cuda_blind_rotate.key_limbs(bsk, P) == 4
    assert profiling.counters()["bsk.grid_checks"] - before == 2


def test_lut_table_is_built_once(keys):
    sk, cks = keys
    m = tlwe.lwe_encrypt_message(torch.Generator().manual_seed(41), sk.lv0, [3, 2, 1, 0], 4, P.tlwe_lv0.alpha)
    lut = bootstrap.LutBootstrap()
    before = profiling.counters()["lut.tables_built"]
    first = lut.bootstrap_func(m, _increment, 4, cks["standard"])
    second = lut.bootstrap_func(m, _increment, 4, cks["standard"])
    assert torch.equal(first, second)
    assert tlwe.lwe_decrypt_message(first, sk.lv0, 4).tolist() == [0, 3, 2, 1]
    assert profiling.counters()["lut.tables_built"] - before == 1


def test_counters_hold_the_launch_counters(monkeypatch):
    """Every launch counter the kernels' wrappers keep in the store, under
    its name in the one snapshot; a kernel's launches are the sum of its
    instances'."""
    fills = {
        "k1.instance": {(1024, 1, 16, "mma_fold_s8x3"): 3, (1024, 32, 8, "mma_s8x3"): 2},
        "k4.instance": {(1024, 1, 16, "mma_fold_s8x4"): 4},
        "k5.instance": {(1024, "mma_s8", 8, 1, 4): 7},
        "ks.instance": {(1,): 2, (16,): 1},
        "probes.launches": {"nussbaumer_dot": 16, "roll": 1},
        "probes.roll_add.instance": {32: 2},
        "nussbaumer.shape": {(8, 512, 1024): 16},
    }
    for prefix, counts in fills.items():
        store = profiling.counter(prefix)
        for k in list(store):
            monkeypatch.delitem(store, k)
        for k, n in counts.items():
            monkeypatch.setitem(store, k, n)
    assert profiling.counter("k1.instance") is cuda_blind_rotate.launched_tiles
    assert profiling.counter("k4.instance") is cuda_blind_rotate_mb.launched_tiles
    assert profiling.counter("k5.instance") is cuda_step.launched_tiles
    assert profiling.counter("ks.instance") is cuda_keyswitch.launched_tiles
    assert profiling.counter("probes.launches") is cuda_probes.launches
    assert profiling.counter("probes.roll_add.instance") is cuda_probes.roll_add_launches
    assert profiling.counter("nussbaumer.shape") is nussbaumer.launched_shapes
    got = profiling.counters()
    assert {k: v for k, v in got.items() if k.split(".")[0] in ("k1", "k4", "k5", "ks", "probes", "nussbaumer")} == {
        "k1.launches": 5, "k1.instance.1024/1/16/mma_fold_s8x3": 3, "k1.instance.1024/32/8/mma_s8x3": 2,
        "k4.launches": 4, "k4.instance.1024/1/16/mma_fold_s8x4": 4,
        "k5.launches": 7, "k5.instance.1024/mma_s8/8/1/4": 7,
        "ks.launches": 3, "ks.instance.1": 2, "ks.instance.16": 1,
        "probes.launches.nussbaumer_dot": 16, "probes.launches.roll": 1, "probes.roll_add.instance.32": 2,
        "nussbaumer.shape.8/512/1024": 16}
    assert {"bsk.grid_checks", "netlist.index_placements", "build.nvcc", "lut.tables_built"} <= set(got)
    assert all(isinstance(v, int) for v in got.values())


#: The snapshot's names right after `import rs_tfhe_tpu_torch`: every
#: counter a module seeds at import.
_KEYS_AT_IMPORT = [
    "bsk.grid_checks", "bsk.strip_builds", "build.nvcc", "k1.launches", "k4.launches", "k5.launches",
    "keyswitch.route.product.calls", "keyswitch.route.product.ciphertexts", "keyswitch.route.select.calls",
    "keyswitch.route.select.ciphertexts", "ks.launches", "lut.tables_built", "netlist.index_placements",
    "pbs.calls", "pbs.ciphertexts", "pbs.per_row_luts", "radix.mul.column_calls", "radix.mul.norm_rounds",
    "radix.ops.add", "radix.ops.compare", "radix.ops.mul",
    "radix.ops.sub", "rotate.route.k1.calls", "rotate.route.k1.ciphertexts", "rotate.route.k4.calls",
    "rotate.route.k4.ciphertexts", "rotate.route.nussbaumer.calls", "rotate.route.nussbaumer.ciphertexts",
    "rotate.route.plain.calls", "rotate.route.plain.ciphertexts", "rotate.route.plain_mb.calls",
    "rotate.route.plain_mb.ciphertexts", "rotate.route.step.calls", "rotate.route.step.ciphertexts",
]


def _package_imports(path: pathlib.Path) -> set:
    """The modules of rs_tfhe_tpu_torch that the file at `path` imports,
    inside functions too, as dotted names below the package ("<package>"
    for the package itself); an imported name counts as its module."""
    here = path.relative_to(pathlib.Path(pt.__file__).parent).parent.parts
    found = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level:
                base = ".".join(("rs_tfhe_tpu_torch", *here[: len(here) - node.level + 1]))
                mod = f"{base}.{mod}" if mod else base
            names = [mod, *(f"{mod}.{a.name}" for a in node.names)]
        else:
            continue
        found |= {n.partition(".")[2] or "<package>" for n in names if n.split(".")[0] == "rs_tfhe_tpu_torch"}
    return found


@pytest.mark.parametrize("case", ["layering", "keys_at_import"])
def test_counter_store_layering(case):
    """`utils/profiling`, which holds the counter store, imports no module of
    the package, and no kernel wrapper (`ops/cuda_*.py`) imports another:
    each imports `ops/cuda_launch`. And the snapshot right after the
    package's import (a fresh process) has exactly `_KEYS_AT_IMPORT`, each
    at 0."""
    if case == "layering":
        pkg = pathlib.Path(pt.__file__).parent
        assert _package_imports(pkg / "utils" / "profiling.py") == set()
        wrappers = {p.stem for p in (pkg / "ops").glob("cuda_*.py")} - {"cuda_launch"}
        assert {"cuda_blind_rotate", "cuda_blind_rotate_mb", "cuda_step", "cuda_keyswitch", "cuda_probes"} <= wrappers
        for w in sorted(wrappers):
            imported = _package_imports(pkg / "ops" / f"{w}.py")
            assert not {f"ops.{o}" for o in wrappers} & imported, w
            assert any(m.startswith("ops.cuda_launch") for m in imported), w
        return
    code = ("import json, rs_tfhe_tpu_torch\nfrom rs_tfhe_tpu_torch.utils import profiling\n"
            "print(json.dumps(profiling.counters()))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, timeout=300,
                         cwd=pathlib.Path(pt.__file__).parent.parent)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert sorted(got) == _KEYS_AT_IMPORT
    assert set(got.values()) == {0}
