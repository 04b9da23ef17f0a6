"""The plain reference against the program, on the CPU: bit for bit on both
traffic kinds and both key kinds at TEST_TINY and at one production set's
B=1; a flipped low bit in the last row is caught; neither the benchmark nor
its reference loads what it may not."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from tfhe_bench import keygen, run, traffic
from tfhe_bench import reference as R
from tfhe_bench.program import Program

from .conftest import ROOT, load

SEED = 2**31 + 12345


@pytest.mark.parametrize("config", ["tiny_std", "tiny_mb"])
@pytest.mark.parametrize("mix", ["layers_b8", "add4"])
def test_cell_on_cpu_equals_reference(config, mix):
    result, lines = run.run_cell(load(config), load(mix), SEED, 0.3, False, "cpu", [])
    assert result["correct"], lines
    assert result["checks"]["words_differ"]["value"] == 0
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("config", ["tiny_std", "tiny_mb"])
def test_gates_equal_reference_on_both_routes(config):
    """Batches on both sides of the multi-bit cap, every gate of the mixes."""
    cfg = load(config)
    p = R.Params.from_config(cfg)
    keys = keygen.make_keys(SEED, p, "cpu")
    prog = Program(cfg, keys, "cpu")
    g = keygen.generator(7, "cpu")
    for batch in (1, p.mb_route_batch_cap or 2, 5):
        bits = torch.randint(0, 2, (2, batch), generator=g).bool()
        a, b = (keygen.encrypt_bits(g, keys.lv0, x, p.alpha_lv0) for x in bits)
        for name in ("nand", "xor", "and", "or"):
            out = prog.batch_gate(name, a, b)
            assert torch.equal(out, R.gate(name, a, b, keys, p, batch)), (name, batch)
            assert torch.equal(R.decrypt(out, keys.lv0), R.PLAIN[name](bits[0], bits[1]))


def test_production_set_b1_equals_reference():
    """SECURITY_128_BIT_FAST, one NAND at B=1 (the add cells' B=1 calls):
    two plain rotations of 700 steps, about a minute on four threads."""
    torch.set_num_threads(4)
    cfg = json.loads((ROOT / "tfhe_bench" / "configs" / "fast_std.json").read_text())
    p = R.Params.from_config(cfg)
    keys = keygen.make_keys(SEED, p, "cpu")
    prog = Program(cfg, keys, "cpu")
    g = keygen.generator(8, "cpu")
    bits = torch.tensor([[True], [False]])
    a, b = (keygen.encrypt_bits(g, keys.lv0, x, p.alpha_lv0) for x in bits)
    out = prog.batch_gate("nand", a, b)
    assert torch.equal(out, R.gate("nand", a, b, keys, p, 1))
    assert R.decrypt(out, keys.lv0).tolist() == [True]


def test_layers_keep_the_first_a_drawn_and_the_last_layer():
    """The layers' loop holds three layers' inputs and outputs whatever the
    window's length, and draws the same layer for the same seed."""
    cfg, spec = load("tiny_std"), load("layers_b8")
    p = R.Params.from_config(cfg)
    keys = keygen.make_keys(SEED, p, "cpu")
    prog = Program(cfg, keys, "cpu")
    draws = []
    for _ in range(2):
        mix = traffic.make(spec, prog, keys, p, SEED, "cpu")
        window = mix.window(0.0, traced_units=12)
        assert len(window.units) == 12 and set(mix.kept) == {"first", "drawn", "last"}
        assert mix.kept["first"][0] == 0 and mix.kept["last"][0] == 11
        assert mix.kept["first"][1] is mix.x0
        draws.append(mix.kept["drawn"][0])
    assert draws[0] == draws[1]


class _FlipLastRow:
    """The program with one low bit of the last row of every gate's output
    flipped."""

    def __init__(self, cfg, keys, p, device):
        self.inner = run.default_program(cfg, keys, p, device)

    def batch_gate(self, name, a, b):
        out = self.inner.batch_gate(name, a, b).clone()
        out[-1, 0] ^= 1
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)


def test_flipped_low_bit_in_last_row_is_caught():
    result, lines = run.run_cell(load("tiny_std"), load("layers_b8"), SEED, 0.2, False, "cpu", [],
                                 make_program=_FlipLastRow)
    assert not result["correct"], lines
    # a flipped mask bit of the last row: one word differs in each compared
    # layer, and the decryption may or may not change
    assert result["checks"]["words_differ"]["value"] == len(json.loads(lines[0].split(" ", 1)[1])["layers"])


def _top_level_modules(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program_or_jax():
    names = _top_level_modules("import tfhe_bench.reference, tfhe_bench.keygen, tfhe_bench.roofline")
    assert not names & {"rs_tfhe_tpu_torch", "rs_tfhe_tpu", "jax", "jaxlib", "flax"}, names


def test_a_run_loads_no_jax_and_no_jax_package():
    """A whole run on the CPU: the top-level names compared whole, so the
    port (whose name begins with the JAX package's) is allowed."""
    code = (
        "import json, torch\n"
        "torch.set_num_threads(1)\n"
        "from tfhe_bench import run\n"
        "from tfhe_bench.tests.conftest import load\n"
        "result, _ = run.run_cell(load('tiny_mb'), load('add4'), 3, 0.1, False, 'cpu', [])\n"
        "assert result['correct']\n"
        "assert not run.forbidden_modules()\n"
    )
    names = _top_level_modules(code)
    assert "rs_tfhe_tpu_torch" in names
    assert not names & {"rs_tfhe_tpu", "jax", "jaxlib", "flax"}, names
