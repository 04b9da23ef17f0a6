"""The check that decides `correct` fails what it has to: the control (the
reference in float32 in the program's place) and each fault the cells can
have, planted under the timed path while the rest of a run is driven as the
benchmark drives it (on the CPU, at TEST_TINY)."""

from __future__ import annotations

import pytest
import torch

from tfhe_bench import run
from tfhe_bench.control import control_program

from .conftest import load

SEED = 2**31 + 4242
CELLS = [("tiny_std", "layers_b8"), ("tiny_mb", "layers_b8"), ("tiny_std", "add4"), ("tiny_mb", "add4")]


def _run(config, mix, **kw):
    result, lines = run.run_cell(load(config), load(mix), SEED, 0.2, False, "cpu", [], **kw)
    return result, lines


@pytest.mark.parametrize("config, mix", CELLS)
def test_control_is_not_correct(config, mix):
    result, lines = _run(config, mix, make_program=control_program)
    assert not result["correct"], lines
    assert result["checks"]["words_differ"]["value"] > 0


def _unchanged_state(monkeypatch):
    """Every rotation returns its starting accumulator X^b * testvec: each
    step leaves the state as it was."""
    from rs_tfhe_tpu_torch import bootstrap
    from rs_tfhe_tpu_torch.ops import blind_rotate as br
    from rs_tfhe_tpu_torch.ops.poly import monomial_rotate

    def no_steps(ct, testvec, bsk, params, bsk_mb=None):
        b_til, _ = br.rotation_exponents(ct, params)
        return monomial_rotate(testvec.expand(ct.shape[0], 2, params.n1), b_til.unsqueeze(-1))

    monkeypatch.setattr(bootstrap, "blind_rotate", no_steps)


def _half_batch(monkeypatch):
    """Every bootstrap computes the first half of its batch and leaves the
    rest zero."""
    from rs_tfhe_tpu_torch import bootstrap, gates

    orig = bootstrap.bootstrap

    def half(ct, ck):
        out = torch.zeros_like(ct)
        keep = ct.shape[0] // 2
        if keep:
            out[:keep] = orig(ct[:keep], ck)
        return out

    monkeypatch.setattr(gates.bs, "bootstrap", half)


def _altered_answer(monkeypatch):
    """Every gate's answer has its last row's body moved by one, where the
    gate produces it."""
    from rs_tfhe_tpu_torch import gates

    orig = gates.batch_gate

    def altered(name, a, b, ck):
        out = orig(name, a, b, ck).clone()
        out[-1, -1] += 1
        return out

    monkeypatch.setattr(gates, "batch_gate", altered)


@pytest.mark.parametrize("config, mix", CELLS)
@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch, _altered_answer])
def test_fault_under_the_timed_path_is_not_correct(monkeypatch, fault, config, mix):
    fault(monkeypatch)
    result, lines = _run(config, mix)
    assert not result["correct"], (fault.__name__, lines)
    assert result["failed"] >= 1
