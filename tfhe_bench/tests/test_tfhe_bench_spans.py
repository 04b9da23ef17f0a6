"""The `program_span` readers (spans.py) on traced runs of the TEST_TINY
program on the CPU, driven as the benchmark drives a cell.

The CPU has no device activity, so each leaf ATen op of the trace stands in
for a kernel it launched, on the op's own interval: named as the rotation
kernels are named (`kernels.json`) where it runs inside a `tfhe.rotate.*`
span, after the op elsewhere. The readers that find kernels by name
(`device_trace`) and those that find them by span (`program_span`) then see
the same rotation work, and must read the same."""

from __future__ import annotations

import json
import math
import types

import pytest
import torch

from tfhe_bench import run
from tfhe_bench.trace import Trace

from .conftest import ROOT, load

SEED = 2**31 + 2020
CUDA = torch.autograd.DeviceType.CUDA
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
PER_LAYER = {m["name"]: m for m in MANIFEST["per_layer"]}
SPAN_METRICS = [m["name"] for m in MANIFEST["per_layer"] if m["source"] == "program_span"]
ADD = ["netlist.enqueue_ms", "rotation.roofline.add", "keyswitch.device_ms.add", "device.idle_share.add",
       "rotation.span_roofline.add", "keyswitch.span_device_ms.add", "gate.host_ms.add",
       "device.idle_in_program.add"]
LAYERS = ["rotation.roofline.layers", "device.idle_share.layers", "rotation.span_roofline.layers"]


def _in_rotation(ev) -> bool:
    parent = ev.cpu_parent
    while parent is not None:
        if parent.name.startswith("tfhe.rotate."):
            return True
        parent = parent.cpu_parent
    return False


class StandIn(Trace):
    """A CPU trace whose leaf ATen ops stand in for the device activity
    they would launch."""

    def __init__(self, events):
        events = list(events)
        device = []
        for ev in events:
            if ev.device_type != CUDA and ev.name.startswith("aten::") and not ev.cpu_children:
                name = "blind_rotate_stand_in_kernel" if _in_rotation(ev) else "stand_in_" + ev.name[6:]
                ev.append_kernel(name, 0, ev.time_range.end - ev.time_range.start)
                device.append(types.SimpleNamespace(name=name, device_type=CUDA, time_range=ev.time_range,
                                                    is_user_annotation=False))
        super().__init__(events + device)

    def breakdown(self, top: int = 10) -> dict:
        """Not read here: naming each gap between the stand-ins walks back
        over a whole request's ops, minutes at this many gaps."""
        return {}


def _traced(monkeypatch, config: str, mix: str, names: list[str]) -> dict:
    monkeypatch.setattr(run, "Trace", StandIn)
    result, lines = run.run_cell(load(config), load(mix), SEED, 0.2, True, "cpu", [PER_LAYER[n] for n in names])
    assert result["correct"], lines
    return {k: v["value"] for k, v in result["metrics"].items()}


def test_every_span_metric_has_a_reader_and_a_cell():
    assert set(SPAN_METRICS) == {"rotation.span_roofline.layers", "rotation.span_roofline.add",
                                 "keyswitch.span_device_ms.add", "gate.host_ms.add", "device.idle_in_program.add"}
    for name in SPAN_METRICS:
        assert callable(run.metric_reader(name)) and PER_LAYER[name]["workloads"]


@pytest.mark.parametrize("config", ["tiny_std", "tiny_mb"])
def test_add_readers_read_the_spans(monkeypatch, config):
    got = _traced(monkeypatch, config, "add4", ADD)
    assert set(got) == set(ADD), got
    assert all(math.isfinite(v) and v > 0 for v in got.values()), got
    assert math.isclose(got["rotation.span_roofline.add"], got["rotation.roofline.add"], rel_tol=1e-9)
    # the key switch's product and the rest of its ops
    assert got["keyswitch.span_device_ms.add"] > got["keyswitch.device_ms.add"]
    assert got["gate.host_ms.add"] <= got["netlist.enqueue_ms"]
    assert got["device.idle_in_program.add"] <= got["device.idle_share.add"]


@pytest.mark.parametrize("config", ["tiny_std", "tiny_mb"])
def test_layers_reader_reads_the_spans(monkeypatch, config):
    got = _traced(monkeypatch, config, "layers_b8", LAYERS)
    assert set(got) == set(LAYERS), got
    assert math.isclose(got["rotation.span_roofline.layers"], got["rotation.roofline.layers"], rel_tol=1e-9)


def test_a_program_without_spans_reads_nothing(monkeypatch):
    """A program that opens no span (as before the spans were added): the
    span readers return None, the harness leaves their metrics out, and
    the rest still read."""
    from rs_tfhe_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: False)
    got = _traced(monkeypatch, "tiny_mb", "add4", ADD)
    assert not set(got) & set(SPAN_METRICS)
    assert {"netlist.enqueue_ms", "keyswitch.device_ms.add", "device.idle_share.add"} <= set(got)
