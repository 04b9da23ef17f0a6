"""The port's measurement artifacts from the H100, as committed:
BENCH_torch_h100.json (scripts/torch/bench.py), BENCH_SUITE_torch_h100.json
(bench_suite.py), LATENCY_SWEEP_torch_h100.json (bench_latency_sweep.py) and
SCALING_torch_h100.json (bench_multichip.py). Each names an NVIDIA card and
its power limit and shows correctness 1.0 throughout; the bench line has the
JAX bench's fields, the suite the JAX suite's 38 metrics, the sweep a row
for every port route at every batch it ran (each on its route's kernel), and
the scaling rows of a one-card mesh are marked virtual. The names stay apart
from the JAX artifacts' (BENCH_r*, BENCH_SUITE.json, LATENCY_SWEEP_r*,
SCALING_r*)."""

import fnmatch
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "BENCH_torch_h100.json"
SUITE = ROOT / "BENCH_SUITE_torch_h100.json"
SWEEP = ROOT / "LATENCY_SWEEP_torch_h100.json"
SCALING = ROOT / "SCALING_torch_h100.json"
ARTIFACTS = [BENCH, SUITE, SWEEP, SCALING]
JAX_GLOBS = ("BENCH_r*", "SCALING_r*", "LATENCY_SWEEP_r*", "BENCH_SUITE.json")
ROUTES = ["auto", "auto_mb", "fused_small_mb", "pallas", "xla"]
#: the multi-bit route's batch cap at each swept set (ops.blind_rotate.mb_route_batch_cap)
MB_CAP = {"SECURITY_128_BIT_FAST": 2, "SECURITY_128_BIT": 4}


def _on_card(row):
    assert row["device"].startswith("NVIDIA"), row["device"]
    assert row["power_limit"], "the card's power limit is recorded"


@pytest.mark.parametrize("path", ARTIFACTS, ids=lambda p: p.name)
def test_artifact_stays_out_of_the_jax_globs(path):
    assert not any(fnmatch.fnmatch(path.name, g) for g in JAX_GLOBS)


@pytest.mark.parametrize("path", ARTIFACTS, ids=lambda p: p.name)
def test_artifact_names_the_card(path):
    art = json.loads(path.read_text())
    _on_card(art)
    for row in art.get("metrics", []) + art.get("rows", []):
        _on_card(row)


def test_bench_line_has_the_jax_fields_and_every_gate_right():
    art = json.loads(BENCH.read_text())
    parsed = json.loads((ROOT / "BENCH_r05.json").read_text())["parsed"]
    assert set(art["line"]) == set(parsed)
    assert art["batch"] == 4096 and art["iters"] == 5
    for pname, res in art["passes"].items():
        assert res["correctness"] == 1.0 and "mb_correct" not in res, pname
        assert set(res["kernels"]["batch"]) == {"K1 blind_rotate"}
        assert set(res["kernels"]["b1_mb"]) == {"K4 blind_rotate_mb"}


def test_suite_has_the_38_metrics():
    art = json.loads(SUITE.read_text())
    jax = json.loads((ROOT / "BENCH_SUITE.json").read_text())["metrics"]
    assert [(m["name"], m["unit"]) for m in art["metrics"]] == [(m["name"], m["unit"]) for m in jax]
    assert all(m["value"] > 0 for m in art["metrics"])
    assert art["latency_vs_batch"] == json.loads(SWEEP.read_text())["rows"]


def test_sweep_covers_every_route_at_every_batch():
    rows = json.loads(SWEEP.read_text())["rows"]
    for pname in MB_CAP:
        batches = sorted({r["batch"] for r in rows if r["params"] == pname})
        assert batches, pname
        got = {(r["batch"], r["impl"]) for r in rows if r["params"] == pname}
        assert got == {(b, i) for b in batches for i in ROUTES}, pname
    for r in rows:
        assert r["correctness"] == 1.0, r
        mb = r["impl"] == "fused_small_mb" or (r["impl"] == "auto_mb" and r["batch"] <= MB_CAP[r["params"]])
        if r["impl"] == "xla":
            assert r["kernels"] == "plain", r
            continue
        kernel = "K5 external_product" if r["impl"] == "pallas" else "K4 blind_rotate_mb" if mb else "K1 blind_rotate"
        assert set(r["kernels"]) == {kernel}, r


def test_scaling_rows_are_virtual_and_right():
    art = json.loads(SCALING.read_text())
    assert set(json.loads((ROOT / "SCALING_r05.json").read_text())) <= art.keys()
    assert art["platform"] == "gpu" and art["devices_available"] == 1 and art["virtual"] is True
    for row in art["dp_strong_scaling"] + art["dp_weak_scaling"]:
        assert row["virtual"] and row["correctness"] == 1.0, row
    for row in art["tp_vs_dp_latency"]:
        assert row["virtual"] and row["dp_correctness"] == 1.0 and row["tp_correctness"] == 1.0, row
