"""BENCHMARK.json against the benchmark's contract: names, units and text
fields within their character sets and lengths; every per-layer metric
moves an end-to-end metric that each of its cells reports; every
configuration has a cell; every cell's files are found by name; the
configuration files hold the program's parameter sets."""

from __future__ import annotations

import json
import math
import re

import pytest

from tfhe_bench import run

from .conftest import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = MANIFEST["workloads"]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def _text(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(MANIFEST["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in MANIFEST["paths"])
    assert 1 <= len(MANIFEST["command"]) <= 32 and all(_text(w) for w in MANIFEST["command"])
    assert not any(w.startswith("/") or ".." in w for w in MANIFEST["command"])
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert 1 <= len(MANIFEST["configs"]) <= 24 and 1 <= len(CELLS) <= 24
    assert 1 <= len(MANIFEST["end_to_end"]) <= 16 and 1 <= len(MANIFEST["per_layer"]) <= 128


def test_a_full_check_of_24_cells_fits():
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_text():
    for group in (MANIFEST["configs"], CELLS, METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _text(c["source"]) and _text(c["why"]) and len(c["reduced"]) <= 16
    for w in CELLS:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert _text(w["why"]) and w["chips"] in (1, 4) and NAME.match(w["traffic"])
    assert len({(w["config"], w["traffic"]) for w in CELLS}) == len(CELLS)
    assert sum(w["chips"] == 4 for w in CELLS) <= max(1, len(CELLS) // 4)


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25, m
    for w in CELLS:
        reported = [m for m in e2e.values() if "workloads" not in m or w["name"] in m["workloads"]]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2, w["name"]


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in CELLS}
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _text(m["layer"]) and m["moves"] in e2e
        target = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert "workloads" not in target or cell in target["workloads"], (m["name"], cell)
        if "roofline" in m["name"] or "idle_share" in m["name"]:
            assert m["unit"] == "%"
    for w in CELLS:
        assert any("workloads" not in m or w["name"] in m["workloads"] for m in MANIFEST["per_layer"]), w["name"]


def test_every_configuration_has_a_cell_and_its_files():
    used = {w["config"] for w in CELLS}
    paths = tuple(MANIFEST["paths"])
    files = set()
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(paths) and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    for w in CELLS:
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        spec = json.loads((run.BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert NAME.match(spec["kind"]) and (run.BENCH / "kinds" / f"{spec['kind']}.py").is_file(), spec["kind"]
    for m in METRICS:
        assert callable(run.metric_reader(m["name"])), m["name"]


@pytest.mark.parametrize("config", [c["name"] for c in MANIFEST["configs"]])
def test_configuration_files_hold_the_program_parameter_sets(config):
    """The numbers of each file against the program's set of that name; the
    key sizes against the shapes."""
    import rs_tfhe_tpu_torch.params as tp

    from tfhe_bench.program import _FIELDS

    cfg = json.loads((ROOT / "tfhe_bench" / "configs" / f"{config}.json").read_text())
    params = getattr(tp, cfg["params"])
    assert {k: f(params) for k, f in _FIELDS.items()} == {k: cfg[k] for k in _FIELDS}
    n0, n, l = cfg["n0"], cfg["n1"], cfg["l"]
    sizes = {"bsk": 4 * n0 * 2 * l * 2 * n, "ksk_rows": 4 * n * cfg["iks_t"] * 2 ** cfg["basebit"] * (n0 + 1)}
    if cfg["multibit"]:
        sizes["bsk_mb"] = 4 * (n0 // 2) * 4 * 2 * l * 2 * n
    assert cfg["key_bytes"] == sizes
    assert math.isclose(cfg["alpha_lv0"], params.tlwe_lv0.alpha)
