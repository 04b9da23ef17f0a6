"""Every cell of BENCHMARK.json for a 10 s window on the card, each in its
own process as the benchmark's command runs it; the result line parsed and
held to the contract's keys. Marked `gpu`: skipped where there is no card
(decided inside the test).

    python3 -m pytest tfhe_bench/tests/test_tfhe_bench_chip.py -q -n 0
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from .conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_is_correct(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cells run on the card")
    out = subprocess.run([sys.executable, "-m", "tfhe_bench.run", "--workload", cell, "--seed", str(2**31 + 17),
                          "--seconds", "10", "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert list(result)[-1] == "checks"
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert result["metrics"]
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
