"""The port's reliability artifacts from the H100, as committed:
SOAK_torch_h100.json (scripts/torch/soak.py) and MB_NOISE_torch_h100.json
(scripts/torch/measure_mb_noise.py). Every soak phase must show zero
decryption errors and zero mismatches against the plain version, at the
counts the JAX package's artifact test asks of its soak
(tests/test_soak_artifact.py), on a named NVIDIA card with its power limit;
the multi-bit noise must sit where the model says, with every gate right.
The names stay apart from the JAX artifacts' SOAK_r*.json."""

import fnmatch
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SOAK = ROOT / "SOAK_torch_h100.json"
NOISE = ROOT / "MB_NOISE_torch_h100.json"
#: phase -> (count field, least count), the JAX artifact test's thresholds
THRESHOLDS = {"fast": ("gates", 1_000_000), "strict": ("gates", 1_000_000), "nibble": ("pbs", 10_000),
              "fast_mb": ("gates", 100_000)}


def _on_card(row):
    assert row["device"].startswith("NVIDIA"), row["device"]
    assert row["power_limit"], "the card's power limit is recorded"


def test_artifacts_stay_out_of_the_jax_glob():
    assert not fnmatch.fnmatch(SOAK.name, "SOAK_r*.json")
    assert not fnmatch.fnmatch(NOISE.name, "MB_NOISE_r*.json")


@pytest.mark.parametrize("phase", sorted(THRESHOLDS))
def test_soak_phase_has_no_error_and_no_mismatch(phase):
    row = json.loads(SOAK.read_text())[phase]
    field, least = THRESHOLDS[phase]
    assert row["errors"] == 0 and row["mismatches"] == 0
    assert row["spot_checks"] >= 1
    assert row[field] >= least
    if phase != "nibble":
        assert row["multibit"] == (phase == "fast_mb")
    _on_card(row)
    for chunk in row.get("chunks", []):
        assert chunk["errors"] == 0 and chunk["mismatches"] == 0
        _on_card(chunk)


def test_mb_noise_in_range_and_every_gate_right():
    art = json.loads(NOISE.read_text())
    _on_card(art)
    rows = art["rows"]
    assert {(r["params"], r["multibit"]) for r in rows} >= {
        ("SECURITY_128_BIT_FAST", True), ("SECURITY_128_BIT", True)}
    for r in rows:
        assert r["gate_errors"] == 0
        if r["multibit"]:
            assert 0.5 <= r["ratio"] <= 1.15, r
