"""The rotation's roofline count: PERF.md's bounds from shapes alone, and
the same value whatever route or instance a configuration names."""

from __future__ import annotations

import json

import pytest

from tfhe_bench import roofline
from tfhe_bench import reference as R

from .conftest import ROOT


def _cfg(name: str) -> dict:
    return json.loads((ROOT / "tfhe_bench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("config, batch, bound_ms", [
    ("fast_std", 4096, 72.9),   # K1 (32, 8, mma_s8x3): s8 limbs, 3 a word
    ("fast_std", 1, 0.0178),    # K1 at B=1: still the multiply-adds
    ("strict_mb", 512, 18.2),   # above the cap: the standard key, 4 limbs
    ("strict_mb", 1, 0.0205),   # K4 at B=1: bound by reading bsk_mb once
])
def test_bounds_of_perf_md(config, batch, bound_ms):
    p = R.Params.from_config(_cfg(config))
    digits = len(str(bound_ms).split(".")[1])  # as PERF.md prints it
    assert round(roofline.rotation_bound_s(p, batch) * 1e3, digits) == bound_ms


def test_work_counts():
    fast = R.Params.from_config(_cfg("fast_std"))
    strict = R.Params.from_config(_cfg("strict_mb"))
    assert roofline.key_limbs(fast) == 3 and roofline.key_limbs(strict) == 4
    nbytes, macs = roofline.rotation_work(fast, 1)
    assert macs == 700 * 4 * 2 * 1024 ** 2
    assert nbytes == 22937600 + 4 * (701 + 2048 + 2048)  # the key read once, in and out
    nbytes, macs = roofline.rotation_work(strict, 4)  # the multi-bit key at the cap
    assert macs == 4 * 350 * 6 * 2 * 1024 ** 2 and nbytes - 4 * (4 * 701 + 2048 + 4 * 2048) == 68812800
    assert roofline.rotation_work(strict, 5)[1] == 5 * 700 * 6 * 2 * 1024 ** 2


@pytest.mark.parametrize("route", [{}, {"step_impl": "fused_small_mb"}, {"step_impl": "pallas"},
                                   {"instance": [16, 8, "mma_s8x4"]}, {"kernel": "K4"}])
def test_count_ignores_route_and_instance(route):
    for name in ("fast_std", "strict_mb"):
        base = R.Params.from_config(_cfg(name))
        named = R.Params.from_config({**_cfg(name), **route})
        for batch in (1, 2, 4, 16, 512, 4096):
            assert roofline.rotation_bound_s(named, batch) == roofline.rotation_bound_s(base, batch)
