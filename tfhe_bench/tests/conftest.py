"""Shared set-up of the benchmark's own tests: the tiny configurations and
mixes beside this file, and one torch thread."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent


def load(name: str) -> dict:
    return json.loads((HERE / f"{name}.json").read_text())


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
