"""The general traffic generator: a traffic file's `kind` names the closed
loop that reads it, `kinds/<kind>.py`, found by name as a metric's reader
is. Each loop is made entirely from the file's parameters and the run's
seed, and offers

  warm()                      every shape the window will use, once;
  window(seconds, profiler, traced_units) -> Window
                              the timed loop, its first `traced_units`
                              units under the profiler when one is given;
  check(dtype) -> dict        after the window: what the window produced
                              against the plain reference on the same
                              inputs (`words_differ`, `bits_wrong`,
                              `failed`, and what was `compared`).

A new kind is a new file under kinds/ and needs no edit here. Every unit of
work records the bootstrapped calls it made (their batch), its latency and
the host seconds of its enqueue.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

from . import reference as R

#: the seed of a run's traffic is drawn apart from its keys' seed
TRAFFIC_STREAM = 0x7472


@dataclasses.dataclass
class Unit:
    """One unit of work in the window: the batch of each bootstrapped call
    it made, its latency and enqueue seconds (host clock), and whether the
    profiler traced it."""

    groups: list
    latency_s: float = 0.0
    enqueue_s: float = 0.0
    traced: bool = False


@dataclasses.dataclass
class Window:
    units: list
    seconds: float


def marker(device):
    """A point on the device's stream to wait for (None on the CPU, where
    every call has finished when it returns)."""
    if torch.device(device).type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def make(spec: dict, prog, keys: R.Keys, p: R.Params, seed: int, device):
    """The loop of a traffic file's kind (`kinds/<kind>.py`, its `Loop`),
    set up from `seed`."""
    module = importlib.import_module(f"{__package__}.kinds.{spec['kind']}")
    return module.Loop(spec, prog, keys, p, seed, device)
