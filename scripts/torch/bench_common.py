"""What the port's measurement entry points (scripts/torch/bench.py,
bench_suite.py, bench_latency_sweep.py, bench_multichip.py) share: the
device and parameter-set lookups, the barrier and the timing loops that
stand in for the JAX scripts' in-jit chains, the kernels' launch counts and
the artifact writers.

The JAX scripts time chains of calls traced into one jit and read one
scalar of the result back as the barrier. Here a chain is an eager loop
that queues every call on the card's stream, each taking the previous
output where the JAX script threads it, and the barrier is a read of one
scalar of the last output (`.item()` waits for the stream); the times are
host clock around that, as in the JAX scripts.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from soak import ROOT, card, generator, route  # noqa: E402,F401  (scripts/torch/soak.py)

import rs_tfhe_tpu_torch as tfhe  # noqa: E402
from rs_tfhe_tpu_torch.torus import resolve_device, wrap_i32  # noqa: E402
from rs_tfhe_tpu_torch.utils import profiling  # noqa: E402

#: kernel -> its launch count's name in `profiling.counters()` (the probe
#: dot's s16 unit, as the Nussbaumer route calls it, is counted under
#: `nussbaumer_dot`)
KERNELS = {
    "K1 blind_rotate": "k1.launches",
    "K4 blind_rotate_mb": "k4.launches",
    "K5 external_product": "k5.launches",
    "P1 nussbaumer_dot": "probes.launches.nussbaumer_dot",
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def device_of(cpu: bool) -> torch.device:
    """The card, or the CPU when asked (`--cpu`); without a card and
    without `--cpu` this raises."""
    return resolve_device("cpu" if cpu else None)


def params_by_name(name: str):
    """A security set by its name in ALL_SECURITY_SETS, or TEST_TINY."""
    return tfhe.TEST_TINY if name == "TEST_TINY" else tfhe.ALL_SECURITY_SETS[name]


def barrier(x) -> int:
    """Read one scalar of `x` (a tensor, or a tuple whose first item is one)
    back to the host: waits for everything queued before it."""
    t = x if isinstance(x, torch.Tensor) else x[0]
    return int(t.reshape(-1)[0])


def chain(fn, args: tuple, n: int, carry=None):
    """`fn(*args)` n times, `carry(out, args) -> args` threading each output
    into the next call's arguments (None: the same arguments again).
    Returns the last output."""
    out, cur = None, args
    for _ in range(n):
        out = fn(*cur)
        if carry is not None:
            cur = carry(out, cur)
    return out


def min_time(run, repeats: int) -> float:
    """Seconds of `run()` to the barrier: one untimed warm call, then the
    minimum over `repeats` timed ones."""
    barrier(run())
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        barrier(run())
        best = min(best, time.perf_counter() - t0)
    return best


def parity(out: torch.Tensor) -> torch.Tensor:
    """The low bit of the wrapping sum of every word of `out` (a 0-d int64
    tensor on its device): the sum mod 2 is the sum of the low bits mod 2."""
    return (out & 1).sum() & 1


def xor_into_body(out, cur):
    """Fold the whole output into the next input: the first argument's last
    word (the body) plus parity + 1, mod 2^32 (scripts/bench_suite.py:117-122)."""
    a = cur[0].clone()
    a[..., -1] = wrap_i32(a[..., -1].to(torch.int64) + parity(out) + 1)
    return (a, *cur[1:])


def launches() -> dict:
    """Every kernel's launch count in this process, now."""
    counts = profiling.counters()
    return {k: counts.get(name, 0) for k, name in KERNELS.items()}


def launched_since(before: dict) -> dict:
    """The kernels that launched since `launches()` gave `before`, with
    their counts."""
    now = launches()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def card_fields(device: torch.device) -> dict:
    """The card's name and power limit as nvidia-smi gives them, and the
    software the numbers were taken with."""
    name, limit = card(device)
    return {"device": name, "power_limit": limit, "torch": torch.__version__, "cuda": torch.version.cuda}


def load_json(path: str) -> dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def write_json(path: str, obj: dict) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
