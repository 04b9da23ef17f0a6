"""Timing and tracing (rs_tfhe_tpu/utils/profiling.py): a timer that waits
for the device, a bootstraps-a-second counter (the framework's north-star
metric), and a `torch.profiler` trace written as a Chrome trace.

Beside them, the package's own instrumentation:

  - `span(name)`: a named range of the program (`tfhe.netlist.run`,
    `tfhe.netlist.group`, `tfhe.gate`, `tfhe.radix.<op>`, `tfhe.pbs`,
    `tfhe.rotate.<route>`, `tfhe.extract`, `tfhe.keyswitch`), recorded as
    a `torch.profiler` event while a profiler records and a shared no-op
    otherwise. Every kernel launched inside a span, the ctypes launches of
    the CUDA kernels too, has it as an ancestor in the profiler's events,
    on the clock of the device's activity;
  - `counter(prefix)`: the store of the package's counters (kernel
    launches by instance, the rotation's route, work that a process should
    do once), each module's taken at its import; `counters()`: one flat
    snapshot of them all.

This module imports no other module of the package: every layer may use it.
"""

from __future__ import annotations

import collections
import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch


class _NoSpan:
    """The span while nothing traces: a shared context manager that does
    nothing (cheaper than `contextlib.nullcontext`, whose exit takes
    *args)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_NO_SPAN = _NoSpan()
_profiler_enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context manager over a range of the program named `name` (a
    static name: order in the trace tells one call from another): a
    profiler range while a profiler is recording, else a shared no-op, so a
    span costs one check when nothing traces.

    The range is the profiler's own op range (`_RecordFunctionFast`, as
    PyTorch's compiled code marks its graphs), not `record_function`: the
    profiler links a kernel to the innermost op range open at its launch,
    and a `record_function` range is a user annotation that it passes over,
    so the kernels launched here through ctypes, outside any ATen op, would
    belong to no range (measured on an H100: 13-17% of a 16-bit add's
    device time under the spans with `record_function`, all of it with op
    ranges). It also costs less with the profiler on: 1.9 against 11 us a
    span on the host of an H100 machine."""
    if _profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


#: The package's counters: prefix -> the process's Counter under it
#: (`counter`), and prefix -> the name its sum is reported under.
_store: dict = {}
_totals: dict = {}


def counter(prefix: str, keys=(), total: str | None = None) -> collections.Counter:
    """The process's Counter under `prefix`, made on first use, with `keys`
    at 0. A module takes its counters once, at import, and counts in them;
    `counters()` reports each count under `<prefix>.<key>` (a tuple key's
    parts joined by '/'), or with the key in place of a '*' in the prefix,
    and with `total` the sum of the counts under that name too."""
    c = _store.setdefault(prefix, collections.Counter())
    for k in keys:
        c.setdefault(k, 0)
    if total is not None:
        _totals[prefix] = total
    return c


def counters() -> dict:
    """Every counter of the package, now, as one flat dict of name -> count:

      k1.launches, k1.instance.<N>/<tile>/<cluster>/<unit>   ops/cuda_blind_rotate
      k4.launches, k4.instance.<N>/<tile>/<cluster>          ops/cuda_blind_rotate_mb
      k5.launches, k5.instance.<N>/<unit>/<tile>/<split>/<J> ops/cuda_step
      ks.launches, ks.instance.<ciphertexts a block>         ops/cuda_keyswitch
      probes.launches.<wrapper>, probes.roll_add.instance.<E>  ops/cuda_probes
      nussbaumer.shape.<B>/<K>/<M>                           ops/nussbaumer
      rotate.route.<route>.calls / .ciphertexts              ops/blind_rotate
      keyswitch.route.<select|product>.calls / .ciphertexts  ops/keyswitch
      bsk.grid_checks      whole-key reads of key_limbs (each synchronises)
      bsk.strip_builds     key_strips builds of the wgmma instance's key operand
      netlist.index_placements  a compiled plan's indices moved to a device
      build.nvcc           kernel builds that ran nvcc in this process
      lut.tables_built     LutBootstrap table cache misses
      pbs.calls, pbs.ciphertexts, pbs.per_row_luts          bootstrap: LUT bootstraps,
                           the ciphertexts they rotated, those with a test vector a ciphertext
      radix.ops.<add|sub|compare|mul>                       models/arithmetic

    (`k<n>.launches` is the sum of that kernel's instance counts.) The counts
    are the process's since it started; subtract two snapshots for what ran
    between them."""
    out = {}
    for prefix, c in _store.items():
        if prefix in _totals:
            out[_totals[prefix]] = sum(c.values())
        for k, n in c.items():
            k = "/".join(map(str, k)) if isinstance(k, tuple) else str(k)
            out[prefix.replace("*", k) if "*" in prefix else f"{prefix}.{k}"] = n
    return out


def _first_tensor(x):
    """The first tensor of a tensor or a nested list, tuple or dict of them."""
    if isinstance(x, torch.Tensor):
        return x
    for leaf in (x.values() if isinstance(x, dict) else x if isinstance(x, (list, tuple)) else ()):
        found = _first_tensor(leaf)
        if found is not None:
            return found
    return None


def force(x) -> None:
    """Wait until the device of `x` (a tensor, or a nested list, tuple or
    dict of tensors: the first one's device) has finished all its queued
    work. Work on the CPU is done when the call returns."""
    t = _first_tensor(x)
    if t is None:
        raise TypeError(f"force: no tensor in {type(x).__name__}")
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


@dataclass
class Timer:
    """Named host-clock spans, each ending after the device has finished."""

    spans: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def span(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        yield
        if sync_on is not None:
            force(sync_on)
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def report(self) -> str:
        lines = []
        for name, ts in self.spans.items():
            lines.append(
                f"{name}: n={len(ts)} total={sum(ts):.3f}s "
                f"mean={np.mean(ts) * 1e3:.1f}ms min={min(ts) * 1e3:.1f}ms"
            )
        return "\n".join(lines)


def gate_throughput(gate_fn, a, b, ck, iters: int = 3) -> float:
    """Bootstrapped gates a second: `iters` chained calls (each output is the
    next input, so no call repeats another), one wait for the device, after
    one warm-up call."""
    force(gate_fn(a, b, ck))
    t0 = time.perf_counter()
    cur = a
    for _ in range(iters):
        cur = gate_fn(cur, b, ck)
    force(cur)
    return a.shape[0] / ((time.perf_counter() - t0) / iters)


@contextlib.contextmanager
def trace(path):
    """Profile the block with `torch.profiler` (the CPU, and the card where
    there is one) and write a Chrome trace to `path` (open it in
    chrome://tracing or Perfetto). A profiler that fails to start or stop
    raises: nothing is swallowed."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(path))
