"""Helpers of the tests that hold the PyTorch port's examples
(examples/torch/) against the JAX package's (examples/): running both, and
reading an example's result lines out of what it prints.

A port example runs in a process of its own, as a user runs it. The JAX
examples of one test module run once, one after another in ONE process
(`jax_outputs`), each as its own `__main__` with the same argv as
tests/test_examples_smoke.py gives it, and with JAX's caches cleared between
them."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
PORT_EXAMPLES = EXAMPLES / "torch"

#: The flags that shrink the CPU runs, as tests/test_examples_smoke.py
#: gives the JAX examples (sizes only; every code path still runs).
SMOKE_FLAGS = {
    "multi_chip_scaling.py": ["--batch", "64"],
    "encrypted_sort.py": ["--n", "2", "--width", "4"],
    "radix_integers.py": ["--digits", "2"],
    "low_latency_gates.py": ["--long", "9", "--reps", "1"],
    "ciphertext_multiply.py": ["--bits", "2", "--x", "3", "--y", "2"],
    "batch_gates.py": ["--max_batch", "64"],
}

#: A line that reports a time (seconds or milliseconds: "0.174s", "3 ms"),
#: or a ratio of two times.
_TIME = re.compile(r"\d(\.\d+)?\s?m?s\b|^\[speedup\]")
_NUMBER = re.compile(r"[\d.]+")


def result_lines(stdout: str) -> list:
    """What an example printed, less its times: plaintexts, truth tables,
    sizes, parameters and "OK" lines. A line that reports a time goes; a
    table row of numbers keeps its first column (batch_gates' batch)."""
    lines = []
    for line in stdout.splitlines():
        if _TIME.search(line):
            continue
        cols = line.split()
        if cols and all(_NUMBER.fullmatch(c) for c in cols):
            line = cols[0]
        lines.append(line)
    return lines


def time_labels(stdout: str) -> list:
    """The labels of the lines that report a time: each line's text before
    its first digit."""
    return [re.split(r"\d", line, maxsplit=1)[0] for line in stdout.splitlines() if _TIME.search(line)]


def run_port(name: str, *flags, cpu: bool = True, timeout: int = 300) -> subprocess.CompletedProcess:
    """The port's example with --cpu (unless cpu=False) and the smoke flags
    (unless flags are given), one torch thread."""
    argv = [*(["--cpu"] if cpu else []), *(flags or SMOKE_FLAGS.get(name, []))]
    return subprocess.run([sys.executable, str(PORT_EXAMPLES / name), *argv], capture_output=True, text=True,
                          timeout=timeout, env={**os.environ, "OMP_NUM_THREADS": "1"})


_JAX_DRIVER = r"""
import contextlib, io, json, runpy, sys, traceback
examples_dir, runs = sys.argv[1], json.loads(sys.argv[2])
sys.path.insert(0, examples_dir)
import jax
results = {}
for name, flags in runs:
    buf = io.StringIO()
    sys.argv = [f"{examples_dir}/{name}", "--cpu", *flags]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(sys.argv[0], run_name="__main__")
        results[name] = {"ok": True, "stdout": buf.getvalue()}
    except BaseException:
        results[name] = {"ok": False, "stdout": buf.getvalue(), "error": traceback.format_exc()}
    jax.clear_caches()
print("\n" + json.dumps(results))
"""


def jax_outputs(names, timeout: int = 900) -> dict:
    """{name: {"ok", "stdout"[, "error"]}} of the JAX examples `names`, run
    with the smoke flags in one process on JAX's CPU backend."""
    runs = [(name, SMOKE_FLAGS.get(name, [])) for name in names]
    res = subprocess.run([sys.executable, "-c", _JAX_DRIVER, str(EXAMPLES), json.dumps(runs)], capture_output=True,
                         text=True, timeout=timeout, env={**os.environ, "JAX_PLATFORMS": "cpu"}, cwd=str(ROOT))
    if res.returncode != 0:
        raise RuntimeError(f"the JAX examples' run failed: {res.stderr[-3000:]}")
    return json.loads(res.stdout.splitlines()[-1])


class ExampleGroup:
    """The checks of one test module's examples: each runs on the CPU and
    exits 0; its result lines equal those of the JAX example under the same
    flags; and without --cpu, on a machine with no card, it raises rather
    than run on the CPU. `needs_device` lists the examples that make tensors
    (all but one: security_levels prints the parameter sets only)."""

    def __init__(self, names):
        self.names = list(names)
        self.needs_device = [n for n in self.names if n != "security_levels.py"]
        self._port = {}
        self._jax = None

    def port(self, name: str) -> subprocess.CompletedProcess:
        if name not in self._port:
            self._port[name] = run_port(name)
        return self._port[name]

    def jax(self, name: str) -> dict:
        if self._jax is None:
            self._jax = jax_outputs(self.names)
        return self._jax[name]

    def check_runs(self, name: str) -> None:
        res = self.port(name)
        assert res.returncode == 0, (res.stdout[-1000:], res.stderr[-2000:])

    def check_matches_jax(self, name: str) -> None:
        res, ref = self.port(name), self.jax(name)
        assert ref["ok"], ref.get("error")
        assert res.returncode == 0, res.stderr[-2000:]
        got, want = result_lines(res.stdout), result_lines(ref["stdout"])
        if not want:  # an example that prints times only (keygen_speed): what it timed, in order
            got, want = time_labels(res.stdout), time_labels(ref["stdout"])
        assert want and got == want, (got, want)

    @staticmethod
    def check_needs_a_card(name: str) -> None:
        res = run_port(name, "--params", "TEST_TINY", cpu=False)
        assert res.returncode != 0 and "no CUDA device" in res.stderr, (res.stdout[-500:], res.stderr[-1000:])
