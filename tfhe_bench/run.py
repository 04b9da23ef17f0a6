"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m tfhe_bench.run --workload <config>.<traffic> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration is the file the
manifest names for it (`configs/<config>.json`), its traffic
`traffic/<traffic>.json` (read by the loop its `kind` names,
`kinds/<kind>.py`), each metric the reader `metrics/<metric>.py`. A run: keys and inputs from the seed on the card
(keygen.py), the keys handed to the program (program.py), one warm call of
every shape, then the window of --seconds; with --trace 1 its first
`trace_units` units run under torch.profiler and the result carries the
per-layer metrics instead of the end-to-end ones. After the window, with the
program's state freed, what the window produced is held against the plain
reference (reference.py); `correct` is true when every compared number is
within its limit (limits.json). The last line of standard output is the
result, the last lines of standard error the compared numbers; before them
standard error has the rotation kernels' launch counters and the seconds of
each stage of set-up.

Exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), where the program cannot be imported, and where
JAX or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "rs_tfhe_tpu")
LIMITS = json.loads((BENCH / "limits.json").read_text())


def _fixed_caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program builds its kernels in its own package directory). A run also
    keeps Python's bytecode there: an installation that ships no bytecode
    and may not write it (or a `PYTHONDONTWRITEBYTECODE` environment)
    otherwise compiles every source of torch in every run, 6-9 s."""
    caches = BENCH / "_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(caches / sub)
    if __name__ == "__main__":
        sys.pycache_prefix = str(caches / "pyc")
        sys.dont_write_bytecode = False


_fixed_caches()

import torch  # noqa: E402

from . import keygen, traffic  # noqa: E402
from . import reference as R  # noqa: E402
from .trace import Trace  # noqa: E402


@dataclasses.dataclass
class Context:
    """What a metric's reader reads: the window, its units (with --trace 1
    the traced ones only), set-up seconds, the trace and the numbers of the
    configuration."""

    window: traffic.Window
    units: list
    setup_s: float
    trace: Trace | None
    params: R.Params


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(f"tfhe_bench.metrics.{name}", BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(manifest: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (trace 0) or per-layer metrics (trace 1)."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def default_program(cfg: dict, keys: R.Keys, p: R.Params, device):
    from .program import Program

    return Program(cfg, keys, device)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cfg: dict, spec: dict, seed: int, seconds: float, trace: bool, device, metrics: list[dict],
             make_program=default_program, t0: float = _T0) -> tuple[dict, list[str]]:
    """One run of a cell: (result line, lines of compared numbers)."""
    on_card = torch.device(device).type == "cuda"
    stages = {"imports": time.perf_counter() - t0}

    def stage(name: str) -> None:
        if on_card:
            torch.cuda.synchronize(device)
        stages[name] = time.perf_counter() - t0 - sum(stages.values())

    p = R.Params.from_config(cfg)
    keys = keygen.make_keys(seed, p, device)
    stage("keys")
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    prog = make_program(cfg, keys, p, device)
    stage("program")
    mix = traffic.make(spec, prog, keys, p, seed, device)
    stage("traffic")
    mix.warm()
    stage("warm")
    profiler, traced = None, 0
    if trace:
        from torch.profiler import ProfilerActivity, profile

        profiler = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        traced = spec["trace_units"]
    setup_s = time.perf_counter() - t0
    window = mix.window(seconds, profiler, traced)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules loaded in the run's process: {found} (no JAX and no JAX package here)")
    print("launches " + json.dumps(prog.launches()), file=sys.stderr, flush=True)
    print("setup_stages_s " + json.dumps(stages), file=sys.stderr, flush=True)
    tr = Trace(profiler.events()) if trace else None
    units = [u for u in window.units if u.traced] if trace else window.units
    ctx = Context(window=window, units=units, setup_s=setup_s, trace=tr, params=p)
    values = {}
    for m in metrics:
        v = metric_reader(m["name"])(ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    mix.prog = mix.run = None
    del prog
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checked = mix.check()
    checks = {k: {"value": checked[k], "limit": LIMITS[k]} for k in LIMITS}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    if tr is not None:
        device_info.update(busy_s=tr.busy_us * 1e-6, window_s=tr.span_us * 1e-6)
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(window.units),
        "failed": checked["failed"],
        "metrics": values,
        "device": device_info,
    }
    if tr is not None:
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    lines = [f"compared {json.dumps(checked['compared'])}"]
    lines += [f"{k} {c['value']} limit {c['limit']}" for k, c in checks.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    config = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / config["file"]).read_text())
    spec = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    result, lines = run_cell(cfg, spec, args.seed, args.seconds, bool(args.trace), torch.device("cuda:0"),
                             cell_metrics(manifest, cell["name"], bool(args.trace)))
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
