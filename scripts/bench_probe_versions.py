"""Times the probe dots (P1 at s8, s16 and s32, P6's chained s8 dot), the
s16 unpack (P4) and the chained roll+add (P7) of one or more checkouts of
this repository on one CUDA card, so that two versions compare within one
call, on one card.

Usage: python scripts/bench_probe_versions.py ROOT [ROOT ...]

Each ROOT (a checkout, e.g. a parent commit unpacked with `git archive`) is
run in a process of its own, in the order given (parent, change, change,
parent puts each version on both sides of the other): that process imports
ROOT's rs_tfhe_tpu_torch, which builds ROOT's kernels into ROOT, and times
them with this checkout's helpers (scripts/bench_hopper_prims.py). Every
case is first held against ROOT's plain version (bit for bit) and fails the
run if it differs.

Cases (ms a call):
  - P1 `probe_dot` at the TPU probe shape [128,1024]x[1024,256] (s8, s16,
    s32; CUDA events over calls back to back, which at this shape read the
    wrapper's host path, and the median host clock of a call) and at
    [4096,4096]x[4096,4096] (events);
  - P6 `chain_dot` on the tensor cores at [4096]^3, 3 steps, per dot;
  - P4 `probe_unpack_s16` at [8,256] (events over calls back to back, and
    the median host clock of a call) and
    at the FAST cloud key's bsk as [5600,1024] (`device_ms`: the calls
    enqueued behind a sleep kernel, inputs rotating through copies that
    span three times the L2);
  - P7 `chain_roll_add` at the four shapes of
    scripts/bench_hopper_prims.py's ROLL_SHAPES, as a long chain (LONG_REPS
    x 16 steps, events over a few calls: the device time, reported as ns a
    step beside the step's bound, one 32-bit add a word at the SM's issue
    rate, IADD3 and IMAD on two pipes) and as the 64-step call of
    chip_smoke.py (events over calls
    back to back, and the median host clock of a call: its host path); with
    the instance the wrapper picked (E, 0 for shared memory) where the
    checkout records one;
  - beside them the PyTorch calls that compute the same function: float64
    `torch.matmul` with the int64 wrap to int32 (s8, s16) and the
    `permute(2, 0, 1).contiguous()` of the words' int16 view (P4); none
    computes P7.
The last line is one JSON object: the card and the times by ROOT and run.
"""

import collections
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PROBE_SHAPE = (128, 1024, 256)
BIG = (4096, 4096, 4096)
UNPACK_SHAPES = ((8, 256), (5600, 1024))
#: Repetitions of P7's 16 steps in its long chain, and in chip_smoke.py's short one.
LONG_REPS = 1024
SHORT_REPS = 4
#: 32-bit integer adds a second on the CUDA cores of one H100 SXM (chip_smoke.py's PEAK_INT32_ADDS).
PEAK_INT32_ADDS = 67e12 / 2


def _measure(root: str) -> dict:
    """The cases of the module docstring for ROOT's package, in this process."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from rs_tfhe_tpu_torch.ops import cuda_probes as CP

    if not os.path.abspath(CP.__file__).startswith(os.path.abspath(root)):
        raise SystemExit(f"bench_probe_versions: imported {CP.__file__}, not the package of {root}")
    sys.path.insert(1, HERE)
    import bench_hopper_prims as B  # its `CP` is the module imported above

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = {}

    def case(name, kernel, plain, timer, reps, library=None, timed=None):
        """kernel() against plain(); then timer(timed or kernel, reps) and, where given, the library call;
        where the events read the host path (calls back to back at the probe shapes), also the median host
        clock of a call over 5 rounds (`host_us`, and the library call's beside it: the same PyTorch call in
        every process, so it shows how fast that process's host path runs)."""
        got, want = kernel(), plain()
        got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple) else (want,))
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"bench_probe_versions: {name} differs from the plain version in {root}")
        row = out[name] = {"ms": timer(timed or kernel, reps)}
        if library is not None:
            row["library_ms"] = timer(library, reps)
        if timer is B._calls_ms and reps >= 200:
            row["host_us"] = B._host_us(timed or kernel, reps)
            if library is not None:
                row["library_host_us"] = B._host_us(library, reps)
        print(f"  {name}: {row['ms']:.4f} ms" + (f", library {row['library_ms']:.4f} ms" if library else "")
              + (f", host clock {row['host_us']:.2f} us a call" if "host_us" in row else "")
              + (f" (library {row['library_host_us']:.2f})" if "library_host_us" in row else ""), flush=True)

    def f64_matmul(a, b):
        return lambda: (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int64).to(torch.int32)

    for (m, k, n), reps in ((PROBE_SHAPE, 200), (BIG, 10)):
        for dtype in (torch.int8, torch.int16, torch.int32):
            a, b = B._rand(dev, (m, k), dtype, 1), B._rand(dev, (k, n), dtype, 2)
            name = f"P1 {str(dtype).removeprefix('torch.')} [{m},{k}]x[{k},{n}]"
            lib = f64_matmul(a, b) if dtype != torch.int32 else None
            case(name, lambda: CP.probe_dot(a, b), lambda: CP.dot_plain(a, b), B._calls_ms, reps, lib)
    a0, b = B._rand(dev, BIG[:2], torch.int8, 3), B._rand(dev, BIG[1:], torch.int8, 4)
    steps = 3
    case(f"P6 chain_dot tensor {list(BIG)} {steps} steps, per dot",
         lambda: CP.chain_dot(a0, b, steps, unit="tensor").acc, lambda: CP.chain_dot_plain(a0, b, steps)[0],
         lambda fn, reps: B._calls_ms(fn, reps) / steps, 3)
    del a0, b

    def planes(x):
        return x.view(torch.int16).view(*x.shape, 2).permute(2, 0, 1).contiguous()

    for shape in UNPACK_SHAPES:
        x = B._rand(dev, shape, torch.int32, 5)
        name = f"P4 unpack_s16 [{shape[0]},{shape[1]}]"
        if shape == UNPACK_SHAPES[0]:
            case(name, lambda: CP.probe_unpack_s16(x), lambda: CP.unpack_s16_plain(x), B._calls_ms, 200,
                 lambda: planes(x))
        else:
            xs = B.copies_of(x, 8 * x.numel())
            case(name, lambda: CP.probe_unpack_s16(x), lambda: CP.unpack_s16_plain(x), B.device_ms, 20,
                 B.rotating(planes, xs), timed=B.rotating(CP.probe_unpack_s16, xs))
            del xs

    for rows, cols in B.ROLL_SHAPES:
        x = B._rand(dev, (rows, cols), torch.int32, 6)
        bound_ns = rows * cols / PEAK_INT32_ADDS * 1e9
        for reps, calls in ((LONG_REPS, 3), (SHORT_REPS, 200)):
            steps = 16 * reps
            name = f"P7 chain_roll_add [{rows},{cols}] {steps} steps"
            before = collections.Counter(getattr(CP, "roll_add_launches", ()))
            case(name, lambda: CP.chain_roll_add(x, reps), lambda: CP.chain_roll_add_plain(x, reps), B._calls_ms,
                 calls)
            row = out[name]
            # a checkout without a per-instance count has the shared-memory instance alone
            row["instance"] = sorted(collections.Counter(getattr(CP, "roll_add_launches", ())) - before) or [0]
            if reps == LONG_REPS:
                row.update(ns_per_step=row["ms"] * 1e6 / steps, bound_ns_per_step=bound_ns)
                print(f"    {row['ns_per_step']:.2f} ns a step, {row['ns_per_step'] / bound_ns:.2f}x its bound "
                      f"{bound_ns:.2f} ns, E {row['instance']}", flush=True)
    return out


def main(roots) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    runs = []
    for root in roots:
        print(f"--- {root}", flush=True)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root], stdout=subprocess.PIPE,
                              text=True, timeout=1800)
        lines = proc.stdout.splitlines()
        print("\n".join(lines[:-1]), flush=True)
        if proc.returncode != 0:
            print(f"bench_probe_versions: {root} failed with exit code {proc.returncode}", file=sys.stderr)
            return 1
        runs.append({"root": root, "cases": json.loads(lines[-1])})
    print(smi)
    print(json.dumps({"card": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        print(json.dumps(_measure(sys.argv[2])))
    elif len(sys.argv) >= 2 and not sys.argv[1].startswith("-"):
        sys.exit(main(sys.argv[1:]))
    else:
        raise SystemExit(__doc__)
