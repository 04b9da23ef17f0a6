"""Microbenchmarks of kernel primitives on an NVIDIA Hopper card: the
counterpart of scripts/bench_kernel_prims.py for the PyTorch port.

  - chains of dependent s8 dots (each lhs rebuilt from the previous
    accumulator, so nothing overlaps or folds) at the 13 shapes of the TPU
    script, and one shape large enough to fill the card: us per dot and
    TMAC/s on the tensor cores (wgmma m64n128k32 fed by TMA, 128 x 128
    tiles), and beside it the same chain by int32 multiply-adds on the CUDA
    cores (64 x 64 tiles). For each, the multiply-adds per clock inside the
    tile loop (cycle counter) of the SM that ran the most tiles, the number
    that says what one SM sustains;
  - chains of x += roll(x, 1 + i) on int32 rows, each on the instance its
    shape selects (a row in a warp's registers where its width is 32 E for an
    instantiated E, else in shared memory): us per op and TB/s of words
    produced;
  - the wrappers' host path: P1-P5 at their probe shapes, where the time a
    call takes is the wrapper's and not the kernel's, P2 and P3 on one word
    (the floor) and the PyTorch calls beside them (torch.roll, view, a
    clone); then a P2 and a P3 launch split into its steps, each timed alone;
  - P2 (roll) and P3 (bitcast) at the sizes of the FAST accumulator and
    cloud key beside torch.roll and a clone: ms a call and TB/s.

Each chain is one launch (rs_tfhe_tpu_torch/csrc/probes.cu), timed with CUDA
events after a warm-up run; its length is sized from a short calibration run
for about TARGET_MS of device time. Inputs are random, from SEED.

Usage: python scripts/bench_hopper_prims.py [--no-chains]     (needs a CUDA device)
"""

import argparse
import collections
import itertools
import math
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from rs_tfhe_tpu_torch.ops import cuda_probes as CP  # noqa: E402

TARGET_MS = 60.0
SEED = 0
#: Calls a round of a host-path timing.
HOST_CALLS = 400
#: Clocks of the sleep kernel `device_ms` starts with: 2 ms at 2 GHz, longer
#: than the host takes to enqueue its calls.
SLEEP_CYCLES = 4_000_000
#: Device memory bytes/s of one H100 SXM (NVIDIA's data sheet).
PEAK_BYTES = 3.35e12

DOT_SHAPES = (
    ("dot orientation: same 134 MMACs, different M", (
        (128, 1024, 1024, "TPU kernel shape"), (1024, 1024, 128, "transposed (small rhs)"),
        (256, 1024, 512, ""))),
    ("larger fused dots (537 MMAC)", (
        (128, 4096, 1024, "j-stacked K"), (4096, 1024, 128, "transposed, j-stacked M"),
        (128, 1024, 4096, "q,o-merged columns"), (256, 1024, 2048, ""))),
    ("Nussbaumer pointwise shapes (m=128)", (
        (128, 768, 1024, "[FB,6j*m]x[6j*m,8(oq)*m]"), (128, 512, 1024, "L=2 variant"),
        (1024, 768, 128, "transposed"))),
    ("small-K penalty check", ((128, 128, 128, ""), (128, 128, 1024, ""), (128, 256, 1024, ""))),
    ("card-filling shape (1024 tensor-core tiles for the card's 132 SMs)", ((4096, 4096, 4096, ""),)),
)
ROLL_SHAPES = ((128, 1024), (128, 128), (8, 1024), (256, 2048))


def _event_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _sized(run, first: int, target_ms: float, cap: int):
    """(length, ms, result) of run(length) sized for ~target_ms from a
    calibration run of `first`; the calibration also warms the kernel."""
    ms = _event_ms(lambda: run(first))
    length = max(first, min(cap, int(first * target_ms / max(ms, 1e-3))))
    result = []
    ms = _event_ms(lambda: result.append(run(length)))
    return length, ms, result[0]


def _rand(device, shape, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max + 1, shape, generator=g, dtype=dtype, device=device)


def bench_dot(m, k, n, device, label="", target_ms=TARGET_MS) -> dict:
    """One row: the chain on the tensor cores and on the CUDA cores."""
    a0, b = _rand(device, (m, k), torch.int8, SEED), _rand(device, (k, n), torch.int8, SEED + 1)
    macs = m * k * n
    row = {"m": m, "k": k, "n": n}
    for unit in ("tensor", "imad"):
        steps, ms, res = _sized(lambda s, unit=unit: CP.chain_dot(a0, b, s, unit=unit), 4, target_ms, 1 << 16)
        cycles, sms, busiest = res.tile_loop()
        row[unit] = {"us_per_dot": ms * 1e3 / steps, "tmac_per_s": macs * steps / (ms * 1e-3) / 1e12,
                     "mac_per_clk_per_sm": CP.tile_loop_rate(m, k, n, unit, cycles, busiest), "sms": sms,
                     "steps": steps, "blocks": res.blocks}
    t, i = row["tensor"], row["imad"]
    print(
        f"dot s8 [{m:4},{k:4}]x[{k:4},{n:4}]: wgmma {t['us_per_dot']:9.2f} us/dot {t['tmac_per_s']:7.2f} TMAC/s "
        f"({t['mac_per_clk_per_sm']:7.1f} MAC/clk/SM in the tile loop on {t['sms']:3} SMs) | "
        f"int32 {i['us_per_dot']:9.2f} us/dot {i['tmac_per_s']:6.2f} TMAC/s "
        f"({i['mac_per_clk_per_sm']:5.1f} MAC/clk/SM on {i['sms']:3} SMs)  {label}",
        flush=True,
    )
    return row


def bench_roll_add(rows, cols, device, label="", target_ms=TARGET_MS) -> dict:
    x = _rand(device, (rows, cols), torch.int32, SEED + 2)
    reps, ms, _ = _sized(lambda r: CP.chain_roll_add(x, r), 64, target_ms, 1 << 20)
    per = ms * 1e-3 / (reps * 16)
    words = CP.roll_add_words(cols)
    instance = f"registers E={words}" if words else "shared"
    row = {"rows": rows, "cols": cols, "us_per_op": per * 1e6, "tb_per_s": rows * cols * 4 / per / 1e12,
           "reps": reps, "instance": instance}
    print(f"roll+add i32 [{rows:4},{cols:4}]: {row['us_per_op']:8.3f} us/op  {row['tb_per_s']:6.2f} TB/s  "
          f"({instance})  {label}", flush=True)
    return row


def _calls_ms(fn, reps: int) -> float:
    """Mean device-clock time a call of fn() over `reps` calls enqueued back
    to back, after one warm-up call: for a kernel of a few nanoseconds, the
    host path of its wrapper. No output is kept (kept outputs would make
    each call allocate anew)."""
    def calls():
        for _ in range(reps):
            fn()

    fn()
    return _event_ms(calls) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device time of a call of fn() over `reps` calls enqueued while a
    sleep kernel holds the card, so that their kernels run back to back on
    it whatever each call's host path costs: the time of a kernel shorter
    than its host path (a copy of a few MB), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    return _calls_ms(fn, reps)


def _host_us(fn, calls: int = HOST_CALLS, rounds: int = 5) -> float:
    """Median over `rounds` of the host-clock time of a call of fn(), each
    round `calls` calls and a synchronise, after one warm-up round."""
    per = []
    for r in range(rounds + 1):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        if r:
            per.append((time.perf_counter() - t0) / calls * 1e6)
    return statistics.median(per)


def bench_launch_path(device, reps=200) -> dict:
    """µs a call of P1-P5 at their probe shapes, of P2 and P3 on one word
    (the floor: a call whose kernel has nothing to do) and of the PyTorch
    calls beside them, by CUDA events over `reps` calls back to back (what
    chip_smoke.py's times at these shapes read) and by the host clock."""
    x = _rand(device, (8, 256), torch.int32, SEED + 3)
    x8 = _rand(device, (8, 256), torch.int8, SEED + 3)
    w8, w = _rand(device, (1, 16), torch.int8, SEED + 6), _rand(device, (1, 1), torch.int32, SEED + 6)
    a8, b8 = _rand(device, (128, 1024), torch.int8, SEED + 4), _rand(device, (1024, 256), torch.int8, SEED + 5)
    a16, b16 = (torch.from_numpy(v).to(device) for v in CP.dot_correct_operands(torch.int16))
    calls = {
        "P1 probe_dot s8 [128,1024]x[1024,256]": lambda: CP.probe_dot(a8, b8),
        "P2 probe_roll int8 [8,256]": lambda: CP.probe_roll(x8, 5),
        "P2 probe_roll int8 [1,16] (floor)": lambda: CP.probe_roll(w8, 5),
        "torch.roll int8 [8,256]": lambda: torch.roll(x8, 5, dims=1),
        "P3 probe_bitcast_i32_to_i8 [8,256]": lambda: CP.probe_bitcast_i32_to_i8(x),
        "P3 probe_bitcast_i32_to_i8 [1,1] (floor)": lambda: CP.probe_bitcast_i32_to_i8(w),
        "x.view(torch.int8) [8,256]": lambda: x.view(torch.int8),
        "x.view(torch.int8).reshape(8, -1).clone() [8,256]": lambda: x.view(torch.int8).reshape(8, -1).clone(),
        "P4 probe_unpack_s16 [8,256]": lambda: CP.probe_unpack_s16(x),
        "P5 probe_dot s16 [128,1024]x[1024,256]": lambda: CP.probe_dot(a16, b16),
    }
    rows = {}
    for name, fn in calls.items():
        row = rows[name] = {"events_us": _calls_ms(fn, reps) * 1e3, "host_us": _host_us(fn, reps)}
        print(f"{name}: {row['events_us']:7.2f} us/call (events), {row['host_us']:7.2f} us/call (host clock)",
              flush=True)
    return rows


def host_path_split(device) -> dict:
    """The host path of a P2 (int8 [8,256] by 5) and a P3 (int32 [8,256])
    launch, step by step: each step alone, µs a call by the host clock
    (`_host_us`). Where a step can be taken two ways, both are timed: the
    library's lock around a read of the loaded library beside `_build.load()`
    as it stands; the device switch as the `on_device` context beside a
    comparison with the current device; the stream as a `Stream` object
    beside the raw handle; the library function looked up by name beside one
    resolved once. The ctypes calls launch the kernels."""
    from rs_tfhe_tpu_torch import _build
    from rs_tfhe_tpu_torch.ops.cuda_blind_rotate import on_device

    lib = _build.load()
    index = torch.cuda.current_device() if device.index is None else device.index
    dev = torch.device("cuda", index)
    raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    x8, x = _rand(dev, (8, 256), torch.int8, SEED + 3), _rand(dev, (8, 256), torch.int32, SEED + 3)
    out8, out = torch.empty_like(x8), torch.empty((8, 1024), dtype=torch.int8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = {"tfhe_probe_roll": (x8.data_ptr(), out8.data_ptr(), 8, 256, 5, 1),
            "tfhe_probe_bitcast_i32_to_i8": (x.data_ptr(), out.data_ptr(), x.numel())}
    resolved = {sym: getattr(lib, sym) for sym in args}

    def locked_read():
        with _build._lock:
            return _build._lib

    def switch():
        with on_device(index):
            pass

    def count():
        CP.launches["host_path_split"] += 1

    steps = {
        "check, P2 (_check)": lambda: CP._check("x", x8, CP._INT_TYPES),
        "check, P3 (_check)": lambda: CP._check("x", x, (torch.int32,)),
        "allocation, P2 (empty_like)": lambda: torch.empty_like(x8),
        "allocation, P3 (empty)": lambda: torch.empty((8, 1024), dtype=torch.int8, device=dev),
        "allocation, P3 (new_empty)": lambda: x.new_empty((8, 1024), dtype=torch.int8),
        "library: _build.load()": _build.load,
        "library: a read under the lock": locked_read,
        "device: on_device context": switch,
        "device: current_device() == index": lambda: torch.cuda.current_device() == index,
        "device: torch._C._cuda_getDevice() == index": lambda: torch._C._cuda_getDevice() == index,
        "device: x.get_device()": x8.get_device,
        "stream: current_stream(device).cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "data_ptr() of input and output": lambda: (x8.data_ptr(), out8.data_ptr()),
        "call, P2: getattr(lib, name) + ctypes + launch": lambda: getattr(lib, "tfhe_probe_roll")(
            *args["tfhe_probe_roll"], stream),
        "call, P2: resolved function + ctypes + launch": lambda: resolved["tfhe_probe_roll"](
            *args["tfhe_probe_roll"], stream),
        "call, P3: getattr(lib, name) + ctypes + launch": lambda: getattr(lib, "tfhe_probe_bitcast_i32_to_i8")(
            *args["tfhe_probe_bitcast_i32_to_i8"], stream),
        "call, P3: resolved function + ctypes + launch": lambda: resolved["tfhe_probe_bitcast_i32_to_i8"](
            *args["tfhe_probe_bitcast_i32_to_i8"], stream),
        "counter": count,
        "whole wrapper, P2": lambda: CP.probe_roll(x8, 5),
        "whole wrapper, P3": lambda: CP.probe_bitcast_i32_to_i8(x),
    }
    if raw_stream is not None:
        steps["stream: torch._C._cuda_getCurrentRawStream(index)"] = lambda: raw_stream(index)
    print(f"torch {torch.__version__}: torch._C._cuda_getCurrentRawStream "
          f"{'present' if raw_stream is not None else 'absent'}", flush=True)
    rows = {}
    for name, fn in steps.items():
        rows[name] = _host_us(fn)
        print(f"  {name:52} {rows[name]:7.3f} us", flush=True)
    CP.launches.pop("host_path_split", None)
    return rows


#: (label, the input's dtype and shape, the wrapper's call, the PyTorch call
#: computing the same function): P2 and P3 at the sizes of the FAST
#: accumulator at B = 4096 (4096 x 2 polynomials of N = 1024 words) and of
#: the FAST cloud key's bsk ([700 * 2L * 2, N] words).
COPY_CASES = tuple(
    (f"P2 probe_roll {str(dtype).removeprefix('torch.')} [8192,1024] by {shift}", dtype, (8192, 1024),
     lambda x, s=shift: CP.probe_roll(x, s), lambda x, s=shift: torch.roll(x, s, dims=1))
    for dtype in (torch.int8, torch.int16, torch.int32) for shift in (5, 1000)
) + (("P3 probe_bitcast_i32_to_i8 [5600,1024]", torch.int32, (5600, 1024), CP.probe_bitcast_i32_to_i8,
      lambda x: x.view(torch.int8).reshape(x.shape[0], -1).clone()),)
#: Bytes the rotating copies of an input (and their outputs) span together:
#: three times the card's 50 MB L2, so each call reads its input from memory.
ROTATE_BYTES = 150e6


def rotating(fn, inputs):
    """A function that calls fn on the next of `inputs` in turn and returns
    its output, keeping the last len(inputs) outputs alive (so the outputs
    too rotate through as many buffers). It is called once on every input and
    once more here, so that every buffer it rotates through is allocated
    before a timing starts (a first allocation waits for the card)."""
    turn, kept = itertools.cycle(inputs), collections.deque(maxlen=len(inputs))

    def call():
        out = fn(next(turn))
        kept.append(out)
        return out

    for _ in range(len(inputs) + 1):
        call()
    return call


def copies_of(x, nbytes: float) -> list:
    """x and enough copies of it in other buffers for `rotating` to span
    ROTATE_BYTES with each call moving `nbytes`."""
    return [x] + [x.clone() for _ in range(max(3, math.ceil(ROTATE_BYTES / nbytes)) - 1)]


def bench_copies(device, reps=20) -> dict:
    """P2 and P3 at size (COPY_CASES) beside their PyTorch calls: ms a call
    (`device_ms`, the input rotating through copies spanning three times the
    L2) and the share of 3.35 TB/s that reading the input once and writing
    the output once makes of it."""
    rows = {}
    for label, dtype, shape, kernel, library in COPY_CASES:
        x = _rand(device, shape, dtype, SEED + 7)
        nbytes = 2 * x.numel() * x.element_size()
        xs = copies_of(x, nbytes)
        check = kernel(x)
        torch.cuda.synchronize()
        equal = torch.equal(check, library(x).view(check.shape))
        k_ms = device_ms(rotating(kernel, xs), reps)
        lib_ms = device_ms(rotating(library, xs), reps)
        bound_ms = nbytes / PEAK_BYTES * 1e3
        rows[label] = {"ms": k_ms, "library_ms": lib_ms, "bound_ms": bound_ms, "equal": equal,
                       "tb_per_s": nbytes / k_ms / 1e9}
        print(f"{label}: equal={equal} {k_ms:.4f} ms ({rows[label]['tb_per_s']:.2f} TB/s, "
              f"{bound_ms / k_ms:.0%} of {PEAK_BYTES / 1e12} TB/s), library {lib_ms:.4f} ms, bound {bound_ms:.4f} ms",
              flush=True)
        del xs
    return rows


def main(device=None, target_ms=TARGET_MS, chains=True) -> dict:
    """Every table; without `chains`, only the host path and the copies."""
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("bench_hopper_prims: no CUDA device available")
        device = torch.device("cuda")
    print("device:", torch.cuda.get_device_name(device), flush=True)
    dots, rolls = [], []
    if chains:
        for title, shapes in DOT_SHAPES:
            print(f"--- {title} ---")
            dots += [bench_dot(m, k, n, device, label, target_ms) for m, k, n, label in shapes]
        print("--- roll+add rates ---")
        rolls += [bench_roll_add(r, c, device, target_ms=target_ms) for r, c in ROLL_SHAPES]
    print("--- the wrappers' host path ---")
    launch_path = bench_launch_path(device)
    print("--- the host path of a P2 and a P3 launch, step by step (host clock) ---")
    split = host_path_split(device)
    print("--- P2 and P3 at size ---")
    return {"dots": dots, "roll_add": rolls, "launch_path": launch_path, "host_path_split": split,
            "copies": bench_copies(device)}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--no-chains", action="store_true",
                        help="skip the chained-dot and roll+add tables (the host path and the copies only)")
    main(chains=not parser.parse_args().no_chains)
