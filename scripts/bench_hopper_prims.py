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
  - chains of x += roll(x, 1 + i) on int32 rows in shared memory: us per op
    and TB/s of words produced;
  - the wrappers' host path: P1-P5 at their probe shapes, where the time a
    call takes is the wrapper's and not the kernel's, once as the wrappers
    run (the device switch skipped while the card is current) and once with
    the switch entered on every call, as before, in turns.

Each chain is one launch (rs_tfhe_tpu_torch/csrc/probes.cu), timed with CUDA
events after a warm-up run; its length is sized from a short calibration run
for about TARGET_MS of device time. Inputs are random, from SEED.

Usage: python scripts/bench_hopper_prims.py      (needs a CUDA device)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from rs_tfhe_tpu_torch.ops import cuda_probes as CP  # noqa: E402

TARGET_MS = 60.0
SEED = 0

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
    lo, hi = (-128, 128) if dtype == torch.int8 else (-(1 << 31), 1 << 31)
    return torch.randint(lo, hi, shape, generator=g, dtype=dtype, device=device)


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
    row = {"rows": rows, "cols": cols, "us_per_op": per * 1e6, "tb_per_s": rows * cols * 4 / per / 1e12,
           "reps": reps}
    print(f"roll+add i32 [{rows:4},{cols:4}]: {row['us_per_op']:8.3f} us/op  {row['tb_per_s']:6.2f} TB/s  {label}",
          flush=True)
    return row


def _calls_ms(fn, reps: int) -> float:
    """Mean device-clock time a call of fn() over `reps` calls enqueued back
    to back, after one warm-up call: for a kernel of a few nanoseconds, the
    host path of its wrapper."""
    fn()
    return _event_ms(lambda: [fn() for _ in range(reps)]) / reps


def bench_launch_path(device, reps=200) -> dict:
    """P1-P5 per call with the wrappers' device switch skipped while the card
    is current (`on_device`, as they run) and entered on every call
    (`torch.cuda.device`, as before), in the order entered, skipped,
    skipped, entered; each column the mean of its two runs."""
    x = _rand(device, (8, 256), torch.int32, SEED + 3)
    x8 = _rand(device, (8, 256), torch.int8, SEED + 3)
    a8, b8 = _rand(device, (128, 1024), torch.int8, SEED + 4), _rand(device, (1024, 256), torch.int8, SEED + 5)
    a16, b16 = (torch.from_numpy(v).to(device) for v in CP.dot_correct_operands(torch.int16))
    calls = {
        "P1 probe_dot s8 [128,1024]x[1024,256]": lambda: CP.probe_dot(a8, b8),
        "P2 probe_roll int8 [8,256]": lambda: CP.probe_roll(x8, 5),
        "P3 probe_bitcast_i32_to_i8 [8,256]": lambda: CP.probe_bitcast_i32_to_i8(x),
        "P4 probe_unpack_s16 [8,256]": lambda: CP.probe_unpack_s16(x),
        "P5 probe_dot s16 [128,1024]x[1024,256]": lambda: CP.probe_dot(a16, b16),
    }
    skipped = CP.on_device
    entered = torch.cuda.device  # what the wrappers entered on every call before
    rows = {}
    for name, fn in calls.items():
        times = {"entered": [], "skipped": []}
        for mode in ("entered", "skipped", "skipped", "entered"):
            CP.on_device = entered if mode == "entered" else skipped
            try:
                times[mode].append(_calls_ms(fn, reps))
            finally:
                CP.on_device = skipped
        row = {mode: sum(v) / len(v) for mode, v in times.items()}
        rows[name] = row
        print(f"{name}: {row['skipped'] * 1e3:7.2f} us/call with the switch skipped, "
              f"{row['entered'] * 1e3:7.2f} us/call entered", flush=True)
    return rows


def main(device=None, target_ms=TARGET_MS) -> dict:
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("bench_hopper_prims: no CUDA device available")
        device = torch.device("cuda")
    print("device:", torch.cuda.get_device_name(device), flush=True)
    dots, rolls = [], []
    for title, shapes in DOT_SHAPES:
        print(f"--- {title} ---")
        dots += [bench_dot(m, k, n, device, label, target_ms) for m, k, n, label in shapes]
    print("--- shared-memory roll+add rates ---")
    rolls += [bench_roll_add(r, c, device, target_ms=target_ms) for r, c in ROLL_SHAPES]
    print("--- the wrappers' host path ---")
    return {"dots": dots, "roll_add": rolls, "launch_path": bench_launch_path(device)}


if __name__ == "__main__":
    main()
