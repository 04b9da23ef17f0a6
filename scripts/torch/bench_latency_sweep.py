"""The B = 1..128 gate-latency map of the PyTorch port on the card: the
counterpart of scripts/bench_latency_sweep.py, with its slope, batches and
row fields, over the port's routes.

Slope-method NAND latency at every batch in BATCHES, for
SECURITY_128_BIT_FAST and the literal SECURITY_128_BIT, by route:

  auto            the production routing, standard key: the whole-rotation
                  kernel K1 (csrc/blind_rotate.cu);
  auto_mb         "auto" with the multi-bit key: the multi-bit kernel K4
                  (csrc/blind_rotate_mb.cu) up to
                  `ops.blind_rotate.mb_route_batch_cap`, K1 above it;
  fused_small_mb  the multi-bit key under step_impl="fused_small_mb": K4 at
                  every batch;
  pallas          the per-step route: K5 (csrc/external_product.cu), n0
                  launches a gate;
  xla             the plain PyTorch rotation on the card, no kernel.

The JAX script's fused_small, fused_tile and fused_wide are TPU schedules
the port does not have (`config._NOT_PORTED`); the artifact's note says so.
Timing (scripts/bench_latency_sweep.py:55-86): chains of SHORT = 2 and
LONG = 7 dependent NANDs, each output's parity + 1 folded into its body
before it feeds the next gate, each chain the minimum of REPEATS = 4 after a
warm call; ms a gate dispatch = (t_long - t_short) / 5. `config.step_impl`
is set for a row and restored after it. Keys: the secret key from key 42,
both cloud keys from 7; the bits from np.random.default_rng(1) per set,
one draw a batch in BATCHES order (a run of fewer batches skips rows, not
draws), encrypted with keys 3 and 4 (the second input the bits negated).
Every row
names the kernels its chains launched (K1, K4, K5; "plain" on the CPU
and on the xla route) and the share of its first gates that decrypt right.

    python scripts/torch/bench_latency_sweep.py                                   # both sets, every route
    python scripts/torch/bench_latency_sweep.py --fast-only --routes auto,auto_mb,fused_small_mb
    python scripts/torch/bench_latency_sweep.py --routes pallas,xla
    python scripts/torch/bench_latency_sweep.py --cpu --params TEST_TINY        # a CPU rehearsal

Merges its rows, keyed by (params, batch, impl), into
LATENCY_SWEEP_torch_h100.json at the repo root (--out; on the CPU only where
--out is given), each row with the card's name and power limit; the
routes' measurements are the H100's crossover data, and
`mb_route_batch_cap` stays the JAX package's. Without --cpu it runs on the
card and raises where there is none.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench_common import (  # noqa: E402
    ROOT, card_fields, chain, device_of, generator, launched_since, launches, load_json, log, min_time,
    params_by_name, route, write_json, xor_into_body,
)

from rs_tfhe_tpu_torch import gates  # noqa: E402
from rs_tfhe_tpu_torch.key import CloudKey, SecretKey  # noqa: E402
from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_bool, lwe_encrypt_bool  # noqa: E402

OUT = os.path.join(ROOT, "LATENCY_SWEEP_torch_h100.json")
SHORT, LONG, REPEATS = 2, 7, 4
BATCHES = [1, 2, 4, 8, 16, 32, 64, 128]
SETS = ["SECURITY_128_BIT_FAST", "SECURITY_128_BIT"]
#: route -> (step_impl, takes the multi-bit key)
ROUTES = {
    "auto": ("auto", False),
    "auto_mb": ("auto", True),
    "fused_small_mb": ("fused_small_mb", True),
    "pallas": ("pallas", False),
    "xla": ("xla", False),
}
NOTE = ("the JAX sweep's fused_small, fused_tile and fused_wide are TPU schedules with no counterpart in the "
        "port (config._NOT_PORTED); its auto, auto_mb and fused_small_mb rows compare with the rows of the same "
        "name here, which run the port's kernels")


def fold(out, cur):
    """The next chain input: the gate's output with its parity + 1 added to
    the body, beside the same second input (scripts/bench_latency_sweep.py:64-66)."""
    return xor_into_body(out, (out, cur[1]))


def slope_ms(a, b, ck, impl: str) -> tuple[float, dict]:
    """ms a gate at this batch via the chain-length slope under a forced
    step_impl, and the kernels its chains launched."""
    def run(n):
        return lambda: chain(lambda x, y: gates.nand(x, y, ck), (a, b), n, fold)

    before = launches()
    with route(impl):
        t_long = min_time(run(LONG), REPEATS)
        t_short = min_time(run(SHORT), REPEATS)
    return (t_long - t_short) / (LONG - SHORT) * 1e3, launched_since(before)


def sweep(device, sets=SETS, routes=tuple(ROUTES), batches=BATCHES) -> list:
    """The rows of every (set, batch, route) asked for, each gate of its
    first chain decrypted against numpy first."""
    rows = []
    for pname in sets:
        p = params_by_name(pname)
        sk = SecretKey.generate(p, generator(device, 42))
        ck = CloudKey.generate(sk, generator(device, 7))
        ck_mb = CloudKey.generate(sk, generator(device, 7), multibit=True)
        rng = np.random.default_rng(1)
        for batch in BATCHES:
            bits = rng.integers(0, 2, batch).astype(bool)
            if batch not in batches:
                continue
            a = lwe_encrypt_bool(generator(device, 3), sk.lv0, bits, p.tlwe_lv0.alpha)
            b = lwe_encrypt_bool(generator(device, 4), sk.lv0, ~bits, p.tlwe_lv0.alpha)
            for name in routes:
                impl, multibit = ROUTES[name]
                key = ck_mb if multibit else ck
                with route(impl):
                    out = gates.nand(a, b, key)
                correct = float((lwe_decrypt_bool(out, sk.lv0).cpu().numpy() == ~(bits & ~bits)).mean())
                t0 = time.perf_counter()
                ms, kernels = slope_ms(a, b, key, impl)
                row = {"params": pname, "batch": batch, "impl": name, "ms_per_gate_dispatch": round(ms, 3),
                       "gates_per_s": round(batch / ms * 1e3, 1), "kernels": kernels or "plain",
                       "correctness": correct}
                rows.append(row)
                log(f"  {pname} B={batch:<4} {name:<15} {ms:8.2f} ms ({batch / ms * 1e3:8.1f} gates/s) "
                    f"kernels {row['kernels']}, correctness {correct} [wall {time.perf_counter() - t0:.0f}s]")
    return rows


def merge(path: str, rows: list, fields: dict) -> dict:
    """Put `rows` into the artifact at `path`, replacing a row of the same
    (params, batch, impl), in (set, batch, route) order, each row with this
    call's card, and write it back."""
    art = load_json(path)
    stamp = {"device": fields["device"], "power_limit": fields["power_limit"], "ts": time.time()}
    by_key = {(r["params"], r["batch"], r["impl"]): r for r in art.get("rows", [])}
    by_key.update({(r["params"], r["batch"], r["impl"]): {**r, **stamp} for r in rows})
    order = {name: i for i, name in enumerate(SETS)}
    routes = list(ROUTES)
    art.update(fields, short=SHORT, long=LONG, repeats=REPEATS, note=NOTE, rows=[
        by_key[k] for k in sorted(by_key, key=lambda k: (order.get(k[0], len(SETS)), k[1], routes.index(k[2])))])
    write_json(path, art)
    return art


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--fast-only", action="store_true", help="SECURITY_128_BIT_FAST alone")
    ap.add_argument("--routes", help=f"comma-separated routes of {list(ROUTES)} (default: all)")
    ap.add_argument("--params", help="one set instead (TEST_TINY for a rehearsal)")
    ap.add_argument("--out", help="the artifact (default: LATENCY_SWEEP_torch_h100.json at the repo root on the card)")
    args = ap.parse_args(argv)
    device = device_of(args.cpu)
    sets = [args.params] if args.params else SETS[:1] if args.fast_only else SETS
    routes = args.routes.split(",") if args.routes else list(ROUTES)
    unknown = set(routes) - set(ROUTES)
    if unknown:
        raise ValueError(f"unknown routes {sorted(unknown)}; the port has {list(ROUTES)}")
    fields = card_fields(device)
    log(f"device: {fields['device']}, power limit {fields['power_limit']}")
    rows = sweep(device, sets, routes)
    out = args.out or (OUT if device.type == "cuda" else None)
    if out:
        merge(out, rows, fields)
        log(f"merged {len(rows)} rows into {out}")
    print(json.dumps({**fields, "short": SHORT, "long": LONG, "rows": rows}), flush=True)
    print("SWEEP-OK", out or "(not written)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
