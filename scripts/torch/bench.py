"""Headline benchmark of the PyTorch port on the card: the counterpart of
the root bench.py, with its definitions, environment variables and line.

Batched NAND gates/s (each gate one full bootstrap: blind rotation, sample
extract, key switch) at SECURITY_128_BIT_FAST, and the same at the literal
SECURITY_128_BIT under "strict_*" keys, each with its B = 1 latency and,
where the set allows the multi-bit key, the multi-bit B = 1 latency. Per
set (`measure`):

  keygen warm   the second CloudKey.generate, timed to a scalar read of its
                key-switching and bootstrapping keys (bench.py:180-184);
  gates/s       one checked NAND batch (decrypted against numpy; the untimed
                first call, which also builds the kernels), then `iters`
                chained NANDs, each taking the previous output, ended by a
                scalar read: batch / time a gate (bench.py:186-212);
  latency       at B = 1, the slope (t25 - t5) / 20 between chains of 5 and
                25 dependent NANDs, each chain's time the minimum of 4
                repeats after a warm call (bench.py:214-244);
  multi-bit     a key with multibit=True (an even n0; RS_TFHE_BENCH_MB=0
                skips it), one checked B = 1 gate, then the same slope
                (bench.py:253-266): the multi-bit kernel, as "auto" sends
                B = 1 there.

The chains are eager loops on the card's stream in place of bench.py's
jitted ones; the JAX script's prewarm subprocess and compile cache have no
counterpart (the first call builds the kernels). Keys and encryptions come
from torch generators seeded where bench.py seeds jax.random.key (42 the
secret key, 7 and 8 the cloud keys, 3 the encryptions), the bits from
np.random.default_rng(0).

    python scripts/torch/bench.py                    # FAST then strict, B = 4096, on the card
    RS_TFHE_BENCH_PARAMS=SECURITY_128_BIT python scripts/torch/bench.py   # one set, no strict pass
    RS_TFHE_BENCH_PARAMS=TEST_TINY RS_TFHE_BENCH_BATCH=8 python scripts/torch/bench.py --cpu   # a CPU rehearsal

Environment, as bench.py: RS_TFHE_BENCH_BATCH (4096), RS_TFHE_BENCH_ITERS
(5), RS_TFHE_BENCH_PARAMS (SECURITY_128_BIT_FAST, or TEST_TINY for a
rehearsal; setting it skips the strict pass), RS_TFHE_BENCH_STRICT=0 skips it too, RS_TFHE_BENCH_MB=0 skips
the multi-bit passes. Prints bench.py's one JSON line (the fields of
BENCH_r05.json "parsed"; "correctness" and "strict_correctness" only below
1.0, "mb_correct" only when false) on stdout, logs on stderr which kernel
each pass launched, and writes the line with the card's name and power
limit to BENCH_torch_h100.json at the repo root (--out; on the CPU only
where --out is given). Without --cpu it runs on the card and raises where
there is none.
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
    ROOT, barrier, card_fields, chain, device_of, generator, launched_since, launches, log, min_time,
    params_by_name, write_json,
)

from rs_tfhe_tpu_torch.gates import batch_gate  # noqa: E402
from rs_tfhe_tpu_torch.key import CloudKey, SecretKey  # noqa: E402
from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_bool, lwe_encrypt_bool  # noqa: E402

OUT = os.path.join(ROOT, "BENCH_torch_h100.json")
BASELINE_GATES_PER_SEC = 1000.0 / 15.0  # the reference's ~15 ms a gate (bench.py:48)
N_SHORT, N_LONG, REPEATS = 5, 25, 4


def mb_enabled(params) -> bool:
    """The multi-bit latency pass: an even n0 (the pairs of the multi-bit
    key), unless RS_TFHE_BENCH_MB=0. bench.py:156-165 also asks for its TPU
    kernel's eligibility, which every security set meets."""
    return os.environ.get("RS_TFHE_BENCH_MB", "1") == "1" and params.n0 % 2 == 0


def _chain_slope(a1, b1, key) -> float:
    """B = 1 latency in ms: (t_long - t_short) / (long - short) over chains
    of dependent NANDs (bench.py:234-242)."""
    def run(n):
        return lambda: chain(lambda x, y: batch_gate("nand", x, y, key), (a1, b1), n,
                             lambda out, cur: (out, cur[1]))

    t_short, t_long = min_time(run(N_SHORT), REPEATS), min_time(run(N_LONG), REPEATS)
    ms = (t_long - t_short) / (N_LONG - N_SHORT) * 1e3
    log(f"single-gate latency: {ms:.1f} ms (chains {N_SHORT}/{N_LONG}: {t_short * 1e3:.1f}/{t_long * 1e3:.1f} ms)")
    return ms


def measure(pname: str, batch: int, iters: int, device) -> dict:
    """Keygen, batched NAND throughput and B = 1 latency at one set
    (bench.py:168-267). Returns bench.py's per-set fields, and under
    "kernels" the launches of each pass."""
    params = params_by_name(pname)
    log(f"--- params={pname} batch={batch} iters={iters} device={device}")
    t0 = time.perf_counter()
    sk = SecretKey.generate(params, generator(device, 42))
    ck = CloudKey.generate(sk, generator(device, 7))
    barrier(ck.ksk_limbs), barrier(ck.bsk)
    log(f"keygen (first): {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    ck = CloudKey.generate(sk, generator(device, 8))
    barrier(ck.ksk_limbs), barrier(ck.bsk)
    keygen_warm = time.perf_counter() - t0
    log(f"keygen warm: {keygen_warm * 1e3:.0f} ms")

    rng = np.random.default_rng(0)
    bits_a = rng.integers(0, 2, batch).astype(bool)
    bits_b = rng.integers(0, 2, batch).astype(bool)
    g = generator(device, 3)
    a = lwe_encrypt_bool(g, sk.lv0, bits_a, params.tlwe_lv0.alpha)
    b = lwe_encrypt_bool(g, sk.lv0, bits_b, params.tlwe_lv0.alpha)

    kernels = {}
    before = launches()
    t0 = time.perf_counter()
    out = batch_gate("nand", a, b, ck)
    barrier(out)
    log(f"first call (kernel build + run): {time.perf_counter() - t0:.2f}s")
    dec = lwe_decrypt_bool(out, sk.lv0).cpu().numpy()
    correct = float((dec == ~(bits_a & bits_b)).mean())
    log(f"correctness: {correct:.4f}")

    t0 = time.perf_counter()
    barrier(chain(lambda x, y: batch_gate("nand", x, y, ck), (a, b), iters, lambda out, cur: (out, cur[1])))
    per_iter = (time.perf_counter() - t0) / iters
    kernels["batch"] = launched_since(before)
    log(f"{iters} chained iters: {per_iter * 1e3:.1f} ms each; kernels {kernels['batch']}")

    a1, b1 = a[:1], b[:1]
    before = launches()
    latency_ms = _chain_slope(a1, b1, ck)
    kernels["b1"] = launched_since(before)
    log(f"B=1 kernels {kernels['b1']}")
    res = {
        "gates_per_sec": round(batch / per_iter, 2),
        "latency_ms_b1": round(latency_ms, 2),
        "keygen_warm_ms": round(keygen_warm * 1e3, 1),
        "correctness": correct,
    }
    if mb_enabled(params):
        ck_mb = CloudKey.generate(sk, generator(device, 7), multibit=True)
        barrier(ck_mb.bsk_mb)
        before = launches()
        out_mb = batch_gate("nand", a1, b1, ck_mb)
        ok = bool(lwe_decrypt_bool(out_mb, sk.lv0).cpu().numpy()[0] == ~(bits_a[0] & bits_b[0]))
        log(f"mb gate correct: {ok}")
        res["latency_ms_b1_mb"] = round(_chain_slope(a1, b1, ck_mb), 2)
        kernels["b1_mb"] = launched_since(before)
        log(f"B=1 multi-bit kernels {kernels['b1_mb']}")
        if not ok:
            res["mb_correct"] = False
    res["kernels"] = kernels
    return res


def bench_line(pname: str, main_res: dict, strict: dict | None) -> dict:
    """bench.py's JSON line (bench.py:293-319) from the headline set's
    `measure` and, when the strict pass ran, SECURITY_128_BIT's."""
    result = {
        "metric": "gate_bootstraps_per_sec",
        "value": main_res["gates_per_sec"],
        "unit": "gates/s",
        "vs_baseline": round(main_res["gates_per_sec"] / BASELINE_GATES_PER_SEC, 2),
        "params": pname,
        "latency_ms_b1": main_res["latency_ms_b1"],
        "keygen_warm_ms": main_res["keygen_warm_ms"],
    }
    if "latency_ms_b1_mb" in main_res:
        result["latency_ms_b1_mb"] = main_res["latency_ms_b1_mb"]
    if main_res["correctness"] < 1.0:
        result["correctness"] = main_res["correctness"]
    if strict is not None:
        result["strict_params"] = "SECURITY_128_BIT"
        result["strict_gates_per_sec"] = strict["gates_per_sec"]
        result["strict_latency_ms_b1"] = strict["latency_ms_b1"]
        if "latency_ms_b1_mb" in strict:
            result["strict_latency_ms_b1_mb"] = strict["latency_ms_b1_mb"]
        result["strict_vs_baseline"] = round(strict["gates_per_sec"] / BASELINE_GATES_PER_SEC, 2)
        if strict["correctness"] < 1.0:
            result["strict_correctness"] = strict["correctness"]
    if any("mb_correct" in r for r in (main_res, strict or {})):
        result["mb_correct"] = False  # a multi-bit pass's checked gate decrypted wrong
    return result


def run(device) -> dict:
    """bench.py's main without its output: the headline set's pass and,
    unless RS_TFHE_BENCH_PARAMS is set or RS_TFHE_BENCH_STRICT is 0, the
    strict pass. Returns {"line", "batch", "iters", "passes"}."""
    batch = int(os.environ.get("RS_TFHE_BENCH_BATCH", "4096"))
    iters = int(os.environ.get("RS_TFHE_BENCH_ITERS", "5"))
    pname = os.environ.get("RS_TFHE_BENCH_PARAMS")
    run_strict = pname is None and os.environ.get("RS_TFHE_BENCH_STRICT", "1") == "1"
    pname = pname or "SECURITY_128_BIT_FAST"
    passes = {pname: measure(pname, batch, iters, device)}
    strict = None
    if run_strict:
        strict = passes["SECURITY_128_BIT"] = measure("SECURITY_128_BIT", batch, iters, device)
    return {"line": bench_line(pname, passes[pname], strict), "batch": batch, "iters": iters, "passes": passes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--out", help="the artifact (default: BENCH_torch_h100.json at the repo root on the card)")
    args = ap.parse_args(argv)
    device = device_of(args.cpu)
    res = run(device)
    fields = card_fields(device)
    log(f"device: {fields['device']}, power limit {fields['power_limit']}")
    out = args.out or (OUT if device.type == "cuda" else None)
    if out:
        write_json(out, {**fields, "ts": time.time(), **res})
    print(json.dumps(res["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
