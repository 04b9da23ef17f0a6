"""Reliability soak of the PyTorch port on the card: the counterpart of
scripts/soak.py, with its phases, sizes and seeds.

Four phases, each decrypting every gate's or add's output and comparing it
with the bits tracked in numpy:

  fast     SECURITY_128_BIT_FAST, B = 4096: LAYERS = 8 chained layers of
           gates.nand / gates.xor a dispatch, every output feeding the next
           layer, so each bootstrap absorbs accumulated, not fresh, noise;
  strict   SECURITY_128_BIT, B = 4096, the same chain;
  nibble   models.arithmetic.add_radix at SECURITY_128_BIT_NIBBLE, base 4,
           2 digits, B = 256 (3 PBS an add, standard key);
  fast_mb  FAST with a multi-bit key at B = 2, the batch "auto" sends to the
           multi-bit rotation (csrc/blind_rotate_mb.cu on the card).

Spot checks hold the route the phase runs against the plain PyTorch version
on the same device, bit for bit: a fault that flips no decryption (a low bit
of a rotation, a race in a cluster exchange) still breaks that equality.
With a standard key, one gate layer is run again on the first SPOT_ROWS rows
under step_impl="xla" (`ops.blind_rotate.blind_rotate_plain`); a rotation is
independent for each ciphertext, so the rows of a slice are a fair sample.
With a multi-bit key, "xla" would take the standard rotation, another
function, so the multi-bit rotations of one layer are recorded and each is
held against `blind_rotate_mb_plain` on its own input. At NIBBLE, the add
is run again on NIBBLE_SPOT_VALUES values under "xla". A check runs at the
first dispatch and then at every N-th, N set from the first dispatch's times
so that the checks cost about SPOT_SHARE of the phase. A differing row
(ciphertext) counts as a mismatch; a mismatch fails the phase as a
decryption error does, and the phase stops at the first dispatch with
either.

Keys and encryptions come from torch generators seeded where the JAX script
seeds `jax.random.key` (key0 100, 120, 110/111, 140; the multi-bit phase's
chunk k uses key0 140 + 4k), plaintext bits from np.random.default_rng(1)
and (2) (chunk k of the multi-bit phase: default_rng([1, k])). One untimed
warm-up layer (an add of NIBBLE_SPOT_VALUES values at NIBBLE) builds the
kernels first; `seconds` is the wall time of the counted dispatches,
decryption and spot checks included.

    python scripts/torch/soak.py                          # all four phases on the card, the JAX r05 counts
    python scripts/torch/soak.py --phase fast             # one phase; --target or RS_TFHE_SOAK_GATES
    python scripts/torch/soak.py --phase fast_mb --chunk 1 --target 5e5
    python scripts/torch/soak.py --cpu --params TEST_TINY --phase fast --target 1e5 --out soak_cpu.json

Targets: --target, else the JAX script's variables RS_TFHE_SOAK_GATES (fast),
RS_TFHE_SOAK_STRICT_GATES, RS_TFHE_SOAK_ADDS and RS_TFHE_SOAK_MB_GATES, else
10^7, 10^7, 10^4 and 10^6. Without --cpu the script runs on the CUDA card and
raises where there is none. Each run merges its rows into --out
(SOAK_torch_h100.json at the repo root, a name apart from the JAX
artifacts' SOAK_r*.json); the multi-bit phase's chunks add up there, each
listed. Every row is also printed as one JSON line. Exit code 1 on any
error or mismatch.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import rs_tfhe_tpu_torch as tfhe  # noqa: E402
from rs_tfhe_tpu_torch import config, gates  # noqa: E402
from rs_tfhe_tpu_torch.key import CloudKey, SecretKey  # noqa: E402
from rs_tfhe_tpu_torch.models import arithmetic  # noqa: E402
from rs_tfhe_tpu_torch.ops import blind_rotate as br  # noqa: E402
from rs_tfhe_tpu_torch.ops import cuda_blind_rotate_mb  # noqa: E402
from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_bool, lwe_encrypt_bool  # noqa: E402
from rs_tfhe_tpu_torch.torus import resolve_device  # noqa: E402

OUT = os.path.join(ROOT, "SOAK_torch_h100.json")

BATCH = 4096
LAYERS = 8  # gate layers a dispatch, decrypted together
NIBBLE_BATCH = 256
SPOT_ROWS = 64
NIBBLE_SPOT_VALUES = 4
SPOT_SHARE = 0.02

#: --phase -> (parameter set, key0, multibit, batch, target variable, default target)
PHASES = {
    "fast": ("SECURITY_128_BIT_FAST", 100, False, BATCH, "RS_TFHE_SOAK_GATES", 1e7),
    "strict": ("SECURITY_128_BIT", 120, False, BATCH, "RS_TFHE_SOAK_STRICT_GATES", 1e7),
    "nibble": ("SECURITY_128_BIT_NIBBLE", 110, False, NIBBLE_BATCH, "RS_TFHE_SOAK_ADDS", 1e4),
    "fast_mb": ("SECURITY_128_BIT_FAST", 140, True, 2, "RS_TFHE_SOAK_MB_GATES", 1e6),
}

#: the plain multi-bit rotation, bound here so that a spot check's reference
#: is never the route it checks
_MB_PLAIN = br.blind_rotate_mb_plain


def params_name(p) -> str:
    names = {v: k for k, v in tfhe.ALL_SECURITY_SETS.items()}
    return names.get(p) or ("TEST_TINY" if p == tfhe.TEST_TINY else p.description)


def card(device: torch.device) -> tuple[str, str | None]:
    """(name, power limit) of the card as `nvidia-smi --query-gpu=name,power.limit`
    gives them; ("cpu", None) on the CPU."""
    if device.type != "cuda":
        return "cpu", None
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[device.index or 0]
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return name, limit


def generator(device: torch.device, seed: int) -> torch.Generator:
    """The counterpart of the JAX script's `jax.random.key(seed)`."""
    return torch.Generator(device=device).manual_seed(seed)


def decrypt_bits(ct: torch.Tensor, sk_lv0: torch.Tensor) -> torch.Tensor:
    """Decrypted booleans, on the ciphertexts' device."""
    return lwe_decrypt_bool(ct, sk_lv0)


@contextlib.contextmanager
def route(step_impl: str):
    """config.step_impl set for the block, restored after it."""
    saved = config.config.step_impl
    config.config.step_impl = step_impl
    try:
        yield
    finally:
        config.config.step_impl = saved


@contextlib.contextmanager
def recorded_mb_rotations(device: torch.device):
    """Record (arguments, output) of every multi-bit rotation the route runs
    in the block: the kernel's wrapper on the card, the plain version on the
    CPU, the function `ops.blind_rotate.blind_rotate` calls there."""
    module, name = (cuda_blind_rotate_mb, "blind_rotate_mb_kernel") if device.type == "cuda" else (
        br, "blind_rotate_mb_plain")
    fn, calls = getattr(module, name), []

    def record(*args):
        out = fn(*args)
        calls.append((args, out))
        return out

    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def _differing_rows(out: torch.Tensor, ref: torch.Tensor) -> int:
    """Rows (ciphertexts) of `out` that differ from `ref` in any word."""
    return int((out != ref).reshape(out.shape[0], -1).any(dim=1).sum())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def layer(a, b, ck):
    """One step of the chain, a NAND and an XOR of the same inputs:
    (nand(a, b), xor(a, b)); LAYERS // 2 steps make a dispatch, LAYERS gates
    a row."""
    return gates.nand(a, b, ck), gates.xor(a, b, ck)


def _checked_layer(a, b, ck, device) -> tuple:
    """One gate layer and its spot check: (nand, xor, mismatching rows,
    seconds of the check)."""
    if ck.bsk_mb is not None:
        with recorded_mb_rotations(device) as calls:
            na, nb = layer(a, b, ck)
        _sync(device)  # the check's time starts when the layer's is over
        t0 = time.perf_counter()
        if not calls:
            raise RuntimeError("spot check: the layer ran no multi-bit rotation")
        mismatches = sum(_differing_rows(out, _MB_PLAIN(*args)) for args, out in calls)
    else:
        na, nb = layer(a, b, ck)
        _sync(device)
        t0 = time.perf_counter()
        with route("xla"):
            ra, rb = layer(a[:SPOT_ROWS], b[:SPOT_ROWS], ck)
        mismatches = _differing_rows(na[:SPOT_ROWS], ra) + _differing_rows(nb[:SPOT_ROWS], rb)
    _sync(device)
    return na, nb, mismatches, time.perf_counter() - t0


def _drive(step, target: int) -> dict:
    """Run `step(spot) -> (units, errors, mismatches, check seconds)` until
    `target` units are done or a step saw an error or a mismatch. A spot
    check runs at the first step and then at every N-th, N = the check's
    time over SPOT_SHARE of the first step's time without it."""
    done = errors = mismatches = checks = 0
    every, i = 1, 0
    t0 = time.perf_counter()
    while done < target and not (errors or mismatches):
        spot = i % every == 0
        t_step = time.perf_counter()
        units, err, mis, check_s = step(spot)
        if i == 0:
            rest = time.perf_counter() - t_step - check_s
            every = max(1, math.ceil(check_s / (SPOT_SHARE * max(rest, 1e-9))))
        done, errors, mismatches, checks = done + units, errors + err, mismatches + mis, checks + spot
        i += 1
    seconds = time.perf_counter() - t0
    return {"done": done, "errors": errors, "mismatches": mismatches, "spot_checks": checks,
            "spot_every": every, "seconds": seconds}


def _port_fields(device, res) -> dict:
    name, limit = card(device)
    return {"device": name, "power_limit": limit, "spot_checks": res["spot_checks"],
            "spot_every": res["spot_every"], "mismatches": res["mismatches"]}


def soak_gates(params, target_gates: int, key0: int = 100, batch: int = BATCH, multibit: bool = False,
               device=None, chunk: int = 0) -> dict:
    """Chained NAND/XOR layers on `batch` ciphertexts until `target_gates`
    gates (whole dispatches of LAYERS layers), every output decrypted and
    spot-checked as the module docstring says. `chunk` k > 0 seeds the keys
    and encryptions from key0 + 4k and the bits from default_rng([1, k]).
    Returns the phase's row."""
    device = resolve_device(device)
    seed = key0 + 4 * chunk
    sk = SecretKey.generate(params, generator(device, seed))
    ck = CloudKey.generate(sk, generator(device, seed + 1), multibit=multibit)
    rng = np.random.default_rng([1, chunk] if chunk else 1)
    bits = [rng.integers(0, 2, batch).astype(bool) for _ in range(2)]
    a = lwe_encrypt_bool(generator(device, seed + 2), sk.lv0, bits[0], params.tlwe_lv0.alpha)
    b = lwe_encrypt_bool(generator(device, seed + 3), sk.lv0, bits[1], params.tlwe_lv0.alpha)
    layer(a, b, ck)  # warm-up: builds the kernels, not counted
    _sync(device)
    state = [a, b, *bits]

    def step(spot):
        a, b, a_bits, b_bits = state
        want, got, mismatches, check_s = [], [], 0, 0.0
        for k in range(LAYERS // 2):
            if spot and k == 0:
                a, b, mismatches, check_s = _checked_layer(a, b, ck, device)
            else:
                a, b = layer(a, b, ck)
            a_bits, b_bits = ~(a_bits & b_bits), a_bits ^ b_bits
            got += [decrypt_bits(a, sk.lv0), decrypt_bits(b, sk.lv0)]
            want += [a_bits, b_bits]
        state[:] = a, b, a_bits, b_bits
        errors = int((torch.stack(got).cpu().numpy() != np.stack(want)).sum())
        return LAYERS * batch, errors, mismatches, check_s

    res = _drive(step, target_gates)
    gates_done = res["done"]
    row = {
        "params": params_name(params),
        "multibit": multibit,
        "batch": batch,
        "gates": gates_done,
        "errors": res["errors"],
        "seconds": res["seconds"],
        "gates_per_s": gates_done / res["seconds"],
        "p_fail_upper_95": 3.0 / gates_done if res["errors"] == 0 else res["errors"] / gates_done,
        **_port_fields(device, res),
        "key0": seed,
    }
    if multibit:
        row["chunk"] = chunk
    return row


def soak_nibble(params, target_adds: int, key0: int = 110, batch: int = NIBBLE_BATCH, device=None) -> dict:
    """add_radix at base 4, 2 digits, on `batch` fresh pairs a dispatch until
    `target_adds` adds, every sum decrypted; the first NIBBLE_SPOT_VALUES
    values of a checked dispatch are added again under "xla" and compared
    ciphertext for ciphertext. `params` must give base-16 LUTs their margins
    (SECURITY_128_BIT_NIBBLE; the N=512 test set on the CPU)."""
    device = resolve_device(device)
    sk = SecretKey.generate(params, generator(device, key0))
    ck = CloudKey.generate(sk, generator(device, key0 + 1))
    rng = np.random.default_rng(2)
    enc_seed = [key0 + 2]

    def encrypt(vals):
        ct = arithmetic.encrypt_radix(generator(device, enc_seed[0]), sk.lv0, vals, 2, params, base_bits=4)
        enc_seed[0] += 1
        return ct

    warm = arithmetic.encrypt_radix(generator(device, 0), sk.lv0, np.arange(NIBBLE_SPOT_VALUES), 2, params,
                                    base_bits=4)
    arithmetic.add_radix(warm, warm, ck, base_bits=4)  # warm-up: builds the kernels, not counted
    _sync(device)

    def step(spot):
        xs, ys = rng.integers(0, 256, batch), rng.integers(0, 256, batch)
        na, nb = encrypt(xs), encrypt(ys)
        nsum = arithmetic.add_radix(na, nb, ck, base_bits=4)  # 3 PBS an add
        mismatches, check_s = 0, 0.0
        if spot:
            _sync(device)
            t0 = time.perf_counter()
            k = NIBBLE_SPOT_VALUES
            with route("xla"):
                ref = arithmetic.add_radix(na[:k], nb[:k], ck, base_bits=4)
            mismatches = _differing_rows(nsum[:k], ref)
            _sync(device)
            check_s = time.perf_counter() - t0
        errors = int((arithmetic.decrypt_radix(nsum, sk.lv0, base_bits=4) != (xs + ys) % 256).sum())
        return batch, errors, mismatches, check_s

    res = _drive(step, target_adds)
    adds = res["done"]
    return {
        "params": params_name(params),
        "batch": batch,
        "adds": adds,
        "pbs": 3 * adds,
        "errors": res["errors"],
        "seconds": res["seconds"],
        "adds_per_s": adds / res["seconds"],
        "p_fail_per_pbs_upper_95": 3.0 / (3 * adds) if res["errors"] == 0 else res["errors"] / (3 * adds),
        **_port_fields(device, res),
        "key0": key0,
    }


def run_phase(phase: str, target: int, device=None, params=None, chunk: int = 0) -> dict:
    """One phase of PHASES at its set (or `params`), seeds and batch."""
    name, key0, multibit, batch, _, _ = PHASES[phase]
    p = params or tfhe.ALL_SECURITY_SETS[name]
    if phase == "nibble":
        return soak_nibble(p, target, key0, batch, device)
    return soak_gates(p, target, key0, batch, multibit, device, chunk if multibit else 0)


def _sum_chunks(chunks: list) -> dict:
    """The multi-bit phase's row over its chunks: counts and seconds add up."""
    row = {k: v for k, v in chunks[0].items() if k not in ("chunk", "key0")}
    for key in ("gates", "errors", "seconds", "spot_checks", "mismatches"):
        row[key] = sum(c[key] for c in chunks)
    row["gates_per_s"] = row["gates"] / row["seconds"]
    row["p_fail_upper_95"] = 3.0 / row["gates"] if row["errors"] == 0 else row["errors"] / row["gates"]
    row["spot_every"] = sorted({c["spot_every"] for c in chunks})
    row["chunks"] = chunks
    return row


def merge(path: str, phase: str, row: dict) -> dict:
    """Put `row` into the artifact at `path` under `phase` (a multi-bit
    chunk beside the chunks already there, replacing one of the same index)
    and write it back."""
    art = {}
    if os.path.exists(path):
        with open(path) as f:
            art = json.load(f)
    if phase == "fast_mb":
        chunks = {c["chunk"]: c for c in art.get(phase, {}).get("chunks", [])}
        chunks[row["chunk"]] = row
        row = _sum_chunks([chunks[k] for k in sorted(chunks)])
    art[phase] = row
    art["ts"] = time.time()
    with open(path, "w") as f:
        json.dump(art, f, indent=1)
    return art


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--phase", choices=list(PHASES), help="one phase (default: all four, in order)")
    ap.add_argument("--target", type=float, help="gates (adds at NIBBLE) of the phase")
    ap.add_argument("--chunk", type=int, default=0, help="the multi-bit phase's chunk: seeds key0 140 + 4k")
    ap.add_argument("--params", choices=["TEST_TINY", *tfhe.ALL_SECURITY_SETS],
                    help="run the phase at this set instead (a rehearsal with --cpu at TEST_TINY)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--out", default=OUT, help="the artifact the rows merge into")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    params = None if args.params is None else (
        tfhe.TEST_TINY if args.params == "TEST_TINY" else tfhe.ALL_SECURITY_SETS[args.params])
    name, limit = card(device)
    print(f"device: {name}, power limit {limit}", flush=True)
    ok = True
    for phase in [args.phase] if args.phase else list(PHASES):
        _, _, _, _, var, default = PHASES[phase]
        target = int(args.target if args.target is not None else float(os.environ.get(var, default)))
        print(f"soaking {phase}: {target:.0e} {'adds' if phase == 'nibble' else 'gates'} ...", flush=True)
        row = run_phase(phase, target, device, params, args.chunk)
        print(json.dumps({"phase": phase, **row}), flush=True)
        merge(args.out, phase, row)
        ok = ok and row["errors"] == 0 and row["mismatches"] == 0
    print(f"merged into {args.out}")
    print("SOAK", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
