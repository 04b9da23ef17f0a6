"""Direct measurement of the multi-bit bootstrap's output noise with the
PyTorch port on the card: the counterpart of scripts/measure_mb_noise.py.

K independent B=2 NAND bootstraps with a multi-bit key, the batch "auto"
sends to the multi-bit rotation (csrc/blind_rotate_mb.cu on the card), plus
the standard-key path at K/4 (at least 128) as a control; the LWE phase
noise of the outputs against the expected +/-1/8 plateau
(`utils.noise.measure_phase_noise`) beside the model's std
(`utils.noise.estimate`, mb_group=2 or 1), with the JAX script's row fields
and measured-margin formula. The JAX script batches the K gates with
`lax.scan`; here they run in an eager loop, each at batch 2, so the route is
the same.

    python scripts/torch/measure_mb_noise.py            # FAST and strict, K = 2048, on the card
    python scripts/torch/measure_mb_noise.py --quick    # FAST only, K = 256
    python scripts/torch/measure_mb_noise.py --cpu --params TEST_TINY --quick --out noise_cpu.json
    # (a rehearsal of the flow: TEST_TINY's noise sits below the model's range, ratio ~0.5)

Keys and encryptions come from torch generators seeded where the JAX script
seeds `jax.random.key` (42 the secret key, 7 both cloud keys, 11 and 12 the
encryptions); the plaintext bits from a numpy generator seeded by the set's
name and the key kind (the JAX script's `hash()` of them varies between
processes). Writes MB_NOISE_torch_h100.json at the repo root (or --out) with
the card's name and power limit; fails unless every multi-bit ratio of
measured to model std lies in [0.5, 1.15] and every gate decrypts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import zlib

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from soak import ROOT, card, generator  # noqa: E402  (scripts/torch/soak.py)

import rs_tfhe_tpu_torch as tfhe  # noqa: E402
from rs_tfhe_tpu_torch import gates  # noqa: E402
from rs_tfhe_tpu_torch.key import CloudKey, SecretKey  # noqa: E402
from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_bool, lwe_encrypt_bool  # noqa: E402
from rs_tfhe_tpu_torch.torus import f64_to_torus, resolve_device  # noqa: E402
from rs_tfhe_tpu_torch.utils.noise import estimate, measure_phase_noise  # noqa: E402

OUT = os.path.join(ROOT, "MB_NOISE_torch_h100.json")
RATIO_RANGE = (0.5, 1.15)


def measure_set(pname: str, k_iters: int, multibit: bool, sk, ck, inputs=None) -> tuple[dict, np.ndarray]:
    """K independent B=2 NANDs: (the JAX script's row, the noise array).

    inputs: None, or (a_bits, b_bits, a, b) with bits bool [K, 2] and their
    ciphertexts int32 [K, 2, n0+1] on the keys' device (the CPU test hands
    in the JAX script's)."""
    p = sk.params
    device = sk.lv0.device
    if inputs is None:
        rng = np.random.default_rng(zlib.crc32(f"{pname}/{multibit}".encode()))
        a_bits = rng.integers(0, 2, (k_iters, 2)).astype(bool)
        b_bits = rng.integers(0, 2, (k_iters, 2)).astype(bool)
        a = lwe_encrypt_bool(generator(device, 11), sk.lv0, a_bits, p.tlwe_lv0.alpha)
        b = lwe_encrypt_bool(generator(device, 12), sk.lv0, b_bits, p.tlwe_lv0.alpha)
    else:
        a_bits, b_bits, a, b = inputs

    t0 = time.perf_counter()
    outs = torch.stack([gates.nand(a[k], b[k], ck) for k in range(a.shape[0])]).reshape(-1, p.n0 + 1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    want = ~(a_bits & b_bits)  # NAND truth
    mu = int(f64_to_torus(0.125))
    mu_all = np.where(want.reshape(-1), np.uint32(mu), np.uint32((1 << 32) - mu))
    noise = measure_phase_noise(outs, sk.lv0, mu_all)
    dec = lwe_decrypt_bool(outs, sk.lv0).cpu().numpy()
    errors = int((dec != want.reshape(-1)).sum())

    est = estimate(p, mb_group=2 if multibit else 1)
    meas_std = float(noise.std())
    model_std = est.bootstrap_out_std
    margin_meas = (1.0 / 16.0) / float(
        np.sqrt(2 * meas_std**2 + (p.n0 + 1) * (1.0 / (2.0 * p.n1)) ** 2 / 12.0))
    row = {
        "params": pname,
        "multibit": multibit,
        "samples": int(noise.size),
        "gate_errors": errors,
        "measured_std": meas_std,
        "model_std": model_std,
        "ratio": meas_std / model_std,
        "abs_max": float(np.abs(noise).max()),
        "gate_margin_sigmas_measured": margin_meas,
        "wall_s": wall,
    }
    print(f"  {pname} mb={multibit}: std {meas_std:.3e} vs model {model_std:.3e} (ratio {row['ratio']:.2f}), "
          f"|max| {row['abs_max']:.3e}, errors {errors}/{noise.size}, "
          f"measured gate margin {margin_meas:.1f} sigma  [{wall:.1f}s]", flush=True)
    return row, noise


def measure(sets, k_iters: int, device) -> list:
    """The multi-bit rows and their standard-key controls, set by set."""
    rows = []
    for pname in sets:
        p = tfhe.TEST_TINY if pname == "TEST_TINY" else tfhe.ALL_SECURITY_SETS[pname]
        sk = SecretKey.generate(p, generator(device, 42))
        ck_mb = CloudKey.generate(sk, generator(device, 7), multibit=True)
        rows.append(measure_set(pname, k_iters, True, sk, ck_mb)[0])
        del ck_mb
        # control: the same harness through the standard rotation
        ck = CloudKey.generate(sk, generator(device, 7))
        rows.append(measure_set(pname, max(k_iters // 4, 128), False, sk, ck)[0])
    return rows


def check(rows) -> None:
    for r in rows:
        if r["gate_errors"]:
            raise AssertionError(f"{r['params']} mb={r['multibit']}: {r['gate_errors']} gates decrypted wrong")
        if r["multibit"] and not RATIO_RANGE[0] <= r["ratio"] <= RATIO_RANGE[1]:
            raise AssertionError(
                f"mb measured/model std ratio {r['ratio']:.2f} out of {list(RATIO_RANGE)}: the model must be "
                "conservative but not wildly so")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true", help="FAST only, K = 256")
    ap.add_argument("--params", choices=["TEST_TINY", *tfhe.ALL_SECURITY_SETS],
                    help="measure this set instead (a rehearsal with --cpu at TEST_TINY)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    k_iters = 256 if args.quick else 2048  # x2 samples per iteration (B=2)
    sets = [args.params] if args.params else (
        ["SECURITY_128_BIT_FAST"] if args.quick else ["SECURITY_128_BIT_FAST", "SECURITY_128_BIT"])
    name, limit = card(device)
    print(f"device: {name}, power limit {limit}; iters/set: {k_iters}", flush=True)
    rows = measure(sets, k_iters, device)
    out = {"device": name, "power_limit": limit, "rows": rows}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    check(rows)
    print("MB-NOISE-OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
