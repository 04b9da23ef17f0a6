#!/usr/bin/env python3
"""Proxy re-encryption noise of the JAX package on the CPU.

Re-keys a batch of fresh boolean ciphertexts Alice -> Bob with a symmetric
and an asymmetric re-encryption key (`rs_tfhe_tpu.proxy_reenc`) and prints,
for each, Bob's decryption rate and the phase noise after re-encryption as
fractions of the torus: its mean (a fixed re-key's row noises give every
ciphertext the same offset), std and max, and the margin 1/8 less the mean
in stds; so the port's numbers on the card (`chip_smoke.py` phase 15) can be
read beside the reference's. Usage:

    JAX_PLATFORMS=cpu python scripts/proxy_reenc_noise.py [--params SECURITY_128_BIT_FAST] \
        [--batch 512] [--seed 0] [--basebit B --t T]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rs_tfhe_tpu import params as P  # noqa: E402
from rs_tfhe_tpu import proxy_reenc as pre  # noqa: E402
from rs_tfhe_tpu import tlwe  # noqa: E402
from rs_tfhe_tpu.key import SecretKey  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--params", default="SECURITY_128_BIT_FAST", choices=sorted(P.ALL_SECURITY_SETS))
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--basebit", type=int, default=None, help="re-key digit width (default: the set's KSK's)")
    ap.add_argument("--t", type=int, default=None, help="re-key digits a coefficient (default: the set's)")
    args = ap.parse_args()
    dec = {"basebit": args.basebit, "t": args.t}
    p = P.ALL_SECURITY_SETS[args.params]
    t0 = time.perf_counter()
    alice = SecretKey.generate(jax.random.key(args.seed), p)
    bob = SecretKey.generate(jax.random.key(args.seed + 1), p)
    bits = np.random.default_rng(args.seed).integers(0, 2, args.batch).astype(bool)
    ct = tlwe.lwe_encrypt_bool(jax.random.key(args.seed + 2), alice.lv0, jnp.asarray(bits), p.tlwe_lv0.alpha)
    mu = np.where(bits, np.uint32(1 << 29), np.uint32((1 << 32) - (1 << 29)))
    pk = pre.PublicKeyLv0.generate(jax.random.key(args.seed + 4), bob.lv0, p)
    keys = {
        "symmetric": pre.new_symmetric(jax.random.key(args.seed + 3), alice.lv0, bob.lv0, p, **dec),
        "asymmetric": pre.new_asymmetric(jax.random.key(args.seed + 5), alice.lv0, pk, p, **dec),
    }
    for mode, rk in keys.items():
        out = pre.reencrypt(ct, rk)
        phase = np.asarray(tlwe.lwe_phase(out, bob.lv0)).astype(np.uint32)
        err = (phase - mu).view(np.int32).astype(np.float64) / 2.0**32
        rate = float((np.asarray(tlwe.lwe_decrypt_bool(out, bob.lv0)) == bits).mean())
        print(f"{args.params} {mode} basebit={rk.basebit} t={rk.t}: B={args.batch} correct {rate} phase noise "
              f"mean {err.mean():+.5f} std {err.std():.5f} max |noise| {np.abs(err).max():.4f}, "
              f"(1/8 - |mean|) / std = {(0.125 - abs(err.mean())) / err.std():.2f} "
              f"({time.perf_counter() - t0:.0f} s, {jax.devices()[0].platform})")


if __name__ == "__main__":
    main()
