"""Shared scaffolding of the PyTorch port's examples: parameter selection,
the device, seeded generators, keygen and timing (the counterpart of
examples/_common.py, under a name of its own so that both helpers can live
in one process).

Without --cpu an example runs on the CUDA card and raises where there is
none; --cpu runs it on the CPU, where the kernels' plain versions serve.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import rs_tfhe_tpu_torch as tfhe  # noqa: E402
from rs_tfhe_tpu_torch.key import CloudKey, SecretKey  # noqa: E402
from rs_tfhe_tpu_torch.torus import resolve_device  # noqa: E402


def parse_args(description: str, argv=None, **extra_flags) -> argparse.Namespace:
    """The JAX examples' flags (--params, --cpu and each example's own, with
    their defaults), plus `args.device`: the CPU with --cpu, else the card
    (raising without one) and `args.param_set`."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument(
        "--params",
        default="TEST_TINY",
        choices=["TEST_TINY", *tfhe.ALL_SECURITY_SETS],
        help="parameter set (TEST_TINY runs in seconds on the CPU; "
        "SECURITY_128_BIT is the production set)",
    )
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (the kernels' plain versions)")
    for name, default in extra_flags.items():
        ap.add_argument(f"--{name}", type=type(default), default=default)
    args = ap.parse_args(argv)
    args.device = resolve_device("cpu" if args.cpu else None)
    args.param_set = (
        tfhe.TEST_TINY if args.params == "TEST_TINY" else tfhe.ALL_SECURITY_SETS[args.params]
    )
    return args


def generator(device, seed: int) -> torch.Generator:
    """The counterpart of the JAX examples' `jax.random.key(seed)`."""
    return torch.Generator(device=device).manual_seed(seed)


def synchronize() -> None:
    """Wait until the card has finished its queued work (nothing to wait
    for on the CPU, where CUDA is never initialised)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def make_keys(params, device, seed: int = 0):
    t0 = time.perf_counter()
    sk = SecretKey.generate(params, generator(device, seed))
    ck = CloudKey.generate(sk, generator(device, seed + 1))
    synchronize()
    print(f"[keygen] {params.description}: {time.perf_counter() - t0:.2f}s")
    return sk, ck


def timed(label: str, fn, *args):
    """Run fn, wait for the device, report wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    synchronize()
    print(f"[{label}] {time.perf_counter() - t0:.3f}s")
    return out
