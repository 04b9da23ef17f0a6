"""Split the small-batch gate latency of the PyTorch port into its stages:
the counterpart of scripts/diag_gate_latency.py, with its chains, inputs,
environment variables and row.

Times, at each batch size, four chains of ITERS = 20 dependent calls under
`config.step_impl` (RS_TFHE_STEP_IMPL, default "auto"), each feeding its
output back into the next call's first ciphertext as the JAX script does
(scripts/diag_gate_latency.py:76-110):

  rot         the NAND linear form and the blind rotation; x += the first
              n0+1 words of the accumulator's mask (wrapping int32);
  rot+ext     the same and the sample extraction; x += the first n0+1 words
              of the extracted lv1 ciphertext;
  rot+ext+ks  the same and the key switch, whose output is the next x;
  nand        the public gates.nand.

The rotation is `ops.blind_rotate.blind_rotate` with the key's multi-bit
material where it has some, so a multi-bit key's chains take the multi-bit
kernel up to `mb_route_batch_cap` as its gates do; the JAX script times a
standard key only. Each chain's time is the minimum over REPEATS = 3 after a
warm call, to a scalar read, over ITERS (scripts/diag_gate_latency.py:40-50).
The JAX chains run inside one jit; here each is an eager loop on the card's
stream, so the host's enqueue of every call is part of these times: it is
what a caller of the port pays. `device_ms` separates it: the same chain
queued behind a spin kernel, its kernels timed back to back by CUDA events.
The stage split then reads: extract = rot+ext - rot, key switch =
rot+ext+ks - rot+ext, the gate's linear form and host path = nand -
rot+ext+ks.

Keys come from torch generators seeded 42 (the secret key) and 7 (the cloud
key), where the JAX script seeds jax.random.key, on the run's device; the
bits from np.random.default_rng(0) for each batch, encrypted with a
generator seeded 3.

    python scripts/torch/diag_gate_latency.py            # B = 2 at SECURITY_128_BIT_FAST, on the card
    python scripts/torch/diag_gate_latency.py 1 2 4      # those batches
    RS_TFHE_BENCH_PARAMS=SECURITY_128_BIT python scripts/torch/diag_gate_latency.py 1
    RS_TFHE_BENCH_PARAMS=TEST_TINY python scripts/torch/diag_gate_latency.py --cpu 1 2   # a CPU rehearsal

Prints one JSON row a batch on stdout, with the JAX script's keys (batch,
rot_ms, rot+ext_ms, rot+ext+ks_ms, nand_ms: host-clock ms a call); on
stderr the card's name and power limit, the route, and on the card each
stage's device ms. Without --cpu it runs on the card and raises where there
is none.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench_common import (  # noqa: E402
    card_fields, chain, device_of, generator, log, min_time, params_by_name, route,
)

from rs_tfhe_tpu_torch import config, gates  # noqa: E402
from rs_tfhe_tpu_torch.gates import _nand_lin  # noqa: E402
from rs_tfhe_tpu_torch.key import CloudKey, SecretKey  # noqa: E402
from rs_tfhe_tpu_torch.ops.blind_rotate import blind_rotate  # noqa: E402
from rs_tfhe_tpu_torch.ops.extract import sample_extract  # noqa: E402
from rs_tfhe_tpu_torch.ops.keyswitch import identity_key_switch  # noqa: E402
from rs_tfhe_tpu_torch.tlwe import lwe_encrypt_bool  # noqa: E402

ITERS, REPEATS = 20, 3
#: cycles of the spin kernel a second of host enqueue to cover (above the card's 1.98 GHz SM clock)
SLEEP_CYCLES_PER_S = 2.5e9


def _rotate(x, y, ck):
    return blind_rotate(_nand_lin(x, y), ck.testvec, ck.bsk, ck.params, bsk_mb=ck.bsk_mb)


def _next_x(out, cur):
    return (out, *cur[1:])


def rot_only(x, y, ck, iters: int):
    """`iters` rotations of the NAND linear form, each adding the first
    n0+1 words of the accumulator's mask to x."""
    def step(x, y, ck):
        return x + _rotate(x, y, ck)[:, 0, : x.shape[1]]

    return chain(step, (x, y, ck), iters, _next_x)


def rot_extract(x, y, ck, iters: int):
    """As `rot_only`, through the sample extraction: x += lv1[:, :n0+1]."""
    def step(x, y, ck):
        return x + sample_extract(_rotate(x, y, ck), 0)[:, : x.shape[1]]

    return chain(step, (x, y, ck), iters, _next_x)


def full_bs(x, y, ck, iters: int):
    """Rotation, extraction and key switch; the key switch's output is the
    next x."""
    def step(x, y, ck):
        return identity_key_switch(sample_extract(_rotate(x, y, ck), 0), ck.ksk_limbs, ck.params)

    return chain(step, (x, y, ck), iters, _next_x)


def gate_chain(x, y, ck, iters: int):
    """`iters` public NAND gates, each output the next x."""
    return chain(gates.nand, (x, y, ck), iters, _next_x)


#: the JAX script's stage names, in its order
STAGES = {"rot": rot_only, "rot+ext": rot_extract, "rot+ext+ks": full_bs, "nand": gate_chain}


def inputs(sk, batch: int):
    """The two ciphertext batches of the JAX script: bits from
    default_rng(0), encrypted with a generator seeded 3 on the key's device."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (2, batch)).astype(bool)
    g = generator(sk.lv0.device, 3)
    alpha = sk.params.tlwe_lv0.alpha
    return lwe_encrypt_bool(g, sk.lv0, bits[0], alpha), lwe_encrypt_bool(g, sk.lv0, bits[1], alpha)


def host_ms(fn, a, b, ck, iters: int, repeats: int) -> float:
    """ms a call of the chain `fn`: the minimum over `repeats` after a warm
    run, host clock to a scalar read, over `iters`."""
    return min_time(lambda: fn(a, b, ck, iters), repeats) / iters * 1e3


def device_ms(fn, a, b, ck, host_s: float, iters: int) -> tuple[float, bool]:
    """(device ms a call of the chain `fn`, whether the whole chain was
    queued before the card reached it). A spin kernel holds the stream for
    twice `host_s` (the chain's host-clock time) while the host queues the
    chain between two CUDA events, so the events bracket its kernels run
    back to back. The flag is false where the card reached the first event
    before the host had queued the last call (a chain that waits on the
    card somewhere): then the bracket holds host gaps too."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2 * host_s * SLEEP_CYCLES_PER_S))
    start.record()
    fn(a, b, ck, iters)
    end.record()
    queued = not start.query()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, queued


def measure(batch: int, sk, ck, events: bool = False) -> tuple[dict, dict]:
    """(the JAX script's row for this batch, rounded as it rounds; the
    unrounded host ms and, with `events` on the card, device ms and queue
    flags by stage)."""
    a, b = inputs(sk, batch)
    row, detail = {"batch": batch}, {"batch": batch}
    for name, fn in STAGES.items():
        ms = host_ms(fn, a, b, ck, ITERS, REPEATS)
        row[name + "_ms"] = round(ms, 2)
        detail[name + "_ms"] = ms
        if events:
            detail[name + "_device_ms"], detail[name + "_queued"] = device_ms(fn, a, b, ck, ms * ITERS / 1e3, ITERS)
    return row, detail


def keys(params, device, multibit: bool = False):
    """(secret key, cloud key) from generators seeded 42 and 7 on `device`."""
    sk = SecretKey.generate(params, generator(device, 42))
    return sk, CloudKey.generate(sk, generator(device, 7), multibit=multibit)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("batches", nargs="*", type=int, help="batch sizes (default: 2)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = device_of(args.cpu)
    pname = os.environ.get("RS_TFHE_BENCH_PARAMS", "SECURITY_128_BIT_FAST")
    impl = os.environ.get("RS_TFHE_STEP_IMPL", "auto")
    batches = args.batches or [2]
    fields = card_fields(device)
    log(f"device={fields['device']} power_limit={fields['power_limit']} params={pname} step_impl={impl}")
    with route(impl):
        log(f"route: step_impl={config.config.step_impl}")
        sk, ck = keys(params_by_name(pname), device)
        for batch in batches:
            t0 = time.perf_counter()
            row, detail = measure(batch, sk, ck, events=device.type == "cuda")
            print(json.dumps(row), flush=True)
            if device.type == "cuda":
                log("  device ms a call (CUDA events, queued behind a spin kernel): " + ", ".join(
                    f"{s} {detail[s + '_device_ms']:.3f}{'' if detail[s + '_queued'] else ' (not queued)'}"
                    for s in STAGES) + f" [wall {time.perf_counter() - t0:.0f}s]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
