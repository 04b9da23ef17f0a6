"""Single-gate latency with a multi-bit (pair-grouped) bootstrapping key,
with the PyTorch port (the counterpart of examples/low_latency_gates.py).

No reference analog — rs-tfhe rotates bit-serially (trgsw.rs:209-223). A
`CloudKey.generate(..., multibit=True)` key additionally stores TRGSW
encryptions of the four pair-indicator products per PAIR of lv0 secret bits,
so one external product advances the blind rotation by TWO mask elements;
gates route batches up to `ops.blind_rotate.mb_route_batch_cap` through the
half-length chain (on the card: the multi-bit kernel). The latency is the
chain-length slope (t_long - t5) / (n_long - 5), minimum over repeats, of an
eager loop of dependent gates; the gate's noise is
utils.noise.estimate(params, mb_group=2).

    python examples/torch/low_latency_gates.py --cpu                # TEST_TINY
    python examples/torch/low_latency_gates.py --params SECURITY_128_BIT
"""

import time

import numpy as np
from _torch_common import generator, parse_args, synchronize

from rs_tfhe_tpu_torch import gates
from rs_tfhe_tpu_torch.key import CloudKey, SecretKey
from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_bool, lwe_encrypt_bool
from rs_tfhe_tpu_torch.utils.noise import estimate


def chain(n):
    def run(x, y, ck):
        for _ in range(n):
            x = gates.nand(x, y, ck)
        return x

    return run


def measure(a, b, ck, label, n_long=25, reps=3):
    """Chain-length slope: (t_long - t5) / (n_long - 5), min over repeats —
    cancels the per-call overhead a pipelined workload would not pay."""
    short, long_ = chain(5), chain(n_long)
    ts = []
    for fn in (short, long_):
        fn(a, b, ck)  # warm-up
        synchronize()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(a, b, ck)
            synchronize()
            best = min(best, time.perf_counter() - t0)
        ts.append(best)
    ms = (ts[1] - ts[0]) / (n_long - 5) * 1e3
    print(f"[{label}] single-gate latency: {ms:.2f} ms")
    return ms


def main(argv=None):
    # --long/--reps: slope chain length and repeats (the CPU smoke test
    # shrinks them)
    args = parse_args(__doc__, argv, long=25, reps=3)
    p, dev = args.param_set, args.device
    sk = SecretKey.generate(p, generator(dev, 0))
    t0 = time.perf_counter()
    ck = CloudKey.generate(sk, generator(dev, 1))
    synchronize()
    print(f"[keygen standard] {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    ck_mb = CloudKey.generate(sk, generator(dev, 1), multibit=True)
    synchronize()
    print(f"[keygen multibit] {time.perf_counter() - t0:.2f}s "
          f"(~2x BSK material)")

    e = estimate(p, mb_group=2)
    print(f"[noise] mb bootstrap-out sigma: {e.bootstrap_out_std:.3e} "
          f"(gate p_fail ~ {e.gate_fail_prob:.1e})")

    bits = np.array([True])
    a = lwe_encrypt_bool(generator(dev, 2), sk.lv0, bits, p.tlwe_lv0.alpha)
    b = lwe_encrypt_bool(generator(dev, 3), sk.lv0, ~bits, p.tlwe_lv0.alpha)

    out = gates.nand(a, b, ck_mb)  # B=1 -> auto-routes the mb chain
    dec = lwe_decrypt_bool(out, sk.lv0).cpu().numpy()
    assert dec.tolist() == [True], dec  # NAND(1, 0) = 1
    print("[mb gate] correct")

    ms_std = measure(a, b, ck, "standard key", args.long, args.reps)
    ms_mb = measure(a, b, ck_mb, "multibit key", args.long, args.reps)
    print(f"[speedup] {ms_std / ms_mb:.2f}x  (reference: ~15 ms/gate)")


if __name__ == "__main__":
    main()
