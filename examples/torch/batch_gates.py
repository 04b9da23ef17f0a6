"""Batched gate throughput scaling with the PyTorch port (the counterpart of
examples/batch_gates.py; reference: examples/batch_gates.rs,
batch_gates_scaling.rs).

The reference fans independent gates over CPU threads; here the batch axis is
the hardware parallelism — one blind-rotation kernel launch processes the
whole batch, and larger batches fill more of the card.

    python examples/torch/batch_gates.py --params SECURITY_128_BIT
"""

import time

import numpy as np
from _torch_common import generator, make_keys, parse_args, synchronize

from rs_tfhe_tpu_torch.gates import batch_gate
from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_bool, lwe_encrypt_bool


def main(argv=None):
    # --max_batch: largest batch in the sweep (the CPU smoke test caps it)
    args = parse_args(__doc__, argv, max_batch=1024)
    sk, ck = make_keys(args.param_set, args.device)
    alpha = args.param_set.tlwe_lv0.alpha
    rng = np.random.default_rng(0)

    print(f"{'batch':>6} {'total ms':>10} {'ms/gate':>9} {'gates/s':>9}")
    for batch in [b for b in [1, 8, 64, 256, 1024] if b <= args.max_batch]:
        bits_a = rng.integers(0, 2, batch).astype(bool)
        bits_b = rng.integers(0, 2, batch).astype(bool)
        g = generator(args.device, 3)
        a = lwe_encrypt_bool(g, sk.lv0, bits_a, alpha)
        b = lwe_encrypt_bool(g, sk.lv0, bits_b, alpha)

        out = batch_gate("nand", a, b, ck)  # warm-up
        dec = lwe_decrypt_bool(out, sk.lv0).cpu().numpy()
        assert (dec == ~(bits_a & bits_b)).all()

        t0 = time.perf_counter()
        cur = a
        iters = 3
        for _ in range(iters):
            cur = batch_gate("nand", cur, b, ck)
        synchronize()
        dt = (time.perf_counter() - t0) / iters
        print(f"{batch:>6} {dt * 1e3:>10.1f} {dt / batch * 1e3:>9.3f} {batch / dt:>9.1f}")


if __name__ == "__main__":
    main()
