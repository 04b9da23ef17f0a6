"""Application demo: sorting encrypted integers with a bitonic network, with
the PyTorch port (the counterpart of examples/encrypted_sort.py) —
data-oblivious by construction (the compare-exchange schedule is static, so
nothing about the data leaks through control flow), batched (every network
stage is ONE comparator dispatch + ONE swap-MUX dispatch over all pairs at
once). The reference has no sorting capability at all (its comparator
sketch, src/circuits.rs, is dead code — SURVEY.md §1).

Sorts both integer representations:
  - bit-circuit integers (models.sort_bits, gate comparators)
  - radix-LUT integers (models.sort_radix, PBS trichotomy comparators)

    python examples/torch/encrypted_sort.py --params SECURITY_128_BIT_FAST
"""

import numpy as np
import torch
from _torch_common import generator, make_keys, parse_args, timed

from rs_tfhe_tpu_torch import models
from rs_tfhe_tpu_torch.bit_utils import decrypt_uint, encrypt_uint


def main(argv=None):
    # --n/--width: element count and bit width (the CPU smoke test shrinks
    # them; the code paths are identical at any size)
    args = parse_args(__doc__, argv, n=4, width=8)
    w = args.width
    sk, ck = make_keys(args.param_set, args.device)
    alpha = args.param_set.tlwe_lv0.alpha
    # digit size the parameter set's LUT margin certifies (same rule as
    # examples/torch/lut_add_two_numbers.py)
    base_bits = 3 if args.param_set.n1 >= 1024 else 2

    rng = np.random.default_rng(1)
    vals = rng.integers(0, 1 << w, size=args.n).tolist()
    print(f"cleartext input : {vals}")

    cts = torch.stack(
        [
            encrypt_uint(generator(args.device, 10 + i), sk.lv0, v, w, alpha)
            for i, v in enumerate(vals)
        ]
    )  # [K, W, n0+1]
    out = timed("bitonic sort (bit circuits)", models.sort_bits, cts, ck)
    got = [int(decrypt_uint(out[i], sk.lv0)) for i in range(len(vals))]
    print(f"sorted ascending: {got}")
    assert got == sorted(vals)

    top = models.top_k_bits(cts, 2, ck, largest=True)
    print(f"top-2           : {[int(decrypt_uint(top[i], sk.lv0)) for i in range(2)]}")

    rvals = rng.integers(0, 1 << (2 * base_bits), size=max(args.n - 1, 2))
    rcts = torch.stack(
        [
            models.encrypt_radix(
                generator(args.device, 50 + i), sk.lv0, np.array(int(v)), 2,
                sk.params, base_bits,
            )
            for i, v in enumerate(rvals)
        ]
    )  # [K, D, n0+1]
    rout = timed("bitonic sort (radix LUTs)", models.sort_radix, rcts, ck,
                 base_bits)
    rgot = [
        int(models.decrypt_radix(rout[i], sk.lv0, base_bits))
        for i in range(len(rvals))
    ]
    print(f"radix input     : {rvals.tolist()}\nradix sorted    : {rgot}")
    assert rgot == sorted(rvals.tolist())
    print("OK")


if __name__ == "__main__":
    main()
