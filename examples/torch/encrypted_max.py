"""Application demo: maximum of encrypted integers via a comparator/MUX
tournament, with the PyTorch port (the counterpart of
examples/encrypted_max.py) — a capability composition the reference's
examples never reach (comparator + selection entirely under encryption).

Each tournament round compares pairs (greater_than) and selects winners
(bit-batched MUX), halving the list; log2(K) rounds total.

    python examples/torch/encrypted_max.py --params SECURITY_128_BIT
"""

import numpy as np
import torch
from _torch_common import generator, make_keys, parse_args, timed

from rs_tfhe_tpu_torch import gates, models
from rs_tfhe_tpu_torch.bit_utils import decrypt_uint, encrypt_uint

W = 8


def encrypted_max(cts, ck):
    """cts: list of bit-batch ciphertexts [W, n0+1] -> the encrypted maximum."""
    while len(cts) > 1:
        nxt = []
        for i in range(0, len(cts) - 1, 2):
            a, b = cts[i], cts[i + 1]
            a_gt = models.greater_than(a, b, ck)  # [n0+1]
            sel = torch.broadcast_to(a_gt, a.shape)  # same select for every bit
            nxt.append(gates.mux(sel, a, b, ck))
        if len(cts) % 2:
            nxt.append(cts[-1])
        cts = nxt
    return cts[0]


def main(argv=None):
    args = parse_args(__doc__, argv)
    sk, ck = make_keys(args.param_set, args.device)
    alpha = args.param_set.tlwe_lv0.alpha

    rng = np.random.default_rng(7)
    values = rng.integers(0, 256, 4)
    cts = [
        encrypt_uint(generator(args.device, 10 + i), sk.lv0, int(v), W, alpha)
        for i, v in enumerate(values)
    ]
    out = timed(f"max of {list(values)}", encrypted_max, cts, ck)
    got = decrypt_uint(out, sk.lv0)
    print(f"max = {got} (expect {values.max()})")
    assert got == values.max()
    print("OK")


if __name__ == "__main__":
    main()
