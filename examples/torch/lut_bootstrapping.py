"""Programmable (LUT) bootstrapping with the PyTorch port (the counterpart
of examples/lut_bootstrapping.py; reference: examples/lut_bootstrapping.rs,
lut_arithmetic_demo.rs).

Evaluates arbitrary functions on encrypted multi-bit messages in one
bootstrap — square, negation, custom closures — batched over message vectors.

    python examples/torch/lut_bootstrapping.py --params SECURITY_128_BIT
"""

import numpy as np
import torch
from _torch_common import generator, make_keys, parse_args

from rs_tfhe_tpu_torch.bootstrap import LutBootstrap
from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_message, lwe_encrypt_message


def main(argv=None):
    args = parse_args(__doc__, argv)
    sk, ck = make_keys(args.param_set, args.device)
    m = 8 if args.param_set.n1 >= 1024 else 4
    alpha = args.param_set.tlwe_lv0.alpha
    lb = LutBootstrap()

    msgs = torch.arange(m)
    ct = lwe_encrypt_message(generator(args.device, 2), sk.lv0, msgs, m, alpha)

    for name, f in [
        ("identity", lambda x: x),
        ("square", lambda x: (x * x) % m),
        ("negate", lambda x: (m - x) % m),
        ("threshold>2", lambda x: 1 if x > 2 else 0),
    ]:
        out = lb.bootstrap_func(ct, f, m, ck)
        got = lwe_decrypt_message(out, sk.lv0, m)
        exp = [f(int(x)) % m for x in np.arange(m)]
        status = "OK" if list(got) == exp else f"MISMATCH {list(got)} != {exp}"
        print(f"{name:>12}: f([0..{m - 1}]) = {list(got)}  {status}")


if __name__ == "__main__":
    main()
