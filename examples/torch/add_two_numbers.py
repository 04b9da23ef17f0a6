"""Homomorphic 16-bit addition with the PyTorch port (the counterpart of
examples/add_two_numbers.py; reference: examples/add_two_numbers.rs).

The reference evaluates a ripple-carry adder one bootstrapped gate at a time
(~80 serial gates). Here the default is the batch-first Kogge-Stone adder:
2 + 2*log2(W) batched gate rounds, each bootstrapping all 16 bit positions
in one blind-rotation batch.

    python examples/torch/add_two_numbers.py --params SECURITY_128_BIT --x 4059 --y 27063
"""

from _torch_common import generator, make_keys, parse_args, timed

from rs_tfhe_tpu_torch import models
from rs_tfhe_tpu_torch.bit_utils import decrypt_uint, encrypt_uint

W = 16


def main(argv=None):
    args = parse_args(__doc__, argv, x=4059, y=27063)
    sk, ck = make_keys(args.param_set, args.device)
    alpha = args.param_set.tlwe_lv0.alpha

    a = encrypt_uint(generator(args.device, 2), sk.lv0, args.x, W, alpha)
    b = encrypt_uint(generator(args.device, 3), sk.lv0, args.y, W, alpha)

    out = timed("kogge-stone add (batched gates)", models.add_kogge_stone, a, b, ck)
    got = decrypt_uint(out, sk.lv0)
    print(f"{args.x} + {args.y} = {got} (expect {(args.x + args.y) % (1 << W)})")
    assert got == (args.x + args.y) % (1 << W)

    out2 = timed("ripple-carry add (serial gates)", models.add_ripple_carry, a, b, ck)
    assert decrypt_uint(out2, sk.lv0) == (args.x + args.y) % (1 << W)
    print("OK")


if __name__ == "__main__":
    main()
