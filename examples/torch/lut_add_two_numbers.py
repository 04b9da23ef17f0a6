"""8-bit addition in 3 programmable bootstraps via nibble LUTs, with the
PyTorch port (the counterpart of examples/lut_add_two_numbers.py; reference:
examples/lut_add_two_numbers.rs, README.md:220).

At SECURITY_128_BIT_NIBBLE (N=4096, certified ~6.5 sigma of base-16
margin — utils.noise.lut_margin) this runs the reference's literal
headline: two 4-bit digits, 3 PBS, with p_fail < 1e-9.
SECURITY_128_BIT_RADIX (N=2048) also runs nibbles at ~3.7 sigma
(p ~ 1e-4); the N=1024 sets fall back to 3-bit digits (5 PBS).

    python examples/torch/lut_add_two_numbers.py --params SECURITY_128_BIT_NIBBLE --x 137 --y 205
"""

from _torch_common import generator, make_keys, parse_args, timed

from rs_tfhe_tpu_torch import models
from rs_tfhe_tpu_torch.utils.noise import lut_margin


def main(argv=None):
    args = parse_args(__doc__, argv, x=137, y=205)
    sk, ck = make_keys(args.param_set, args.device)
    if args.param_set.n1 >= 2048:
        base_bits = 4  # nibbles: 8-bit add in 3 PBS (certified at N=4096)
    elif args.param_set.n1 >= 1024:
        base_bits = 3
    else:
        base_bits = 2
    sig, pf = lut_margin(args.param_set, 1 << (base_bits + 1))
    print(f"base 2^{base_bits} digits: {sig:.1f} sigma margin (p_fail {pf:.1e})")
    num_digits = -(-8 // base_bits)  # ceil
    mod = 1 << (base_bits * num_digits)

    a = models.encrypt_radix(generator(args.device, 2), sk.lv0, args.x % mod, num_digits, args.param_set,
                             base_bits)
    b = models.encrypt_radix(generator(args.device, 3), sk.lv0, args.y % mod, num_digits, args.param_set,
                             base_bits)

    out = timed(f"radix add ({2 * num_digits - 1} PBS)", models.add_radix, a, b, ck, base_bits)
    got = int(models.decrypt_radix(out, sk.lv0, base_bits))
    print(f"{args.x % mod} + {args.y % mod} = {got} (expect {(args.x + args.y) % mod})")
    assert got == (args.x + args.y) % mod
    print("OK")


if __name__ == "__main__":
    main()
