"""Ciphertext x ciphertext integer multiplication with the PyTorch port (the
counterpart of examples/ciphertext_multiply.py) — a capability the reference
does not have (its only multiplications are by plaintext scalars,
tlwe.rs:160-214).

models.mul_radix multiplies two radix-encoded encrypted integers in three
batched-PBS stages (re-encode, bivariate digit products via per-ciphertext
LUTs, carry-save columns with greedy normalization); the normalization
stage lifts the operand width past 8 bits. Margins are certified at
SECURITY_128_BIT_NIBBLE (~6.5 sigma, p < 1e-9 per PBS).

    python examples/torch/ciphertext_multiply.py --cpu                 # 4-bit demo
    python examples/torch/ciphertext_multiply.py --params SECURITY_128_BIT_NIBBLE \
        --x 40590 --y 27063 --bits 16                                  # on the card
"""

from _torch_common import generator, make_keys, parse_args, timed

from rs_tfhe_tpu_torch import models
from rs_tfhe_tpu_torch.params import TfheParams, TlweParams, TrgswParams, TrlweParams

#: mul_radix's column stage decodes at modulus 32, which needs more ring
#: margin than TEST_TINY's N=64 has — the demo set bumps the ring to 512
#: (still insecure/test-only)
TINY_MUL = TfheParams(
    security_bits=0,
    description="insecure tiny set with modulus-32 LUT margins (N=512)",
    tlwe_lv0=TlweParams(n=16, alpha=1.0e-9),
    tlwe_lv1=TlweParams(n=512, alpha=1.0e-12),
    trlwe_lv1=TrlweParams(n=512, alpha=1.0e-12),
    trgsw_lv1=TrgswParams(n=512, nbit=9, bgbit=6, l=3, basebit=2, iks_t=8,
                          alpha=1.0e-12),
)


def main(argv=None):
    args = parse_args(__doc__, argv, x=11, y=13, bits=0)
    if args.param_set.n1 < 512:
        args.param_set = TINY_MUL
    sk, ck = make_keys(args.param_set, args.device)

    base_bits = 2
    # the tiny demo set handles 4-bit operands; production sets take 16
    bits = args.bits or (4 if args.param_set.n1 < 1024 else 8)
    num_digits = -(-bits // base_bits)
    mod = 1 << bits
    x, y = args.x % mod, args.y % mod

    a = models.encrypt_radix(generator(args.device, 2), sk.lv0, x, num_digits,
                             args.param_set, base_bits)
    b = models.encrypt_radix(generator(args.device, 3), sk.lv0, y, num_digits,
                             args.param_set, base_bits)

    out = timed(f"{bits}-bit x {bits}-bit multiply", models.mul_radix, a, b,
                ck, base_bits)
    got = int(models.decrypt_radix(out, sk.lv0, base_bits))
    print(f"{x} * {y} = {got} (expect {x * y})")
    assert got == x * y
    print("OK")


if __name__ == "__main__":
    main()
