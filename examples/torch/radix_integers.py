"""Encrypted radix integers end-to-end with the PyTorch port (the
counterpart of examples/radix_integers.py): arithmetic, comparisons,
min/max, select and bit-level casts on the PBS-digit representation.

Shows the full FheUintRadix surface — everything batched, every operator a
handful of batched blind rotations regardless of batch size. The reference's
only LUT demo adds two nibbles (examples/lut_add_two_numbers.rs); there is
no reference analogue for ciphertext multiply, encrypted comparison on
digits, encrypted select, or radix<->bit casts.

base-4 digits (base_bits=2) keep the ciphertext multiply inside its
documented no-normalization margin envelope (models.arithmetic.mul_radix);
add/compare/select also run at base 8 (SECURITY_128_BIT_RADIX) or base 16
(SECURITY_128_BIT_NIBBLE, certified p<1e-9).

    python examples/torch/radix_integers.py --cpu                  # N=512 demo set
    python examples/torch/radix_integers.py --params SECURITY_128_BIT_RADIX
"""

import numpy as np
from _torch_common import generator, make_keys, parse_args, timed

from rs_tfhe_tpu_torch.fhe import FheBool, FheUintRadix
from rs_tfhe_tpu_torch.params import TfheParams, TlweParams, TrgswParams, TrlweParams

# Insecure N=512 demo set: the smallest ring whose modulus-16/32 LUT margins
# hold (TEST_TINY's N=64 cannot host radix arithmetic) — CPU-friendly.
DEMO = TfheParams(
    security_bits=0,
    description="insecure N=512 radix demo set",
    tlwe_lv0=TlweParams(n=16, alpha=1.0e-9),
    tlwe_lv1=TlweParams(n=512, alpha=1.0e-12),
    trlwe_lv1=TrlweParams(n=512, alpha=1.0e-12),
    trgsw_lv1=TrgswParams(n=512, nbit=9, bgbit=6, l=3, basebit=2, iks_t=8,
                          alpha=1.0e-12),
)

BASE_BITS = 2  # base-4 digits


def main(argv=None):
    # --digits: operand width in base-4 digits (the CPU smoke test shrinks
    # it to 2 — 4-bit values; identical code paths at any width)
    args = parse_args(__doc__, argv, digits=4)
    d = args.digits
    mod = 1 << (BASE_BITS * d)
    params = DEMO if args.params == "TEST_TINY" else args.param_set
    sk, ck = make_keys(params, args.device)

    rng = np.random.default_rng(7)
    xs = rng.integers(0, mod, 4)
    ys = rng.integers(0, mod, 4)
    ys[0] = xs[0]  # keep one equal pair for the compare demo
    x = FheUintRadix.encrypt(generator(args.device, 2), sk.lv0, xs, d, ck, BASE_BITS)
    y = FheUintRadix.encrypt(generator(args.device, 3), sk.lv0, ys, d, ck, BASE_BITS)

    s = timed(f"x + y ({2 * d - 1} PBS)", lambda: x + y)
    print(f"  {xs} + {ys} = {s.decrypt(sk.lv0)} (mod {mod})")
    assert (s.decrypt(sk.lv0) == (xs + ys) % mod).all()

    dsub = timed(f"x - y ({2 * d} PBS)", lambda: x - y)
    assert (dsub.decrypt(sk.lv0) == (xs - ys) % mod).all()

    p = timed("x * y (full-width ciphertext multiply)", lambda: x * y)
    print(f"  {xs} * {ys} = {p.decrypt(sk.lv0)}")
    assert (p.decrypt(sk.lv0) == xs.astype(np.int64) * ys).all()

    eq, gt, lt = timed("compare (trichotomy tree, 3 rotations)",
                       lambda: x.compare(y))
    print(f"  eq={eq.decrypt(sk.lv0)} gt={gt.decrypt(sk.lv0)} lt={lt.decrypt(sk.lv0)}")
    assert (gt.decrypt(sk.lv0) == (xs > ys)).all()
    assert (eq.decrypt(sk.lv0) == (xs == ys)).all()

    mx = timed("max(x, y)", lambda: x.max(y))
    assert (mx.decrypt(sk.lv0) == np.maximum(xs, ys)).all()

    sel = FheBool.encrypt(generator(args.device, 4), sk.lv0,
                          np.array([True, False, True, False]), ck)
    chosen = timed("sel.select(x, y) (3 rotations)", lambda: sel.select(x, y))
    assert (chosen.decrypt(sk.lv0) == np.where([1, 0, 1, 0], xs, ys)).all()

    bits = timed("cast to bits (1 rotation)", lambda: x.to_bits())
    back = timed("bitwise ops + cast back (2 rotations)",
                 lambda: (bits ^ 0b111).to_radix(BASE_BITS))
    assert (back.decrypt(sk.lv0) == (xs ^ 0b111)).all()

    quadrupled = x.shift_digits(1)  # *4 mod 256, free
    assert (quadrupled.decrypt(sk.lv0) == (xs * 4) % mod).all()
    print("OK")


if __name__ == "__main__":
    main()
