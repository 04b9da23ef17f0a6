"""The high-level typed API with the PyTorch port (the counterpart of
examples/typed_api.py): encrypted integers with operator overloading.

The reference exposes raw ciphertexts + free gate functions (gates.rs,
examples/add_two_numbers.rs wires each gate by hand). `rs_tfhe_tpu_torch.fhe`
wraps the same machinery so encrypted code reads like plain Python —
`x * y + 3`, `x > y`, `cond.select(a, b)` — with every operator running
whole batches (and all bit positions) through single batched bootstraps.

    python examples/torch/typed_api.py --cpu            # TEST_TINY, seconds on the CPU
    python examples/torch/typed_api.py --params SECURITY_128_BIT_FAST
"""

import numpy as np
from _torch_common import generator, make_keys, parse_args, timed

from rs_tfhe_tpu_torch import FheBool, FheUint

W = 8


def main(argv=None):
    args = parse_args(__doc__, argv)
    if args.params == "TEST_TINY":
        global W
        W = 4  # keep the schoolbook multiply cheap on the CPU
    sk, ck = make_keys(args.param_set, args.device)

    x_pt = np.array([11, 3])
    y_pt = np.array([7, 13])
    mod = 1 << W
    x = FheUint.encrypt(generator(args.device, 2), sk.lv0, x_pt, W, ck)
    y = FheUint.encrypt(generator(args.device, 3), sk.lv0, y_pt, W, ck)

    s = timed("x + y (Kogge-Stone)", lambda: x + y)
    print(f"  {x_pt} + {y_pt} = {s.decrypt(sk.lv0)} (mod {mod})")
    assert (s.decrypt(sk.lv0) == (x_pt + y_pt) % mod).all()

    p = timed("x * y (schoolbook)", lambda: x * y)
    print(f"  {x_pt} * {y_pt} = {p.decrypt(sk.lv0)} (mod {mod})")
    assert (p.decrypt(sk.lv0) == (x_pt * y_pt) % mod).all()

    e = timed("x + 5 (plaintext coercion)", lambda: x + 5)
    assert (e.decrypt(sk.lv0) == (x_pt + 5) % mod).all()

    gt = timed("x > y (comparator)", lambda: x > y)
    print(f"  {x_pt} > {y_pt} = {gt.decrypt(sk.lv0)}")
    assert (gt.decrypt(sk.lv0) == (x_pt > y_pt)).all()

    mx = timed("max(x, y) = (x>y).select(x, y)", lambda: gt.select(x, y))
    assert (mx.decrypt(sk.lv0) == np.maximum(x_pt, y_pt)).all()

    b = FheBool.encrypt(generator(args.device, 4), sk.lv0, np.array([True, False]), ck)
    assert ((b ^ True).decrypt(sk.lv0) == np.array([False, True])).all()
    print("OK")


if __name__ == "__main__":
    main()
