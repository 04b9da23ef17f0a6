"""Programmable bootstrapping across the Uint1-8 parameter sets, with the
PyTorch port (the counterpart of examples/lut_uint_parameters_demo.py;
reference: examples/lut_uint_parameters_demo.rs — which could not actually
switch sets, since the reference pins dimensions at compile time; here every
set is a runtime config).

The Uint sets' digits span more than one byte (bgbit 10-23), so on the card
their rotations run on the CUDA-core instance of the blind-rotation kernel.
Runs a squaring LUT over all messages.

    python examples/torch/lut_uint_parameters_demo.py --params SECURITY_UINT4
"""

import torch
from _torch_common import generator, make_keys, parse_args

import rs_tfhe_tpu_torch as tfhe
from rs_tfhe_tpu_torch.bootstrap import LutBootstrap
from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_message, lwe_encrypt_message


def main(argv=None):
    args = parse_args(__doc__, argv)
    p = args.param_set if args.params != "TEST_TINY" else tfhe.TEST_TINY
    g = p.trgsw_lv1
    print(
        f"{args.params}: n0={p.n0} N={p.n1} L={g.l} bgbit={g.bgbit} "
        f"(digit limbs: {p.digit_limbs})"
    )
    sk, ck = make_keys(p, args.device)
    m = min(16, 2 ** max(1, p.security_bits)) if p.security_bits <= 8 else 8
    if args.params == "TEST_TINY":
        m = 4

    msgs = torch.arange(m)
    ct = lwe_encrypt_message(generator(args.device, 2), sk.lv0, msgs, m, p.tlwe_lv0.alpha)
    out = LutBootstrap().bootstrap_func(ct, lambda x: (x * x) % m, m, ck)
    got = list(lwe_decrypt_message(out, sk.lv0, m))
    exp = [(x * x) % m for x in range(m)]
    print(f"square mod {m}: {got}")
    assert got == exp, f"expected {exp}"
    print("OK")


if __name__ == "__main__":
    main()
