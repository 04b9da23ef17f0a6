"""Bootstrap-strategy injection with the PyTorch port (the counterpart of
examples/gates_with_strategies.py; reference: examples/gates_with_strategies.rs,
bootstrap_strategies.rs).

The Gates object accepts a pluggable bootstrap strategy — vanilla or
programmable-LUT — mirroring the reference's `Bootstrap` trait objects.

    python examples/torch/gates_with_strategies.py
"""

from _torch_common import generator, make_keys, parse_args

from rs_tfhe_tpu_torch.bootstrap import LutBootstrap, VanillaBootstrap, default_bootstrap
from rs_tfhe_tpu_torch.gates import Gates
from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_bool, lwe_encrypt_bool


def main(argv=None):
    args = parse_args(__doc__, argv)
    sk, ck = make_keys(args.param_set, args.device)
    alpha = args.param_set.tlwe_lv0.alpha

    bits_a = [True, True, False, False]
    bits_b = [True, False, True, False]
    g = generator(args.device, 3)
    a = lwe_encrypt_bool(g, sk.lv0, bits_a, alpha)
    b = lwe_encrypt_bool(g, sk.lv0, bits_b, alpha)

    for strategy in [None, VanillaBootstrap(), LutBootstrap()]:
        gates = Gates(strategy)
        out = gates.and_(a, b, ck)
        dec = list(lwe_decrypt_bool(out, sk.lv0).cpu().numpy())
        print(f"strategy={gates.bootstrap_strategy:>8}: AND(TTFF, TFTF) = {dec}")
        assert dec == [True, False, False, False]
    print("default:", default_bootstrap().name)


if __name__ == "__main__":
    main()
