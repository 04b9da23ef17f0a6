"""LWE proxy re-encryption, symmetric and asymmetric, with the PyTorch port
(the counterpart of examples/proxy_reencryption_demo.py; reference:
examples/proxy_reencryption_demo.rs).

Alice's ciphertexts are re-keyed to Bob without decryption. Asymmetric mode
builds the re-encryption key from Bob's *public* key only.

    python examples/torch/proxy_reencryption_demo.py
"""

import numpy as np
from _torch_common import generator, parse_args

from rs_tfhe_tpu_torch import proxy_reenc as pre
from rs_tfhe_tpu_torch.key import SecretKey
from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_bool, lwe_encrypt_bool


def main(argv=None):
    args = parse_args(__doc__, argv)
    p, dev = args.param_set, args.device
    alice = SecretKey.generate(p, generator(dev, 0))
    bob = SecretKey.generate(p, generator(dev, 1))

    bits = np.array([True, False, True, True, False, False, True, False])
    ct = lwe_encrypt_bool(generator(dev, 2), alice.lv0, bits, p.tlwe_lv0.alpha)

    rk_sym = pre.new_symmetric(generator(dev, 3), alice.lv0, bob.lv0, p)
    got = lwe_decrypt_bool(pre.reencrypt(ct, rk_sym), bob.lv0).cpu().numpy()
    print("symmetric :", list(got))
    assert (got == bits).all()

    pk_bob = pre.PublicKeyLv0.generate(generator(dev, 4), bob.lv0, p)
    rk_asym = pre.new_asymmetric(generator(dev, 5), alice.lv0, pk_bob, p)
    got = lwe_decrypt_bool(pre.reencrypt(ct, rk_asym), bob.lv0).cpu().numpy()
    print("asymmetric:", list(got))
    assert (got == bits).all()
    print("OK")


if __name__ == "__main__":
    main()
