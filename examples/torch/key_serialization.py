"""Key checkpoint/resume with the PyTorch port (the counterpart of
examples/key_serialization.py; new capability — the reference has no
persistence, SURVEY.md §5). The files are the JAX package's npz format.

    python examples/torch/key_serialization.py
"""

import os
import tempfile

import torch
from _torch_common import generator, make_keys, parse_args

from rs_tfhe_tpu_torch import gates
from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_bool, lwe_encrypt_bool
from rs_tfhe_tpu_torch.utils.serialization import (
    load_cloud_key,
    load_secret_key,
    save_cloud_key,
    save_secret_key,
)


def main(argv=None):
    args = parse_args(__doc__, argv)
    sk, ck = make_keys(args.param_set, args.device)

    with tempfile.TemporaryDirectory() as d:
        skp, ckp = os.path.join(d, "sk.npz"), os.path.join(d, "ck.npz")
        ckps = os.path.join(d, "ck_seeded.npz")
        save_secret_key(skp, sk)
        save_cloud_key(ckp, ck)
        # seeded: ship only the generate seed + ciphertext bodies; the key
        # masks are replayed bit-exactly at load
        save_cloud_key(ckps, ck, seeded=True)
        print(f"secret key        : {os.path.getsize(skp) / 1e3:.1f} kB")
        print(f"cloud key         : {os.path.getsize(ckp) / 1e6:.1f} MB")
        print(f"cloud key (seeded): {os.path.getsize(ckps) / 1e6:.1f} MB")

        sk2, ck2 = load_secret_key(skp, args.device), load_cloud_key(ckps, args.device)
        assert torch.equal(ck2.bsk, ck.bsk)

    bits = [True, False]
    a = lwe_encrypt_bool(generator(args.device, 2), sk2.lv0, bits, args.param_set.tlwe_lv0.alpha)
    out = gates.nand(a, a, ck2)
    got = lwe_decrypt_bool(out, sk2.lv0).cpu().numpy()
    assert (got == [False, True]).all()
    print("reloaded keys evaluate correctly: OK")


if __name__ == "__main__":
    main()
