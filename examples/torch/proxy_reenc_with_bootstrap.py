"""Multi-hop proxy re-encryption interleaved with gate bootstraps, with the
PyTorch port (the counterpart of examples/proxy_reenc_with_bootstrap.py;
reference: examples/proxy_reenc_with_bootstrap.rs, bootstrap_between_reenc.rs).

Each hop re-keys to the next party; a bootstrap between hops refreshes noise
so chains can extend indefinitely.

    python examples/torch/proxy_reenc_with_bootstrap.py --hops 3
"""

import numpy as np
from _torch_common import generator, parse_args, timed

from rs_tfhe_tpu_torch import gates, proxy_reenc as pre
from rs_tfhe_tpu_torch.key import CloudKey, SecretKey
from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_bool, lwe_encrypt_bool


def main(argv=None):
    args = parse_args(__doc__, argv, hops=3)
    p, dev = args.param_set, args.device

    parties = [SecretKey.generate(p, generator(dev, i)) for i in range(args.hops + 1)]
    bits = np.array([True, False, True, False])
    ct = lwe_encrypt_bool(generator(dev, 99), parties[0].lv0, bits, p.tlwe_lv0.alpha)

    for hop in range(args.hops):
        src, dst = parties[hop], parties[hop + 1]
        rk = pre.new_symmetric(generator(dev, 100 + hop), src.lv0, dst.lv0, p)
        ct = timed(f"hop {hop}: reencrypt {hop}->{hop + 1}", pre.reencrypt, ct, rk)
        # refresh noise under the destination key before the next hop
        ck_dst = CloudKey.generate(dst, generator(dev, 200 + hop))
        ct = timed(f"hop {hop}: bootstrap (AND with TRUE)",
                   lambda c: gates.and_(c, gates.constant(True, c.shape[0], p, c.device), ck_dst), ct)
        got = lwe_decrypt_bool(ct, dst.lv0).cpu().numpy()
        assert (got == bits).all(), f"hop {hop} corrupted the message"
        print(f"hop {hop}: OK {list(got)}")
    print("chain OK")


if __name__ == "__main__":
    main()
