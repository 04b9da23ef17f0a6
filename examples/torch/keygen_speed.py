"""Key-generation timing with the PyTorch port (the counterpart of
examples/keygen_speed.py; reference: examples/test_keygen_speed.rs, which
documents 700 serial TRGSW encryptions at 50-100 ms each on a CPU; here the
whole bootstrapping key is one batched tensor computation on the device).

    python examples/torch/keygen_speed.py --params SECURITY_128_BIT
"""

import time

from _torch_common import generator, parse_args, synchronize

from rs_tfhe_tpu_torch.key import CloudKey, SecretKey, gen_bootstrapping_key, gen_key_switching_key


def main(argv=None):
    args = parse_args(__doc__, argv)
    p, dev = args.param_set, args.device
    sk = SecretKey.generate(p, generator(dev, 42))
    synchronize()

    for label, f in [
        ("key-switching key", lambda i: gen_key_switching_key(generator(dev, i), sk)),
        ("bootstrapping key", lambda i: gen_bootstrapping_key(generator(dev, i), sk)),
        ("full CloudKey", lambda i: CloudKey.generate(sk, generator(dev, i))),
    ]:
        f(0)  # warm-up
        synchronize()
        t0 = time.perf_counter()
        f(1)
        synchronize()
        print(f"{label}: {(time.perf_counter() - t0) * 1e3:.0f} ms (warm)")


if __name__ == "__main__":
    main()
