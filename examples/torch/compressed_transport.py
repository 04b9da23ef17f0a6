"""Deployment round trip with compressed transport, with the PyTorch port
(the counterpart of examples/compressed_transport.py): a native C++ client
encrypts SEEDED ciphertexts (1 word each on the wire instead of n+1 — 701x
at the 128-bit sets), the server expands them from the 2-word threefry seed
on its device, evaluates bootstrapped gates, and the client decrypts — no
PyTorch on the client side at any point.

New capability: the reference always ships full masks (rs-tfhe tlwe.rs),
and has no client runtime separable from the evaluator. Where the native
client cannot be built (no g++), the example says so and stops.

    python examples/torch/compressed_transport.py [--cpu] [--params TEST_TINY]
"""

import numpy as np
from _torch_common import make_keys, parse_args

from rs_tfhe_tpu_torch import gates, native
from rs_tfhe_tpu_torch.tlwe import lwe_expand_seeded
from rs_tfhe_tpu_torch.torus import to_numpy, to_torch


def main(argv=None):
    args = parse_args(__doc__, argv)
    if not native.available():
        print("native client runtime unavailable (no g++?) — skipping")
        return
    sk, ck = make_keys(args.param_set, args.device)
    p = args.param_set
    s = to_numpy(sk.lv0)
    rng = np.random.default_rng(0)

    batch = 64
    a_bits = rng.integers(0, 2, batch).astype(bool)
    b_bits = rng.integers(0, 2, batch).astype(bool)

    # --- client (pure C++): seeded encryption ---
    mu_t, mu_f = np.uint32(1 << 29), np.uint32((1 << 32) - (1 << 29))
    seed_a = np.array([101, 1], dtype=np.uint32)  # fresh per batch (nonce!)
    seed_b = np.array([102, 2], dtype=np.uint32)
    bodies_a = native.lwe_encrypt_seeded(
        seed_a, 11, s, np.where(a_bits, mu_t, mu_f), p.tlwe_lv0.alpha)
    bodies_b = native.lwe_encrypt_seeded(
        seed_b, 12, s, np.where(b_bits, mu_t, mu_f), p.tlwe_lv0.alpha)
    wire = (2 + batch) * 4
    full = batch * (p.n0 + 1) * 4
    print(f"wire bytes per batch: {wire} (full masks would be {full}; "
          f"{full / wire:.0f}x)")

    # --- server (PyTorch, on its device): expand + homomorphic circuit ---
    ct_a = lwe_expand_seeded(seed_a, to_torch(bodies_a, args.device), p.n0)
    ct_b = lwe_expand_seeded(seed_b, to_torch(bodies_b, args.device), p.n0)
    ct_xor = gates.xor(ct_a, ct_b, ck)
    ct_and = gates.and_(ct_a, ct_b, ck)

    # --- client (pure C++): decryption ---
    got_xor = native.lwe_decrypt_bool(to_numpy(ct_xor), s)
    got_and = native.lwe_decrypt_bool(to_numpy(ct_and), s)
    assert (got_xor == (a_bits ^ b_bits)).all()
    assert (got_and == (a_bits & b_bits)).all()
    print(f"{batch} XOR + {batch} AND evaluated on expanded ciphertexts: OK")


if __name__ == "__main__":
    main()
