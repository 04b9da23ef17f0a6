"""A dry run of the multi-device paths on n devices (the counterpart of
`dryrun_multichip` in the repository's __graft_entry__.py): TEST_TINY keys,
data-parallel NAND, MUX and LUT on a mesh of n, and, when n is even, the
tensor-parallel NAND on an (n/2, 2) mesh; each output decrypted and checked.

    python -m rs_tfhe_tpu_torch.parallel.dryrun 4            # 4 visible CUDA devices
    python -m rs_tfhe_tpu_torch.parallel.dryrun 8 --devices cpu   # 8 shards on the CPU
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> None:
    """Raises AssertionError on a wrong decryption. devices: the mesh's
    devices (a device may repeat); None: every visible CUDA device."""
    from ..key import CloudKey, SecretKey
    from ..params import TEST_TINY
    from ..tlwe import lwe_decrypt_bool, lwe_decrypt_message, lwe_encrypt_bool, lwe_encrypt_message
    from .mesh import make_mesh, replicate
    from .sharded import data_parallel_gate, data_parallel_lut_bootstrap, data_parallel_mux, tensor_parallel_gate

    params = TEST_TINY
    mesh_dp = make_mesh(n_devices, devices=devices)
    first = mesh_dp.devices[0][0]
    g = torch.Generator(device=first).manual_seed(42)
    sk = SecretKey.generate(params, g)
    ck = CloudKey.generate(sk, g)

    batch = 2 * n_devices
    bits_a = np.arange(batch) % 2 == 0
    bits_b = np.arange(batch) % 3 == 0
    a = lwe_encrypt_bool(g, sk.lv0, bits_a, params.tlwe_lv0.alpha)
    b = lwe_encrypt_bool(g, sk.lv0, bits_b, params.tlwe_lv0.alpha)

    def dec_bool(ct):
        return lwe_decrypt_bool(ct, sk.lv0).cpu().numpy()

    # data parallel: the batch over all n devices, the key replicated once for the three calls
    ck_dp = replicate(ck, mesh_dp)
    out = data_parallel_gate("nand", a, b, ck_dp, mesh_dp)
    assert (dec_bool(out) == ~(bits_a & bits_b)).all(), "DP NAND decryption mismatch"
    out_mux = data_parallel_mux(a, b, b, ck_dp, mesh_dp)
    assert (dec_bool(out_mux) == np.where(bits_a, bits_b, bits_b)).all(), "DP MUX decryption mismatch"
    msgs = np.arange(batch) % 4
    ct_m = lwe_encrypt_message(g, sk.lv0, msgs, 4, params.tlwe_lv0.alpha)
    out_lut = data_parallel_lut_bootstrap(ct_m, lambda x: (x + 1) % 4, 4, ck_dp, mesh_dp)
    dec_lut = lwe_decrypt_message(out_lut, sk.lv0, 4)
    assert (dec_lut == (msgs + 1) % 4).all(), "DP LUT decryption mismatch"

    # tensor parallel: (n/2, 2), BSK gadget rows and KSK blocks over `model`
    tp = 2
    if n_devices % tp == 0 and (2 * params.trgsw_lv1.l) % tp == 0:
        mesh_tp = make_mesh(n_devices, tp=tp, devices=devices)
        out_tp = tensor_parallel_gate("nand", a, b, ck, mesh_tp)
        assert (dec_bool(out_tp) == ~(bits_a & bits_b)).all(), "TP NAND decryption mismatch"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", help="devices in the mesh (default: every visible CUDA device)")
    ap.add_argument("--devices", default=None,
                    help="one device for every shard, e.g. cpu or cuda:0 (default: the visible CUDA devices)")
    args = ap.parse_args(argv)
    if args.devices is None:
        n = args.n if args.n is not None else torch.cuda.device_count()
        devices = None
    else:
        n = args.n if args.n is not None else 8
        devices = [args.devices] * n
    dryrun_multichip(n, devices)
    print(f"dryrun_multichip({n}) OK")


if __name__ == "__main__":
    main()
