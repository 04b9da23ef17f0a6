"""Multi-device gate evaluation with the PyTorch port: data parallel and
tensor parallel (the counterpart of examples/multi_chip_scaling.py, itself
the replacement for the reference's Railgun thread-pool examples:
custom_railgun.rs, batch_gates_scaling.rs).

On every visible CUDA device by default; --cpu runs on a mesh of 8 CPU
devices (the counterpart of XLA's 8 virtual CPU devices):

    python examples/torch/multi_chip_scaling.py --params SECURITY_128_BIT_FAST --batch 1024
    python examples/torch/multi_chip_scaling.py --cpu --batch 16
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import rs_tfhe_tpu_torch as tfhe  # noqa: E402
from rs_tfhe_tpu_torch.key import CloudKey, SecretKey  # noqa: E402
from rs_tfhe_tpu_torch.parallel import data_parallel_gate, make_mesh, tensor_parallel_gate  # noqa: E402
from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_bool, lwe_encrypt_bool  # noqa: E402


def timed(label, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    if out.is_cuda:
        torch.cuda.synchronize()
    print(f"{label}: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--params", default="TEST_TINY", choices=["TEST_TINY", *tfhe.ALL_SECURITY_SETS],
                    help="parameter set (TEST_TINY runs in seconds on the CPU)")
    ap.add_argument("--cpu", action="store_true", help="a mesh of 8 CPU devices")
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args(argv)
    params = tfhe.TEST_TINY if args.params == "TEST_TINY" else tfhe.ALL_SECURITY_SETS[args.params]
    # None: every visible CUDA device, raising without one
    mesh = make_mesh(devices=["cpu"] * 8 if args.cpu else None)
    n_dev = len(mesh.flat)
    first = mesh.devices[0][0]
    print(f"{n_dev} device(s): {', '.join(str(d) for d in mesh.flat)}")

    g = torch.Generator(device=first).manual_seed(0)
    sk = SecretKey.generate(params, g)
    ck = CloudKey.generate(sk, g)
    rng = np.random.default_rng(0)
    bits_a = rng.integers(0, 2, args.batch).astype(bool)
    bits_b = rng.integers(0, 2, args.batch).astype(bool)
    a = lwe_encrypt_bool(g, sk.lv0, bits_a, params.tlwe_lv0.alpha)
    b = lwe_encrypt_bool(g, sk.lv0, bits_b, params.tlwe_lv0.alpha)

    out = timed(f"data-parallel NAND over {n_dev} devices", data_parallel_gate, "nand", a, b, ck, mesh)
    assert (lwe_decrypt_bool(out, sk.lv0).cpu().numpy() == ~(bits_a & bits_b)).all()

    tp = 2
    if n_dev % tp == 0 and (2 * params.trgsw_lv1.l) % tp == 0 and args.batch % (n_dev // tp) == 0:
        mesh_tp = make_mesh(tp=tp, devices=list(mesh.flat))
        out = timed(f"tensor-parallel NAND ({n_dev // tp} x {tp} mesh)", tensor_parallel_gate, "nand", a, b, ck,
                    mesh_tp)
        assert (lwe_decrypt_bool(out, sk.lv0).cpu().numpy() == ~(bits_a & bits_b)).all()
    print("OK")


if __name__ == "__main__":
    main()
