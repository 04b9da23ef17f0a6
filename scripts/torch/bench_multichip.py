"""Multi-device scaling harness of the PyTorch port: the counterpart of
scripts/bench_multichip.py, with its points, timing and artifact keys.

On a (batch[, model]) mesh of 1..N devices (rs_tfhe_tpu_torch.parallel):
  - data-parallel NAND throughput (`data_parallel_gate`, no collectives):
    strong scaling at a fixed total batch (4096 on the card, 512 on the CPU)
    and weak scaling at a fixed batch a device (2048 on the card, 128 on the
    CPU);
  - tensor-parallel against data-parallel latency at B in {1, 8, 64}
    (`tensor_parallel_gate`: the bootstrapping key's gadget rows and the
    key-switching key's blocks sharded over the model axis, K5 at
    J = 2L/tp rows a shard on the card), tp the largest power of two up to
    N that divides 2L and the ring size.
Every point is decrypted against numpy. Timing (scripts/bench_multichip.py:
76-86): one warm call to the barrier, then the best of 2 runs of `iters`
calls (3; 2 for the latency points), over `iters`.

With two or more CUDA cards visible the mesh spans them (`"virtual":
false`). With one card (or --cpu) it is that device repeated,
RS_TFHE_SCALING_DEVICES times (default 8, the JAX script's virtual CPU
mesh): its shards run one after another on the one device, so every row is
marked `"virtual": true` and the numbers measure the sharding layer's
overhead, not scaling across cards.

    python scripts/torch/bench_multichip.py                     # on the card(s)
    python scripts/torch/bench_multichip.py --cpu               # TEST_TINY on 8 virtual CPU devices

Environment, as the JAX script: RS_TFHE_SCALING_PARAMS (default TEST_TINY on
the CPU, SECURITY_128_BIT_FAST on the card), RS_TFHE_SCALING_DEVICES (the
device count, or the virtual mesh's size), RS_TFHE_SCALING_OUT (default
SCALING_torch_h100.json at the repo root on the card; on the CPU nothing is
written unless it is given). Prints the artifact as one JSON line.
Without --cpu it runs on the card and raises where there is none.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench_common import (  # noqa: E402
    ROOT, card_fields, device_of, generator, launched_since, launches, log, min_time, params_by_name,
    write_json,
)

from rs_tfhe_tpu_torch.key import CloudKey, SecretKey  # noqa: E402
from rs_tfhe_tpu_torch.parallel.mesh import make_mesh, pad_to_multiple, replicate  # noqa: E402
from rs_tfhe_tpu_torch.parallel.sharded import data_parallel_gate, shard_key, tensor_parallel_gate  # noqa: E402
from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_bool, lwe_encrypt_bool  # noqa: E402

OUT = os.path.join(ROOT, "SCALING_torch_h100.json")
VIRTUAL_DEVICES = 8
TP_BATCHES = (1, 8, 64)


def _time(fn, *args, iters: int = 3) -> float:
    """Seconds a call: a warm call, then the best of 2 runs of `iters` calls."""
    def run():
        out = None
        for _ in range(iters):
            out = fn(*args)
        return out

    return min_time(run, 2) / iters


def mesh_devices(device: torch.device) -> tuple[list, bool]:
    """(the devices the meshes draw from, virtual): every CUDA card where two
    or more are visible, else `device` repeated."""
    if device.type == "cuda" and torch.cuda.device_count() >= 2:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())], False
    n = int(os.environ.get("RS_TFHE_SCALING_DEVICES", str(VIRTUAL_DEVICES)))
    return [device] * n, True


def run(device, n_devices: int | None = None, total_b: int | None = None, per_dev: int | None = None,
        tp_batches=TP_BATCHES, pname: str | None = None) -> dict:
    """The artifact: strong and weak data-parallel scaling and the TP-vs-DP
    latency rows, each point decrypted (scripts/bench_multichip.py:89-194)."""
    on_card = device.type == "cuda"
    devices, virtual = mesh_devices(device)
    n_avail = len(devices)
    n_max = min(n_devices or int(os.environ.get("RS_TFHE_SCALING_DEVICES", str(n_avail))), n_avail)
    pname = pname or os.environ.get("RS_TFHE_SCALING_PARAMS", "SECURITY_128_BIT_FAST" if on_card else "TEST_TINY")
    params = params_by_name(pname)
    log(f"platform={device.type} devices={n_max} params={pname} virtual={virtual}")

    sk = SecretKey.generate(params, generator(device, 42))
    ck = CloudKey.generate(sk, generator(device, 7))
    rng = np.random.default_rng(0)

    def enc_pair(batch: int):
        bits_a = rng.integers(0, 2, batch).astype(bool)
        bits_b = rng.integers(0, 2, batch).astype(bool)
        a = lwe_encrypt_bool(generator(device, 1), sk.lv0, bits_a, params.tlwe_lv0.alpha)
        b = lwe_encrypt_bool(generator(device, 2), sk.lv0, bits_b, params.tlwe_lv0.alpha)
        return a, b, bits_a, bits_b

    def check(out, bits_a, bits_b) -> float:
        dec = lwe_decrypt_bool(out, sk.lv0).cpu().numpy()
        return float((dec == ~(bits_a & bits_b)).mean())

    def dp_point(nd: int, a, b, iters: int = 3):
        mesh = make_mesh(nd, devices=devices)
        keys = replicate(ck, mesh)
        before = launches()
        dt = _time(lambda x, y: data_parallel_gate("nand", x, y, keys, mesh), a, b, iters=iters)
        return dt, data_parallel_gate("nand", a, b, keys, mesh), launched_since(before)

    device_counts = [d for d in (1, 2, 4, 8, 16, 32, 64) if d <= n_max]
    total_b = total_b or (4096 if on_card else 512)
    a, b, bits_a, bits_b = enc_pair(total_b)
    strong = []
    for nd in device_counts:
        dt, out, kernels = dp_point(nd, a, b)
        rate = total_b / dt
        strong.append({"devices": nd, "gates_per_sec": round(rate, 1), "correctness": check(out, bits_a, bits_b),
                       "virtual": virtual, "kernels": kernels})
        log(f"  DP strong n={nd}: {rate:,.0f} gates/s corr={strong[-1]['correctness']} kernels {kernels}")

    per_dev = per_dev or (2048 if on_card else 128)
    weak = []
    for nd in device_counts:
        aw, bw, wa, wb = enc_pair(per_dev * nd)
        dt, out, kernels = dp_point(nd, aw, bw)
        rate = per_dev * nd / dt
        weak.append({"devices": nd, "batch": per_dev * nd, "gates_per_sec": round(rate, 1),
                     "correctness": check(out, wa, wb), "virtual": virtual, "kernels": kernels})
        log(f"  DP weak n={nd} (B={per_dev * nd}): {rate:,.0f} gates/s corr={weak[-1]['correctness']}")

    g = params.trgsw_lv1
    tp_size = n_max  # the model axis must divide 2L and N
    while tp_size > 1 and ((2 * g.l) % tp_size or params.n1 % tp_size):
        tp_size //= 2
    tp_rows = []
    for batch in tp_batches:
        at, bt, ta, tb = enc_pair(batch)
        dt_dp, out_dp, _ = dp_point(n_max, at, bt, iters=2)
        row = {"batch": batch, "dp_latency_ms": round(dt_dp * 1e3, 2), "dp_correctness": check(out_dp, ta, tb),
               "virtual": virtual}
        if tp_size > 1:
            mesh_tp = make_mesh(n_max, tp=tp_size, devices=devices)
            sharded = shard_key(ck, mesh_tp)
            atp, _ = pad_to_multiple(at, n_max // tp_size)
            btp, _ = pad_to_multiple(bt, n_max // tp_size)
            before = launches()
            dt_tp = _time(lambda x, y: tensor_parallel_gate("nand", x, y, sharded, mesh_tp), atp, btp, iters=2)
            row["tp_kernels"] = launched_since(before)
            out_tp = tensor_parallel_gate("nand", atp, btp, sharded, mesh_tp)[:batch]
            row["tp_latency_ms"] = round(dt_tp * 1e3, 2)
            row["tp_model_axis"] = tp_size
            row["tp_correctness"] = check(out_tp, ta, tb)
            row["tp_wins"] = bool(dt_tp < dt_dp)
        tp_rows.append(row)
        log(f"  latency B={batch}: {row}")

    return {
        "platform": "gpu" if on_card else "cpu",
        "virtual": virtual,
        "params": pname,
        "devices_available": torch.cuda.device_count() if on_card else n_avail,
        "dp_strong_scaling": strong,
        "dp_weak_scaling": weak,
        "tp_vs_dp_latency": tp_rows,
        "note": (
            f"virtual: a mesh of {n_avail} shares of one {device.type} device, whose shards run one after "
            "another; correctness and the sharding layer's overhead, not scaling across devices"
            if virtual else "real hardware: one mesh device a card"
        ),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (virtual devices, the plain versions)")
    args = ap.parse_args(argv)
    device = device_of(args.cpu)
    out = run(device)
    fields = card_fields(device)
    out.update(fields)
    path = os.environ.get("RS_TFHE_SCALING_OUT") or (OUT if device.type == "cuda" else None)
    if path:
        write_json(path, {**out, "ts": time.time()})
        log(f"wrote {path}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
