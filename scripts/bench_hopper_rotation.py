#!/usr/bin/env python3
"""Times of the whole-rotation kernel (csrc/blind_rotate.cu) per instance, and
where its two units cross over per parameter set, on one CUDA card.

Usage, from the root of a checkout:  python scripts/bench_hopper_rotation.py

1. One blind rotation at SECURITY_128_BIT_FAST for a few batches, each with
   several forced (tile, cluster) instances on the CUDA cores and, from 16
   ciphertexts up, the tensor-core instance at both its tiles: the times the
   wrapper's plan
   (`ops.cuda_blind_rotate.rotation_instance`, `rotation_unit`) is fitted to.
   Every instance's output is compared with the first one's.
2. The crossover of the two units at SECURITY_128_BIT_FAST (a key on the 2^8
   grid, three limbs), SECURITY_128_BIT (four limbs, L = 3) and
   SECURITY_128_BIT_RADIX (N = 2048): at a few batches around it, the
   CUDA-core instance the plan picks and the tensor-core instance, both
   forced and timed, beside the unit the plan takes: a row says whether the
   plan took the faster one and what the other would have cost.
Prints the card's name and power limit, then one JSON object per part.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rs_tfhe_tpu_torch import params as P  # noqa: E402
from rs_tfhe_tpu_torch.ops import cuda_blind_rotate as CBR  # noqa: E402

INSTANCES = {
    1: [(1, 16), (1, 8), (1, 4), (1, 2), (1, 1)],
    8: [(1, 8), (2, 16), (1, 16)],
    16: [(3, 16), (2, 8), (1, 4)],
    32: [(5, 16), (3, 8), (2, 4), (1, 2)],
    64: [(1, 2), (5, 8), (3, 4)],
    128: [(2, 2), (8, 8), (5, 4), (1, 1)],
    256: [(4, 2), (2, 1), (8, 4), (8, 8)],
    512: [(8, 2), (4, 1)],
    1057: [(8, 1), (1, 2), (4, 2), (8, 2)],
    4096: [(8, 1)],
}
CROSSOVER = (
    ("SECURITY_128_BIT_FAST", True, (8, 16, 24, 32, 48, 64, 128)),
    ("SECURITY_128_BIT", False, (8, 16, 24, 32, 48, 64, 128, 512)),
    ("SECURITY_128_BIT_RADIX", False, (4, 8, 12, 16, 24, 32, 64, 528)),
)


def cuda_ms(fn, reps: int = 2) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def inputs(p, batch: int, g, dev, on_grid: bool):
    def rnd(shape, lo=-(1 << 31), hi=1 << 31):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32, device=dev)

    n = p.n1
    bsk = rnd((p.n0, 2 * p.trgsw_lv1.l, 2, n))
    if on_grid:
        bsk &= ~0xFF
    return rnd((batch,), 0, 2 * n), rnd((batch, p.n0), 0, 2 * n), rnd((2, n)), bsk


def main(dev=None) -> dict:
    if not torch.cuda.is_available():
        print("bench_hopper_rotation: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    dev = dev or torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    g = torch.Generator(device=dev).manual_seed(7)
    fast = P.SECURITY_128_BIT_FAST
    print(f"clusters held at one block an SM, N=1024: {CBR.cluster_slots(dev.index or 0, 10)}")
    table = {}
    for batch, instances in INSTANCES.items():
        args = inputs(fast, batch, g, dev, on_grid=True)
        ref = None
        for tile, cluster in instances:
            out = CBR.blind_rotate_kernel(*args, fast, tile=tile, cluster=cluster)
            ref = out if ref is None else ref
            assert torch.equal(out, ref), (batch, tile, cluster)
            table[f"B={batch} tile {tile} cluster {cluster} imad"] = cuda_ms(
                lambda: CBR.blind_rotate_kernel(*args, fast, tile=tile, cluster=cluster))
        for tile in (16, 32) if batch >= 16 else ():
            out = CBR.blind_rotate_kernel(*args, fast, tile=tile, tensor_cores=True)
            assert torch.equal(out, ref), (batch, "mma", tile)
            unit = CBR.tensor_core_unit(CBR.on_wgmma(fast.n1, tile, 3), 3)
            table[f"B={batch} tile {tile} cluster 8 {unit}"] = cuda_ms(
                lambda: CBR.blind_rotate_kernel(*args, fast, tile=tile, tensor_cores=True))
    for name, ms in table.items():
        print(f"FAST {name}: {ms:.3f} ms")
    print(json.dumps({"card": smi, "instances_ms": table}))

    crossover = {}
    for name, on_grid, batches in CROSSOVER:
        p = getattr(P, name)
        for batch in batches:
            args = inputs(p, batch, g, dev, on_grid)
            limbs = CBR.key_limbs(args[3], p)
            tile, cluster, planned_limbs = CBR.planned_instance(dev.index or 0, batch, p, limbs)
            before = CBR.launched_tiles.copy()
            ref = CBR.blind_rotate_kernel(*args, p, tensor_cores=False)
            ((_, i_tile, i_cluster, _),) = (CBR.launched_tiles - before).keys()
            before = CBR.launched_tiles.copy()
            out = CBR.blind_rotate_kernel(*args, p, tensor_cores=True)
            ((_, m_tile, m_cluster, unit),) = (CBR.launched_tiles - before).keys()
            assert torch.equal(out, ref), (name, batch)
            imad_ms = cuda_ms(lambda: CBR.blind_rotate_kernel(*args, p, tensor_cores=False))
            mma_ms = cuda_ms(lambda: CBR.blind_rotate_kernel(*args, p, tensor_cores=True))
            took = "mma" if planned_limbs else "imad"
            faster = "mma" if mma_ms < imad_ms else "imad"
            crossover[f"{name} B={batch}"] = {
                "imad": [i_tile, i_cluster], "imad_ms": imad_ms, "mma": [m_tile, m_cluster, unit], "mma_ms": mma_ms,
                "plan": [tile, cluster, took], "plan_took_the_faster": took == faster,
            }
            print(f"{name} B={batch}: CUDA cores (tile {i_tile}, cluster {i_cluster}) {imad_ms:.2f} ms, tensor cores "
                  f"(tile {m_tile}, cluster {m_cluster}, {unit}) {mma_ms:.2f} ms; the plan takes {took}"
                  f"{'' if took == faster else f', the slower by {abs(imad_ms - mma_ms):.2f} ms'}")
    print(json.dumps({"card": smi, "crossover": crossover}))
    return {"instances_ms": table, "crossover": crossover}


if __name__ == "__main__":
    main()
