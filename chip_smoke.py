#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rs_tfhe_tpu_torch) on one CUDA card.

Usage, from the root of a checkout:  python3 chip_smoke.py

Phases (each prints on stdout; any failure raises and exits non-zero before
the last line):
  1. environment: torch/CUDA versions and the card's name and power limit;
     exits non-zero when no CUDA device is available;
  2. build: compiles the hand-written kernels from csrc/ (nvcc, sm_90a);
  3. kernel against its plain PyTorch version on the card, bit for bit, at
     SECURITY_128_BIT_FAST (B = 1, 8, 8 with per-ciphertext test vectors,
     4096; a grid-sampled key) and SECURITY_128_BIT (B = 4, 512), with
     both times;
  4. the card against the JAX package through the committed fixture
     tests/vectors/torch_port_tiny.npz (TEST_TINY, bit for bit);
  5. the main path at full width, SECURITY_128_BIT_FAST: keygen on the card,
     4096 encrypted bit pairs through batch_gate("nand"), decrypted 100%
     correct, gates/s, and B = 1 latency as the slope between chains of 5
     and 25 dependent gates (minimum over repeats);
  6. the same at SECURITY_128_BIT with B = 512.
The kernel launch counts are zeroed just before phase 5 and read just after
phase 6; every kernel of the path must have launched. The line before the
last is a JSON object of kernels (launches, max error against the plain
version, times); the last line is the contract JSON with the device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "vectors", "torch_port_tiny.npz")
SEED = 1234


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` runs after one warm-up run."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_environment() -> str:
    print(f"[1] python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[1] device 0: {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible")
    return smi


def phase_build():
    from rs_tfhe_tpu_torch import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    print(f"[2] kernels built and loaded in {time.perf_counter() - t0:.2f} s: {os.path.relpath(path, ROOT)}")
    log = (path.parent / "build.log").read_text().splitlines()
    regs = [int(line.split("Used ")[1].split()[0]) for line in log if "registers" in line]
    spills = [line.strip() for line in log if "spill" in line and "0 bytes spill stores" not in line]
    print(f"[2] ptxas: {len(regs)} kernel instances, at most {max(regs)} registers per thread, "
          f"{len(spills)} with spills")
    for line in spills:
        print(f"[2]   {line}")


def phase_kernel_vs_plain(dev) -> dict:
    from rs_tfhe_tpu_torch import params as P
    from rs_tfhe_tpu_torch.key import SecretKey, gen_bootstrapping_key
    from rs_tfhe_tpu_torch.ops.blind_rotate import blind_rotate_plain
    from rs_tfhe_tpu_torch.ops.cuda_blind_rotate import blind_rotate_kernel

    g = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(shape, lo=-(1 << 31), hi=1 << 31):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32, device=dev)

    fast_bsk = gen_bootstrapping_key(g, SecretKey.generate(P.SECURITY_128_BIT_FAST, g))
    check(int((fast_bsk & 0xFF).abs().max()) == 0, "FAST bootstrapping key is on the 2^8 grid")
    p_strict = P.SECURITY_128_BIT
    strict_bsk = rnd((p_strict.n0, 2 * p_strict.trgsw_lv1.l, 2, p_strict.n1))
    cases = [
        (P.SECURITY_128_BIT_FAST, fast_bsk, 1, False),
        (P.SECURITY_128_BIT_FAST, fast_bsk, 8, False),
        (P.SECURITY_128_BIT_FAST, fast_bsk, 8, True),
        (P.SECURITY_128_BIT_FAST, fast_bsk, 4096, False),
        (p_strict, strict_bsk, 4, False),
        (p_strict, strict_bsk, 512, False),
    ]
    max_err, rows = 0, {}
    for p, bsk, batch, per_ct in cases:
        n = p.n1
        tv = rnd((batch, 2, n) if per_ct else (2, n))
        b_til, a_til = rnd((batch,), 0, 2 * n), rnd((batch, p.n0), 0, 2 * n)
        out = blind_rotate_kernel(b_til, a_til, tv, bsk, p)
        ref = blind_rotate_plain(b_til, a_til, tv, bsk, p)
        torch.cuda.synchronize()
        err = int(((out.to(torch.int64) & 0xFFFFFFFF) - (ref.to(torch.int64) & 0xFFFFFFFF)).abs().max())
        max_err = max(max_err, err)
        reps = 1 if batch >= 512 else 3
        k_ms = cuda_ms(lambda: blind_rotate_kernel(b_til, a_til, tv, bsk, p), reps)
        p_ms = cuda_ms(lambda: blind_rotate_plain(b_til, a_til, tv, bsk, p), reps)
        name = "FAST" if p is P.SECURITY_128_BIT_FAST else "strict"
        print(
            f"[3] blind_rotate {name} B={batch} testvec={'per-ct' if per_ct else 'shared'}: "
            f"equal={torch.equal(out, ref)} max_abs_err={err} kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms"
        )
        check(torch.equal(out, ref), f"kernel == plain at {name} B={batch}")
        rows[(name, batch, per_ct)] = (k_ms, p_ms)
    k_ms, p_ms = rows[("FAST", 4096, False)]
    return {"max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms}


def phase_fixture(dev) -> None:
    from rs_tfhe_tpu_torch import gates, key
    from rs_tfhe_tpu_torch.ops.blind_rotate import blind_rotate
    from rs_tfhe_tpu_torch.ops.extract import sample_extract
    from rs_tfhe_tpu_torch.ops.keyswitch import identity_key_switch
    from rs_tfhe_tpu_torch.params import TEST_TINY
    from rs_tfhe_tpu_torch.torus import to_numpy, to_torch

    v = np.load(FIXTURE)
    ck = key.cloud_key_from_numpy(v, TEST_TINY, dev)
    a, b, c = (to_torch(v[n], dev) for n in ("ct_a", "ct_b", "ct_c"))
    acc = blind_rotate(a, ck.testvec, ck.bsk, TEST_TINY)
    lv1 = sample_extract(acc, 0)
    outputs = {
        "blind_rotate": acc,
        "sample_extract": lv1,
        "identity_key_switch": identity_key_switch(lv1, ck.ksk_limbs, TEST_TINY),
        "nand": gates.nand(a, b, ck),
        "mux": gates.mux(a, b, c, ck),
    }
    for name, out in outputs.items():
        check(out.is_cuda, f"{name} ran on the card")
        same = np.array_equal(to_numpy(out), v[name])
        print(f"[4] TEST_TINY {name} on the card == JAX fixture: {same}")
        check(same, f"{name} equals the JAX fixture")


def run_main_path(p, batch: int, dev, label: str) -> dict:
    """Keygen, encryption, batch NAND and decryption on the card; gates/s
    and the B = 1 latency slope."""
    from rs_tfhe_tpu_torch import gates
    from rs_tfhe_tpu_torch.key import CloudKey, SecretKey
    from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_bool, lwe_encrypt_bool

    def keygen(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        t0 = time.perf_counter()
        sk = SecretKey.generate(p, g)
        ck = CloudKey.generate(sk, g)
        torch.cuda.synchronize()
        return sk, ck, g, (time.perf_counter() - t0) * 1e3

    _, _, _, cold_ms = keygen(SEED + 1)
    sk, ck, g, warm_ms = keygen(SEED + 2)
    rng = np.random.default_rng(SEED)
    bits_a = rng.integers(0, 2, batch).astype(bool)
    bits_b = rng.integers(0, 2, batch).astype(bool)
    a = lwe_encrypt_bool(g, sk.lv0, bits_a, p.tlwe_lv0.alpha)
    b = lwe_encrypt_bool(g, sk.lv0, bits_b, p.tlwe_lv0.alpha)

    t0 = time.perf_counter()
    out = gates.batch_gate("nand", a, b, ck)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    dec = lwe_decrypt_bool(out, sk.lv0).cpu().numpy()
    correct = float((dec == ~(bits_a & bits_b)).mean())
    print(f"[{label}] keygen cold {cold_ms:.1f} ms, warm {warm_ms:.1f} ms; "
          f"first batch NAND B={batch}: {first_s:.3f} s, correctness {correct:.6f}")
    check(correct == 1.0, f"{label}: every NAND of the batch decrypts correctly")

    iters = 3
    expect = bits_a
    t0 = time.perf_counter()
    cur = a
    for _ in range(iters):
        cur = gates.batch_gate("nand", cur, b, ck)
        expect = ~(expect & bits_b)
    torch.cuda.synchronize()
    per_iter = (time.perf_counter() - t0) / iters
    chain_ok = float((lwe_decrypt_bool(cur, sk.lv0).cpu().numpy() == expect).mean())
    check(chain_ok == 1.0, f"{label}: chained batch NANDs decrypt correctly")
    gates_per_s = batch / per_iter

    a1, b1 = a[:1], b[:1]

    def chain_s(n, repeats=3):
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            cur = a1
            for _ in range(n):
                cur = gates.nand(cur, b1, ck)
            _ = int(cur[0, -1].item())
            best = min(best, time.perf_counter() - t0)
        return best

    chain_s(1, repeats=1)  # warm
    t5, t25 = chain_s(5), chain_s(25)
    latency_ms = (t25 - t5) / 20 * 1e3
    print(f"[{label}] {gates_per_s:.1f} gates/s at B={batch} ({per_iter * 1e3:.1f} ms per batch, "
          f"{iters} chained); B=1 latency {latency_ms:.2f} ms (chains 5/25: "
          f"{t5 * 1e3:.1f}/{t25 * 1e3:.1f} ms)")
    return {"gates_per_s": gates_per_s, "latency_ms_b1": latency_ms,
            "keygen_warm_ms": warm_ms, "correctness": correct}


def main() -> int:
    smi = phase_environment()
    import rs_tfhe_tpu_torch  # noqa: F401  (fails outside a checkout)
    from rs_tfhe_tpu_torch import params as P
    from rs_tfhe_tpu_torch.ops import cuda_blind_rotate

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    compare = phase_kernel_vs_plain(dev)
    phase_fixture(dev)

    cuda_blind_rotate.launches = 0
    fast = run_main_path(P.SECURITY_128_BIT_FAST, 4096, dev, "5")
    strict = run_main_path(P.SECURITY_128_BIT, 512, dev, "6")
    launches = cuda_blind_rotate.launches
    print(f"[5-6] blind_rotate kernel launches on the main path: {launches}; "
          f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; card: {smi}")
    check(launches > 0, "the main path launched the blind-rotation kernel")

    print(json.dumps({
        "kernels": [{
            "name": "blind_rotate",
            "route": "cuda",
            "source": "rs_tfhe_tpu_torch/csrc/blind_rotate.cu",
            "replaces": "rs_tfhe_tpu/ops/pallas_blind_rotate.py:929",
            "also_replaces": [
                "rs_tfhe_tpu/ops/pallas_blind_rotate.py:828",
                "rs_tfhe_tpu/ops/pallas_blind_rotate.py:725",
            ],
            "launches": launches,
            "max_abs_err": compare["max_abs_err"],
            "ms": compare["ms"],
            "plain_ms": compare["plain_ms"],
        }],
        "main_path": {"SECURITY_128_BIT_FAST_B4096": fast, "SECURITY_128_BIT_B512": strict},
    }))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
