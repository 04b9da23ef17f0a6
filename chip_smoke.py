#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rs_tfhe_tpu_torch) on one CUDA card.

Usage, from the root of a checkout:  python3 chip_smoke.py

Phases (each prints on stdout; any failure raises and exits non-zero before
the last line):
  1. environment: torch/CUDA versions and the card's name and power limit;
     exits non-zero when no CUDA device is available;
  2. build: compiles the hand-written kernels from csrc/ (nvcc, sm_90a), one
     nvcc per source, all started together;
  3. each kernel against its plain PyTorch version on the card, bit for bit,
     with both times (CUDA events), and the (N, tile) instantiation each case
     launched:
       3a the blind rotation at SECURITY_128_BIT_FAST (B = 1, 8, 8 with
          per-ciphertext test vectors, 4096; a grid-sampled key),
          SECURITY_128_BIT (B = 4, 512), SECURITY_UINT4 (B = 8, 22-bit
          digits) and SECURITY_128_BIT_RADIX (B = 528, N = 2048);
       3b the multi-bit rotation at FAST (B = 1, 2, 8, shared and
          per-ciphertext test vectors, 1024, a grid-sampled multi-bit key),
          strict B = 4 and 512, SECURITY_128_BIT_RADIX B = 1 and 264 and
          SECURITY_128_BIT_NIBBLE B = 1;
       3c the external-product step at FAST B = 2048, strict B = 512 and
          UINT4 B = 8;
       3d both rotation kernels per rotation at a few batches of FAST,
          strict and RADIX: the multi-bit kernel is the faster, which is why
          a multi-bit key takes it at every batch;
  4. the card against the JAX package through the committed fixtures
     tests/vectors/torch_port_tiny.npz and torch_port_tiny_mb.npz (TEST_TINY,
     bit for bit);
  5. the gate path at full width, SECURITY_128_BIT_FAST: keygen on the card,
     4096 encrypted bit pairs through batch_gate("nand"), decrypted 100%
     correct, gates/s, and B = 1 latency as the slope between chains of 5
     and 25 dependent gates (minimum over repeats);
  6. the same at SECURITY_128_BIT with B = 512;
  7. multi-bit gates: keygen with multibit=True on the card at FAST and
     strict, NAND and XOR batches (B = 4096 FAST, 512 strict), gates/s and
     the B = 1 latency slope through the auto route, every gate decrypted
     correctly;
  8. programmable bootstrapping at SECURITY_128_BIT_RADIX with a multi-bit
     key: B = 2048 messages mod 8 through LutBootstrap().bootstrap_func with
     (3v) mod 8, 100% correct, PBS/s, and one bootstrap split by stage
     (CUDA events) and by kernel (torch.profiler); the same batch with
     allow_mb=False (the whole-rotation kernel); B = 256 with a
     per-ciphertext LUT through bootstrap_with_testvec; B = 1 and 2 through
     the multi-bit route, time per PBS;
  9. step_impl="pallas": a FAST NAND batch at B = 4096 through the
     per-step route equals the default route's output bit for bit.
Each path of phases 5-9 is driven with the kernels' launch counts set to 0
just before it and read just after; every kernel of a path must have
launched, and every (N, tile) instantiation a path launched must be one
that phase 3 held against the plain version. The line before the last is a JSON object of the kernels
(launches, max error against the plain version, times); the last line is
the contract JSON with the device.
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
FIXTURE_MB = os.path.join(ROOT, "tests", "vectors", "torch_port_tiny_mb.npz")
SEED = 1234
T_START = time.perf_counter()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def elapsed() -> str:
    return f"(t = {time.perf_counter() - T_START:.1f} s)"


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


def timed(fn):
    """(fn(), device ms of that one call)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def launched_tile(module, fn):
    """(fn(), the (N, tile) instantiation of `module`'s kernel it launched):
    fn must launch that kernel exactly once."""
    before = module.launched_tiles.copy()
    out = fn()
    (key,) = (module.launched_tiles - before).keys()
    return out, key


def tile_list(tiles) -> list:
    return [list(t) for t in sorted(tiles)]


def max_abs_err(out: torch.Tensor, ref: torch.Tensor) -> int:
    return int(((out.to(torch.int64) & 0xFFFFFFFF) - (ref.to(torch.int64) & 0xFFFFFFFF)).abs().max())


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
          f"{len(spills)} with spills {elapsed()}")
    for line in spills:
        print(f"[2]   {line}")


def _rnd(g, dev):
    def rnd(shape, lo=-(1 << 31), hi=1 << 31):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32, device=dev)

    return rnd


def _name(p) -> str:
    from rs_tfhe_tpu_torch import params as P

    return {v: k for k, v in P.ALL_SECURITY_SETS.items()}[p].removeprefix("SECURITY_")


def phase_kernel_vs_plain(dev) -> dict:
    from rs_tfhe_tpu_torch import params as P
    from rs_tfhe_tpu_torch.key import SecretKey, gen_bootstrapping_key
    from rs_tfhe_tpu_torch.ops import cuda_blind_rotate
    from rs_tfhe_tpu_torch.ops.blind_rotate import blind_rotate_plain
    from rs_tfhe_tpu_torch.ops.cuda_blind_rotate import blind_rotate_kernel

    g = torch.Generator(device=dev).manual_seed(SEED)
    rnd = _rnd(g, dev)
    fast_bsk = gen_bootstrapping_key(g, SecretKey.generate(P.SECURITY_128_BIT_FAST, g))
    check(int((fast_bsk & 0xFF).abs().max()) == 0, "FAST bootstrapping key is on the 2^8 grid")
    p_strict, p_uint4, p_radix = P.SECURITY_128_BIT, P.SECURITY_UINT4, P.SECURITY_128_BIT_RADIX
    strict_bsk = rnd((p_strict.n0, 2 * p_strict.trgsw_lv1.l, 2, p_strict.n1))
    uint4_bsk = rnd((p_uint4.n0, 2 * p_uint4.trgsw_lv1.l, 2, p_uint4.n1))
    radix_bsk = rnd((p_radix.n0, 2 * p_radix.trgsw_lv1.l, 2, p_radix.n1))
    cases = [
        (P.SECURITY_128_BIT_FAST, fast_bsk, 1, False),
        (P.SECURITY_128_BIT_FAST, fast_bsk, 8, False),
        (P.SECURITY_128_BIT_FAST, fast_bsk, 8, True),
        (P.SECURITY_128_BIT_FAST, fast_bsk, 4096, False),
        (p_strict, strict_bsk, 4, False),
        (p_strict, strict_bsk, 512, False),
        (p_uint4, uint4_bsk, 8, False),
        (p_radix, radix_bsk, 528, False),  # N = 2048, tile 4: the allow_mb=False PBS of phase 8
    ]
    max_err, rows, tiles = 0, {}, set()
    for p, bsk, batch, per_ct in cases:
        n = p.n1
        tv = rnd((batch, 2, n) if per_ct else (2, n))
        b_til, a_til = rnd((batch,), 0, 2 * n), rnd((batch, p.n0), 0, 2 * n)
        out, tile = launched_tile(cuda_blind_rotate, lambda: blind_rotate_kernel(b_til, a_til, tv, bsk, p))
        tiles.add(tile)
        if n >= 2048:  # the plain version is costly here: one timed call each
            k_ms = timed(lambda: blind_rotate_kernel(b_til, a_til, tv, bsk, p))[1]
            ref, p_ms = timed(lambda: blind_rotate_plain(b_til, a_til, tv, bsk, p))
        else:
            ref = blind_rotate_plain(b_til, a_til, tv, bsk, p)
            reps = 1 if batch >= 512 else 3
            k_ms = cuda_ms(lambda: blind_rotate_kernel(b_til, a_til, tv, bsk, p), reps)
            p_ms = cuda_ms(lambda: blind_rotate_plain(b_til, a_til, tv, bsk, p), reps)
        torch.cuda.synchronize()
        err = max_abs_err(out, ref)
        max_err = max(max_err, err)
        name = _name(p)
        print(
            f"[3a] blind_rotate {name} B={batch} testvec={'per-ct' if per_ct else 'shared'} "
            f"(N={tile[0]}, tile {tile[1]}): equal={torch.equal(out, ref)} max_abs_err={err} "
            f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms"
        )
        check(torch.equal(out, ref), f"kernel == plain at {name} B={batch}")
        rows[(name, batch, per_ct)] = (k_ms, p_ms)
    k_ms, p_ms = rows[("128_BIT_FAST", 4096, False)]
    print(f"[3a] done {elapsed()}")
    return {"max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms, "tiles_compared": tile_list(tiles)}


def phase_mb_kernel_vs_plain(dev) -> dict:
    from rs_tfhe_tpu_torch import params as P
    from rs_tfhe_tpu_torch.key import SecretKey, gen_bootstrapping_key_mb
    from rs_tfhe_tpu_torch.ops import cuda_blind_rotate_mb
    from rs_tfhe_tpu_torch.ops.blind_rotate import blind_rotate_mb_plain
    from rs_tfhe_tpu_torch.ops.cuda_blind_rotate_mb import blind_rotate_mb_kernel

    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    rnd = _rnd(g, dev)
    fast = P.SECURITY_128_BIT_FAST
    fast_mb = gen_bootstrapping_key_mb(g, SecretKey.generate(fast, g))
    check(int((fast_mb & 0xFF).abs().max()) == 0, "FAST multi-bit key is on the 2^8 grid")

    def random_key(p):
        return rnd((p.n0 // 2, 4, 2 * p.trgsw_lv1.l, 2, p.n1))

    strict_mb, radix_mb = random_key(P.SECURITY_128_BIT), random_key(P.SECURITY_128_BIT_RADIX)
    cases = [
        (fast, fast_mb, 1, False), (fast, fast_mb, 2, False), (fast, fast_mb, 2, True),
        (fast, fast_mb, 8, False), (fast, fast_mb, 8, True),
        (fast, fast_mb, 1024, False),  # tile 4: the B=4096 gates of phase 7
        (P.SECURITY_128_BIT, strict_mb, 4, False),
        (P.SECURITY_128_BIT, strict_mb, 512, False),  # tile 2: the B=512 gates of phase 7
        (P.SECURITY_128_BIT_RADIX, radix_mb, 1, False),
        (P.SECURITY_128_BIT_RADIX, radix_mb, 264, False),  # N = 2048, tile 2: the B=2048 PBS of phase 8
        (P.SECURITY_128_BIT_NIBBLE, random_key(P.SECURITY_128_BIT_NIBBLE), 1, False),
    ]
    max_err, rows, tiles = 0, {}, set()
    for p, key, batch, per_ct in cases:
        n = p.n1
        tv = rnd((batch, 2, n) if per_ct else (2, n))
        b_til, a_til = rnd((batch,), 0, 2 * n), rnd((batch, p.n0), 0, 2 * n)
        out, tile = launched_tile(cuda_blind_rotate_mb, lambda: blind_rotate_mb_kernel(b_til, a_til, tv, key, p))
        tiles.add(tile)
        name = _name(p)
        if n >= 2048 or batch >= 512:  # the plain version is costly here: one timed call each
            k_ms = timed(lambda: blind_rotate_mb_kernel(b_til, a_til, tv, key, p))[1]
            ref, p_ms = timed(lambda: blind_rotate_mb_plain(b_til, a_til, tv, key, p))
        else:
            ref = blind_rotate_mb_plain(b_til, a_til, tv, key, p)
            k_ms = cuda_ms(lambda: blind_rotate_mb_kernel(b_til, a_til, tv, key, p), 3)
            p_ms = cuda_ms(lambda: blind_rotate_mb_plain(b_til, a_til, tv, key, p), 3)
        torch.cuda.synchronize()
        err = max_abs_err(out, ref)
        max_err = max(max_err, err)
        print(
            f"[3b] blind_rotate_mb {name} B={batch} testvec={'per-ct' if per_ct else 'shared'} "
            f"(N={tile[0]}, tile {tile[1]}): equal={torch.equal(out, ref)} max_abs_err={err} "
            f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms"
        )
        check(torch.equal(out, ref), f"multi-bit kernel == plain at {name} B={batch}")
        rows[(name, batch, per_ct)] = (k_ms, p_ms)
    k_ms, p_ms = rows[("128_BIT_FAST", 1, False)]
    print(f"[3b] done {elapsed()}")
    return {"max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms, "tiles_compared": tile_list(tiles)}


def phase_step_kernel_vs_plain(dev) -> dict:
    from rs_tfhe_tpu_torch import params as P
    from rs_tfhe_tpu_torch.ops import cuda_step
    from rs_tfhe_tpu_torch.ops.cuda_step import external_product_kernel
    from rs_tfhe_tpu_torch.ops.poly import polymul_small_by_torus

    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    rnd = _rnd(g, dev)
    max_err, rows, tiles = 0, {}, set()
    for p, batch in ((P.SECURITY_128_BIT_FAST, 2048), (P.SECURITY_128_BIT, 512), (P.SECURITY_UINT4, 8)):
        gp, n = p.trgsw_lv1, p.n1
        digits = rnd((batch, 2 * gp.l, n), -gp.half_bg, gp.half_bg)
        trgsw = rnd((2 * gp.l, 2, n))
        out, tile = launched_tile(cuda_step, lambda: external_product_kernel(digits, trgsw, p))
        tiles.add(tile)
        ref = polymul_small_by_torus(digits, trgsw, gp.half_bg)
        torch.cuda.synchronize()
        err = max_abs_err(out, ref)
        max_err = max(max_err, err)
        k_ms = cuda_ms(lambda: external_product_kernel(digits, trgsw, p), 5)
        p_ms = cuda_ms(lambda: polymul_small_by_torus(digits, trgsw, gp.half_bg), 5)
        name = _name(p)
        print(f"[3c] external_product {name} B={batch} (N={tile[0]}, tile {tile[1]}): "
              f"equal={torch.equal(out, ref)} max_abs_err={err} kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
        check(torch.equal(out, ref), f"step kernel == plain at {name} B={batch}")
        rows[name] = (k_ms, p_ms)
    k_ms, p_ms = rows["128_BIT_FAST"]
    print(f"[3c] done {elapsed()}")
    return {"max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms, "tiles_compared": tile_list(tiles)}


def phase_crossover(dev) -> dict:
    """Both rotation kernels per rotation at a few batches: the multi-bit
    kernel is the faster, which is why a multi-bit key takes it at every
    batch (ops.blind_rotate)."""
    from rs_tfhe_tpu_torch import params as P
    from rs_tfhe_tpu_torch.ops.cuda_blind_rotate import blind_rotate_kernel
    from rs_tfhe_tpu_torch.ops.cuda_blind_rotate_mb import blind_rotate_mb_kernel

    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    rnd = _rnd(g, dev)
    table = {}
    plan = (
        (P.SECURITY_128_BIT_FAST, (1, 256, 4096)),
        (P.SECURITY_128_BIT, (1, 512)),
        (P.SECURITY_128_BIT_RADIX, (1, 256)),
    )
    for p, batches in plan:
        n, gp = p.n1, p.trgsw_lv1
        bsk, tv = rnd((p.n0, 2 * gp.l, 2, n)), rnd((2, n))
        bsk_mb = rnd((p.n0 // 2, 4, 2 * gp.l, 2, n))
        name = _name(p)
        for batch in batches:
            b_til, a_til = rnd((batch,), 0, 2 * n), rnd((batch, p.n0), 0, 2 * n)
            std = cuda_ms(lambda: blind_rotate_kernel(b_til, a_til, tv, bsk, p), 1)
            mb = cuda_ms(lambda: blind_rotate_mb_kernel(b_til, a_til, tv, bsk_mb, p), 1)
            table[f"{name} B={batch}"] = {"blind_rotate_ms": std, "blind_rotate_mb_ms": mb}
            print(f"[3d] {name} B={batch}: blind_rotate {std:.2f} ms, blind_rotate_mb {mb:.2f} ms "
                  f"({'multi-bit' if mb < std else 'standard'} faster)")
    print(f"[3d] crossover table: {json.dumps(table)}")
    print(f"[3d] done {elapsed()}")
    return table


def phase_fixture(dev) -> None:
    from rs_tfhe_tpu_torch import gates, key
    from rs_tfhe_tpu_torch.bootstrap import bootstrap_with_testvec
    from rs_tfhe_tpu_torch.ops.blind_rotate import blind_rotate, rotation_exponents
    from rs_tfhe_tpu_torch.ops.cuda_blind_rotate_mb import blind_rotate_mb_kernel
    from rs_tfhe_tpu_torch.ops.extract import sample_extract
    from rs_tfhe_tpu_torch.ops.keyswitch import identity_key_switch
    from rs_tfhe_tpu_torch.params import TEST_TINY
    from rs_tfhe_tpu_torch.torus import to_numpy, to_torch

    def compare(outputs, v, fixture):
        for name, out in outputs.items():
            check(out.is_cuda, f"{name} ran on the card")
            same = np.array_equal(to_numpy(out), v[name])
            print(f"[4] TEST_TINY {name} on the card == JAX fixture {fixture}: {same}")
            check(same, f"{name} equals the JAX fixture")

    v = np.load(FIXTURE)
    ck = key.cloud_key_from_numpy(v, TEST_TINY, dev)
    a, b, c = (to_torch(v[n], dev) for n in ("ct_a", "ct_b", "ct_c"))
    acc = blind_rotate(a, ck.testvec, ck.bsk, TEST_TINY)
    lv1 = sample_extract(acc, 0)
    compare({
        "blind_rotate": acc,
        "sample_extract": lv1,
        "identity_key_switch": identity_key_switch(lv1, ck.ksk_limbs, TEST_TINY),
        "nand": gates.nand(a, b, ck),
        "mux": gates.mux(a, b, c, ck),
    }, v, os.path.basename(FIXTURE))

    v = np.load(FIXTURE_MB)
    ck = key.cloud_key_from_numpy(v, TEST_TINY, dev)
    a, b, m = (to_torch(v[n], dev) for n in ("ct_a", "ct_b", "ct_m"))
    lut, lut_per_ct = to_torch(v["lut"], dev), to_torch(v["lut_per_ct"], dev)
    b_til, a_til = rotation_exponents(a, TEST_TINY)
    compare({
        "blind_rotate_mb": blind_rotate_mb_kernel(b_til, a_til, ck.testvec, ck.bsk_mb, TEST_TINY),
        "nand_b1": gates.nand(a[:1], b[:1], ck),
        "pbs_mb": bootstrap_with_testvec(m, lut, ck, allow_mb=True),
        "pbs_std": bootstrap_with_testvec(m, lut, ck, allow_mb=False),
        "pbs_mb_per_ct": bootstrap_with_testvec(m, lut_per_ct, ck, allow_mb=True),
    }, v, os.path.basename(FIXTURE_MB))
    print(f"[4] done {elapsed()}")


def _keygen(p, dev, seed, multibit=False):
    from rs_tfhe_tpu_torch.key import CloudKey, SecretKey

    g = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    sk = SecretKey.generate(p, g)
    ck = CloudKey.generate(sk, g, multibit=multibit)
    torch.cuda.synchronize()
    return sk, ck, g, (time.perf_counter() - t0) * 1e3


def _latency_ms(gate, a1, b1, ck, sk, expect_bit_a, bit_b):
    """B = 1 latency: slope between chains of 5 and 25 dependent gates,
    minimum over 3 repeats; every chain's output is decrypted and checked."""
    from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_bool

    def chain_s(n, repeats=3):
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            cur, expect = a1, expect_bit_a
            for _ in range(n):
                cur = gate(cur, b1, ck)
                expect = not (expect and bit_b)
            _ = int(cur[0, -1].item())
            best = min(best, time.perf_counter() - t0)
            check(bool(lwe_decrypt_bool(cur, sk.lv0)[0]) == expect, "a chained B=1 NAND decrypts correctly")
        return best

    chain_s(1, repeats=1)  # warm
    t5, t25 = chain_s(5), chain_s(25)
    return (t25 - t5) / 20 * 1e3, t5, t25


def run_main_path(p, batch: int, dev, label: str) -> dict:
    """Keygen, encryption, batch NAND and decryption on the card; gates/s
    and the B = 1 latency slope."""
    from rs_tfhe_tpu_torch import gates
    from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_bool, lwe_encrypt_bool

    _, _, _, cold_ms = _keygen(p, dev, SEED + 1)
    sk, ck, g, warm_ms = _keygen(p, dev, SEED + 2)
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

    latency_ms, t5, t25 = _latency_ms(gates.nand, a[:1], b[:1], ck, sk, bool(bits_a[0]), bool(bits_b[0]))
    print(f"[{label}] {gates_per_s:.1f} gates/s at B={batch} ({per_iter * 1e3:.1f} ms per batch, "
          f"{iters} chained); B=1 latency {latency_ms:.2f} ms (chains 5/25: "
          f"{t5 * 1e3:.1f}/{t25 * 1e3:.1f} ms) {elapsed()}")
    return {"gates_per_s": gates_per_s, "latency_ms_b1": latency_ms,
            "keygen_warm_ms": warm_ms, "correctness": correct}


def run_mb_gates(p, batch: int, dev, label: str) -> dict:
    """A multi-bit key made on the card; NAND and XOR batches, gates/s over
    three chained NAND batches, and the B = 1 latency slope, all through the
    auto route (the multi-bit rotation)."""
    from rs_tfhe_tpu_torch import gates
    from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_bool, lwe_encrypt_bool

    sk, ck, g, keygen_ms = _keygen(p, dev, SEED + 40, multibit=True)
    check(ck.bsk_mb is not None and ck.bsk_mb.is_cuda, f"{label}: multi-bit key on the card")
    rng = np.random.default_rng(SEED + 41)
    bits_a, bits_b = (rng.integers(0, 2, batch).astype(bool) for _ in range(2))
    a = lwe_encrypt_bool(g, sk.lv0, bits_a, p.tlwe_lv0.alpha)
    b = lwe_encrypt_bool(g, sk.lv0, bits_b, p.tlwe_lv0.alpha)
    for name, fn, truth in (("nand", gates.nand, ~(bits_a & bits_b)), ("xor", gates.xor, bits_a ^ bits_b)):
        correct = float((lwe_decrypt_bool(fn(a, b, ck), sk.lv0).cpu().numpy() == truth).mean())
        check(correct == 1.0, f"{label}: every multi-bit {name} of a B={batch} batch decrypts correctly")
    iters, expect, cur = 3, bits_a, a
    t0 = time.perf_counter()
    for _ in range(iters):
        cur = gates.nand(cur, b, ck)
        expect = ~(expect & bits_b)
    torch.cuda.synchronize()
    per_iter = (time.perf_counter() - t0) / iters
    check(bool((lwe_decrypt_bool(cur, sk.lv0).cpu().numpy() == expect).all()),
          f"{label}: chained multi-bit NAND batches decrypt correctly")
    latency_ms, t5, t25 = _latency_ms(gates.nand, a[:1], b[:1], ck, sk, bool(bits_a[0]), bool(bits_b[0]))
    print(f"[{label}] {_name(p)} multi-bit keygen (multibit=True, incl. secret key) {keygen_ms:.1f} ms; "
          f"B={batch} NAND/XOR 100% correct; {batch / per_iter:.1f} gates/s ({per_iter * 1e3:.1f} ms per "
          f"batch, {iters} chained); B=1 latency {latency_ms:.2f} ms "
          f"(chains 5/25: {t5 * 1e3:.1f}/{t25 * 1e3:.1f} ms) {elapsed()}")
    return {"gates_per_s_mb": batch / per_iter, "latency_ms_b1_mb": latency_ms, "keygen_mb_ms": keygen_ms}


def run_pbs(p, dev, label: str) -> dict:
    """Programmable bootstrapping with a multi-bit key: B = 2048 through
    LutBootstrap, B = 256 with per-ciphertext LUTs, B = 1 and 2 through the
    multi-bit route."""
    from rs_tfhe_tpu_torch.bootstrap import LutBootstrap, bootstrap_with_testvec
    from rs_tfhe_tpu_torch.lut import Generator
    from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_message, lwe_encrypt_message
    from rs_tfhe_tpu_torch.utils.noise import mb_lut_route_ok

    modulus = 8
    check(mb_lut_route_ok(p), "the parameter set takes the multi-bit LUT route")
    sk, ck, g, keygen_ms = _keygen(p, dev, SEED + 50, multibit=True)
    rng = np.random.default_rng(SEED + 51)
    msgs = rng.integers(0, modulus, 2048)
    ct = lwe_encrypt_message(g, sk.lv0, msgs, modulus, p.tlwe_lv0.alpha)
    strategy = LutBootstrap()

    def f(v):
        return (3 * v) % modulus

    def pbs(x):
        return strategy.bootstrap_func(x, f, modulus, ck)

    out = pbs(ct)
    correct = float((lwe_decrypt_message(out, sk.lv0, modulus) == f(msgs)).mean())
    check(correct == 1.0, f"{label}: every PBS of the B=2048 batch decrypts correctly")
    t0 = time.perf_counter()
    out = pbs(ct)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    check(bool((lwe_decrypt_message(out, sk.lv0, modulus) == f(msgs)).all()), f"{label}: second B=2048 PBS")
    print(f"[{label}] keygen (multibit=True) {keygen_ms:.1f} ms; B=2048 (3v mod 8): correctness {correct:.6f}, "
          f"{2048 / batch_s:.1f} PBS/s ({batch_s * 1e3:.1f} ms per batch, multi-bit route)")
    lut3 = Generator(modulus, p).generate_lookup_table(f).poly.to(dev)
    out = bootstrap_with_testvec(ct, lut3, ck, allow_mb=False)
    check(bool((lwe_decrypt_message(out, sk.lv0, modulus) == f(msgs)).all()),
          f"{label}: every PBS of the B=2048 batch decrypts correctly with allow_mb=False")
    _, std_ms = timed(lambda: bootstrap_with_testvec(ct, lut3, ck, allow_mb=False))
    print(f"[{label}] the same batch with allow_mb=False (whole-rotation kernel): 100% correct, "
          f"{2048e3 / std_ms:.1f} PBS/s ({std_ms:.1f} ms)")
    stages = _stage_split(ct, lut3, ck)
    print(f"[{label}] one B=2048 PBS by stage (CUDA events, ms): {json.dumps(stages)}")
    split = _profile_split(lambda: pbs(ct))
    print(f"[{label}] one B=2048 PBS by kernel (torch.profiler, device ms): {json.dumps(split)}")

    gen = Generator(modulus, p)
    tables = [gen.generate_lookup_table(lambda v, k=k: (v + k) % modulus).poly for k in range(modulus)]
    which = rng.integers(0, modulus, 256)
    lut = torch.stack([tables[k] for k in which]).to(dev)
    out = bootstrap_with_testvec(ct[:256], lut, ck)
    ok = bool((lwe_decrypt_message(out, sk.lv0, modulus) == (msgs[:256] + which) % modulus).all())
    check(ok, f"{label}: every per-ciphertext-LUT PBS of the B=256 batch decrypts correctly")
    _, per_ct_ms = timed(lambda: bootstrap_with_testvec(ct[:256], lut, ck))

    small = {}
    for batch in (1, 2):
        x = ct[:batch]
        out = pbs(x)
        check(bool((lwe_decrypt_message(out, sk.lv0, modulus) == f(msgs[:batch])).all()),
              f"{label}: B={batch} multi-bit PBS decrypts correctly")
        t0 = time.perf_counter()
        for _ in range(3):
            out = pbs(x)
        torch.cuda.synchronize()
        small[batch] = (time.perf_counter() - t0) / 3 * 1e3
    print(f"[{label}] B=256 per-ciphertext LUTs: 100% correct, {per_ct_ms:.1f} ms; "
          f"B=1 {small[1]:.1f} ms per call, B=2 {small[2]:.1f} ms per call (multi-bit route) {elapsed()}")
    return {"pbs_per_s_b2048": 2048 / batch_s, "pbs_per_s_b2048_allow_mb_false": 2048e3 / std_ms,
            "pbs_ms_b256_per_ct_lut": per_ct_ms,
            "pbs_ms_b1_mb": small[1], "pbs_ms_b2_mb": small[2], "correctness": correct,
            "stage_ms": stages, "profile_ms": split}


def _stage_split(ct, lut, ck) -> dict:
    """Device time of the bootstrap's three stages on one batch."""
    from rs_tfhe_tpu_torch.ops.blind_rotate import blind_rotate
    from rs_tfhe_tpu_torch.ops.extract import sample_extract
    from rs_tfhe_tpu_torch.ops.keyswitch import identity_key_switch

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    acc = blind_rotate(ct, lut, ck.bsk, ck.params, bsk_mb=ck.bsk_mb)
    ev[1].record()
    lv1 = sample_extract(acc, 0)
    ev[2].record()
    identity_key_switch(lv1, ck.ksk_limbs, ck.params)
    ev[3].record()
    torch.cuda.synchronize()
    names = ("blind_rotate", "sample_extract", "identity_key_switch")
    return {n: round(ev[i].elapsed_time(ev[i + 1]), 3) for i, n in enumerate(names)}


def _profile_split(fn) -> dict:
    """Device time by kernel of one fn() call, from torch.profiler (the
    first ten by time, the rest summed)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "cuda_time_total", 0)
        if dev_us and getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            rows.append((evt.key[:60], dev_us / 1e3))
    rows.sort(key=lambda r: -r[1])
    split = {k: round(v, 3) for k, v in rows[:10]}
    split["other"] = round(sum(v for _, v in rows[10:]), 3)
    split["total"] = round(sum(v for _, v in rows), 3)
    return split


def run_pallas_route(p, batch: int, dev, label: str) -> dict:
    """step_impl="pallas" against the default route on one key and one
    batch: equal outputs; gates/s of both."""
    from rs_tfhe_tpu_torch import config, gates
    from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_bool, lwe_encrypt_bool

    sk, ck, g, _ = _keygen(p, dev, SEED + 60)
    rng = np.random.default_rng(SEED + 61)
    bits_a, bits_b = (rng.integers(0, 2, batch).astype(bool) for _ in range(2))
    a = lwe_encrypt_bool(g, sk.lv0, bits_a, p.tlwe_lv0.alpha)
    b = lwe_encrypt_bool(g, sk.lv0, bits_b, p.tlwe_lv0.alpha)
    t0 = time.perf_counter()
    default = gates.nand(a, b, ck)
    torch.cuda.synchronize()
    default_s = time.perf_counter() - t0
    saved = config.config.step_impl
    config.config.step_impl = "pallas"
    try:
        t0 = time.perf_counter()
        out = gates.nand(a, b, ck)
        torch.cuda.synchronize()
        pallas_s = time.perf_counter() - t0
    finally:
        config.config.step_impl = saved
    check(torch.equal(out, default), f"{label}: the per-step route equals the default route bit for bit")
    correct = float((lwe_decrypt_bool(out, sk.lv0).cpu().numpy() == ~(bits_a & bits_b)).mean())
    check(correct == 1.0, f"{label}: every NAND of the per-step route decrypts correctly")
    print(f"[{label}] step_impl='pallas' {_name(p)} B={batch}: equal to the default route, 100% correct; "
          f"{batch / pallas_s:.1f} gates/s ({pallas_s * 1e3:.1f} ms) against the default route's "
          f"{batch / default_s:.1f} gates/s ({default_s * 1e3:.1f} ms) {elapsed()}")
    return {"gates_per_s_pallas": batch / pallas_s, "gates_per_s_default": batch / default_s}


def main() -> int:
    smi = phase_environment()
    import rs_tfhe_tpu_torch  # noqa: F401  (fails outside a checkout)
    from rs_tfhe_tpu_torch import params as P
    from rs_tfhe_tpu_torch.ops import cuda_blind_rotate, cuda_blind_rotate_mb, cuda_step

    modules = {"blind_rotate": cuda_blind_rotate, "blind_rotate_mb": cuda_blind_rotate_mb,
               "external_product": cuda_step}

    path_tiles = {k: set() for k in modules}

    def drive(path, fn, *args):
        """Run one path with every launch count at 0 before it; return its
        result and the counts after it."""
        for m in modules.values():
            m.launches = 0
            m.launched_tiles.clear()
        out = fn(*args)
        counts = {k: m.launches for k, m in modules.items()}
        tiles = {k: tile_list(m.launched_tiles) for k, m in modules.items()}
        for k, m in modules.items():
            path_tiles[k].update(m.launched_tiles)
        print(f"[{path}] kernel launches on this path: {counts}; (N, tile) launched: {tiles}")
        return out, counts

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    compare = {
        "blind_rotate": phase_kernel_vs_plain(dev),
        "blind_rotate_mb": phase_mb_kernel_vs_plain(dev),
        "external_product": phase_step_kernel_vs_plain(dev),
    }
    crossover = phase_crossover(dev)
    phase_fixture(dev)

    def gate_path():
        return {"SECURITY_128_BIT_FAST_B4096": run_main_path(P.SECURITY_128_BIT_FAST, 4096, dev, "5"),
                "SECURITY_128_BIT_B512": run_main_path(P.SECURITY_128_BIT, 512, dev, "6")}

    def mb_path():
        return {"SECURITY_128_BIT_FAST_B4096": run_mb_gates(P.SECURITY_128_BIT_FAST, 4096, dev, "7"),
                "SECURITY_128_BIT_B512": run_mb_gates(P.SECURITY_128_BIT, 512, dev, "7")}

    paths = {}
    results = {}
    results["gates"], paths["gates"] = drive("5-6", gate_path)
    check(paths["gates"]["blind_rotate"] > 0, "the gate path launched the blind-rotation kernel")
    results["mb_gates"], paths["mb_gates"] = drive("7", mb_path)
    check(paths["mb_gates"]["blind_rotate_mb"] > 0, "the multi-bit gate path launched the multi-bit kernel")
    results["pbs_radix"], paths["pbs_radix"] = drive("8", run_pbs, P.SECURITY_128_BIT_RADIX, dev, "8")
    check(paths["pbs_radix"]["blind_rotate_mb"] > 0, "the PBS path launched the multi-bit kernel")
    check(paths["pbs_radix"]["blind_rotate"] > 0, "the PBS path launched the blind-rotation kernel")
    results["pallas"], paths["pallas"] = drive("9", run_pallas_route, P.SECURITY_128_BIT_FAST, 4096, dev, "9")
    check(paths["pallas"]["external_product"] > 0, "the per-step route launched the step kernel")
    print(f"[5-9] peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
          f"total {elapsed()}")
    for name in modules:
        compared = {tuple(t) for t in compare[name]["tiles_compared"]}
        missing = path_tiles[name] - compared
        print(f"[5-9] {name}: (N, tile) on the paths {tile_list(path_tiles[name])}, "
              f"held against the plain version in phase 3: {tile_list(compared)}")
        check(not missing, f"every {name} instantiation the paths launched was held against the plain "
                           f"version (missing: {tile_list(missing)})")

    sources = {
        "blind_rotate": ("rs_tfhe_tpu_torch/csrc/blind_rotate.cu", "rs_tfhe_tpu/ops/pallas_blind_rotate.py:929",
                         ["rs_tfhe_tpu/ops/pallas_blind_rotate.py:828",
                          "rs_tfhe_tpu/ops/pallas_blind_rotate.py:725"]),
        "blind_rotate_mb": ("rs_tfhe_tpu_torch/csrc/blind_rotate_mb.cu",
                            "rs_tfhe_tpu/ops/pallas_blind_rotate.py:668", []),
        "external_product": ("rs_tfhe_tpu_torch/csrc/external_product.cu", "rs_tfhe_tpu/ops/pallas_step.py:91", []),
    }
    kernels = []
    for name, (source, replaces, also) in sources.items():
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(c[name] for c in paths.values()),
            "launches_by_path": {k: c[name] for k, c in paths.items()},
            "tiles_on_path": tile_list(path_tiles[name]),
            **compare[name],
        }
        if also:
            entry["also_replaces"] = also
        kernels.append(entry)
    print(smi)
    print(json.dumps({"kernels": kernels, "main_path": results, "crossover_ms": crossover, "card": smi}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
