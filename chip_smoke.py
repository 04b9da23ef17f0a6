#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rs_tfhe_tpu_torch) on one CUDA card.

Usage, from the root of a checkout:  python3 chip_smoke.py

Phases (each prints on stdout; any failure raises and exits non-zero before
the last line):
  1. environment: torch/CUDA versions and the card's name and power limit;
     exits non-zero when no CUDA device is available;
  2. build: compiles the hand-written kernels from csrc/ (nvcc, sm_90a), one
     nvcc per source, all started together, and reads from the library
     (cuobjdump -sass) the probe dots' tensor-core instructions (wgmma; for
     the s16/s32 byte-limb dots the u8 forms, and no operand loaded into
     registers, so no CUDA-core dot loop), the roll, bitcast and unpack
     kernels' 128-bit global loads and stores, and the chained roll+add's
     register instances' shuffles (SHFL, and no shared memory, barrier or
     local memory: LDS, STS, BAR, LDL, STL), and the blind rotation's wgmma
     instance (IGMMA with U8 operands and no IMMA in every instantiation, no
     ptxas note of serialised wgmma, C7515 or C7518, naming it);
  3. each kernel against its plain PyTorch version on the card, bit for bit,
     with both times (CUDA events), and the instance each case launched
     (ring size, tile, cluster and unit for the rotation; ring size, unit,
     rows a block and column split for the step):
       3a the blind rotation at SECURITY_128_BIT_FAST (B = 1, 8, 8 with
          per-ciphertext test vectors, 16, 128, 256, 4096; a grid-sampled
          key, three key limbs on the tensor cores, 16 or 32 ciphertexts a
          cluster; B = 64 with a key off the grid, four limbs),
          SECURITY_128_BIT (B = 4, 512), SECURITY_UINT4 (B = 8, 22-bit
          digits), SECURITY_128_BIT_RADIX (B = 528 and the smallest batch
          that takes the instance of B = 2048; N = 2048) and
          SECURITY_128_BIT_NIBBLE B = 1 (N = 4096), then every other
          (tile, cluster) instance the wrapper picks for a batch up to 128 at
          FAST (the batches circuits launch) and for the batches phases 13
          and 14 give it at RADIX and NIBBLE (RADIX_BATCHES,
          NIBBLE_BATCHES) and phase 17's examples at TEST_TINY, the N=512
          demo set, strict, FAST, RADIX and NIBBLE (EXAMPLE_BATCHES), each
          at the smallest batch that takes the instance, compared without
          timing; for phase 17 also UINT4 B=16 and the N=512 demo set B=16
          (timed), UINT1-3 and UINT5-8 at the batch
          lut_uint_parameters_demo gives each (2, 4, 8, 16, 16, 16, 16) and
          the 80- and 110-bit sets at B=4 (untimed);
       3b the multi-bit rotation at the batches `auto` sends it (at most
          `mb_route_batch_cap`: 2 at FAST, 4 at L = 3), each on the cluster
          instance: FAST B = 1 and 2 (shared and per-ciphertext test vectors,
          a grid-sampled multi-bit key), strict B = 1 and 4,
          SECURITY_128_BIT_RADIX B = 1 and 2, SECURITY_128_BIT_NIBBLE B = 1
          (random keys with 0x80000000 and 0xFFFFFFFF words), TEST_TINY
          B = 1 (phase 17's low_latency_gates at its default set); and FAST
          B = 1024 on the single-block instance, which step_impl=
          "fused_small_mb" gives large batches;
       3c the external-product step at FAST B = 2048 and 8, strict B = 512
          and 8, RADIX B = 64 and UINT4 B = 8 (s8 limb products on the tensor
          cores for single-limb digits, the CUDA cores for UINT4), all 2L
          gadget rows; and at the J = 2L/tp rows of phase 16's
          tensor-parallel shards: FAST B = 1 and 8 at J = 1 and 2, strict
          B = 1 and 8 at J = 3, TEST_TINY B = 4 at J = 3 (the dry run);
       3d the crossover at B = 1, 2, 4 and 8 of FAST, strict and RADIX: the
          multi-bit kernel's cluster and single-block instances and the
          whole-rotation kernel, beside the rotation `auto` gives a
          multi-bit key there (the JAX package's cap decides it);
       3e the seven probe and primitive-rate kernels (csrc/probes.cu) on
          random inputs: the integer dots on the wgmma tile of
          csrc/wgmma_s8.cuh (s8 directly, s16 and s32 as 4 and 10 byte-limb
          products; at the probe shape and, for s16 and s32, at
          [4096,4096]x[4096,4096]), roll, bitcast, unpack, and the chained
          dot (both units) and chained roll+add at every shape of
          scripts/bench_hopper_prims.py (the roll+add at 64 steps, where a
          call is mostly its host path, and at 16,384, where it is the
          kernel's time, in ns a step beside the step's bound, each on the
          instance its shape selects); torch._int_mm on the same operands
          is the s8 dots' library time, float64 torch.matmul wrapped to int32
          the s16 dots' (s32 has none), and the chain's tile loop is timed by
          its cycle counter; the roll (int8, int16, int32), the bitcast and
          the unpack at the TPU probe shape [8,256] (the roll and the bitcast
          beside the same wrapper on one word, the floor of a call), and at
          size: the roll on the FAST B = 4096 accumulator's [8192,1024] by 5
          and by 1000, the bitcast and the unpack on the FAST cloud key's bsk
          as [5600,1024], each input rotating through copies that span three
          times the L2; torch.roll, view, a clone and the int16 view's
          permute(2, 0, 1).contiguous() are their library times; and the
          s16 dot as the Nussbaumer route calls it (ops/nussbaumer.py
          pointwise_dot, counted apart as nussbaumer_dot): [B, 512] x
          [512, 1024] for each of 16 DFT points at FAST, B = 1 and 8, and
          [8, 768] x [768, 1024] at strict, beside a float64 torch.bmm over
          the 16 points;
       3f the small-batch key switch (csrc/key_switch.cu) against its plain
          version, the one-hot product route, at the FAST and strict
          key-switching tables (random limbs, 0x80000000 and 0xFFFFFFFF
          planted in the inputs), B = 1 and 16, inputs cycling so that the
          rows come from memory; torch._int_mm alone on the padded one-hot
          operand is its library time; then the sweep at FAST over
          KS_SWEEP_BATCHES, kernel against product, each compared bit for
          bit, that sets ops.keyswitch.KS_SELECT_MAX_BATCH;
     every case with its bound: the least time the card could take, the
     larger of bytes over the memory rate and operations over the peak rate
     (for 32-bit multiply-adds the better of the CUDA cores and of s8 limb
     products on the tensor cores);
  4. the card against the JAX package through the committed fixtures
     tests/vectors/torch_port_tiny.npz, torch_port_tiny_mb.npz (with a NAND
     at B = 5 above the multi-bit route's cap, which must take the
     whole-rotation kernel), torch_port_tiny_circuits.npz and
     torch_port_tiny_radix.npz (radix arithmetic, sort_radix and the typed
     API with a standard and a multi-bit key) and torch_port_tiny_parallel.npz
     (JAX's multi-device outputs on 8 virtual CPU devices, replayed on meshes
     of the card repeated: data-parallel NAND, XOR, MUX, LUT and the
     multi-bit key's local-batch routing, tensor-parallel AND, OR and LUT,
     and a NAND under step_impl="nussbaumer") (TEST_TINY, bit for bit);
  5. the gate path at full width, SECURITY_128_BIT_FAST: keygen on the card,
     4096 encrypted bit pairs through batch_gate("nand"), decrypted 100%
     correct, gates/s, and B = 1 latency as the slope between chains of 5
     and 25 dependent gates (minimum over repeats);
  6. the same at SECURITY_128_BIT with B = 512;
  7. multi-bit gates: keygen with multibit=True on the card at FAST and
     strict, NAND and XOR batches (B = 4096 FAST, 512 strict: the
     whole-rotation kernel), gates/s and the B = 1 latency slope (the
     multi-bit kernel's cluster instance) through the auto route, every gate
     decrypted correctly, each part's kernel checked;
  8. programmable bootstrapping at SECURITY_128_BIT_RADIX with a multi-bit
     key: B = 2048 messages mod 8 through LutBootstrap().bootstrap_func with
     (3v) mod 8 (the whole-rotation kernel), 100% correct, PBS/s, and one
     bootstrap split by stage (CUDA events) and by kernel (torch.profiler);
     the same batch with allow_mb=False; B = 256 with a per-ciphertext LUT
     through bootstrap_with_testvec; B = 1 and 2 through the multi-bit
     kernel, time per PBS;
  9. step_impl="pallas": a FAST NAND batch at B = 4096 through the
     per-step route equals the default route's output bit for bit;
 10. the probes' own path: scripts/probe_hopper.py (PASS/FAIL per
     capability) and scripts/bench_hopper_prims.py (the chained-dot and
     roll+add rate tables);
 11. boolean circuits at SECURITY_128_BIT_FAST with a standard and with a
     multi-bit key: encrypt_uint -> ripple_carry_adder(32) through
     netlist.evaluate and netlist.compile_circuit -> decrypt_uint equals
     (x + y) mod 2^32, and wall time and gates/s through the plan;
     add_kogge_stone on a batch of 32-bit pairs and mul_csa on a batch of
     8-bit pairs, decrypted and checked; with a multi-bit key both rotation
     kernels run (plan groups of at most 2 gates the multi-bit one);
 12. multi-value bootstrapping at SECURITY_128_BIT_RADIX: two LUTs from one
     rotation on B = 2048 messages, each output decrypting to what the
     dedicated bootstrap_with_testvec gives;
 13. radix arithmetic at SECURITY_128_BIT_RADIX with a multi-bit key (the
     JAX bench's cases, scripts/bench_suite.py:377-411): add_radix base 16
     D = 2 and base 8 D = 3 (both ways) on B = 64, sub_radix,
     compare_radix, min_radix and select_radix at D = 3, B = 64,
     radix_to_bits -> bits_to_radix on B = 16, sort_radix of 8 values of two
     base-8 digits, add_radix at B = 1 (every batch on the multi-bit
     kernel), and FheUintRadix +, * and < on B = 16; each decrypted against
     numpy, with its host-clock time, its launches of both rotation kernels
     and, for three of them, the device time by kernel (torch.profiler);
 14. mul_radix at SECURITY_128_BIT_NIBBLE with a standard key, 8 x 8 bits
     (base 4, D = 4) on B = 16 pairs, both ways (the JAX bench's
     mul8x8_b16_NIBBLE(_mv), scripts/bench_suite.py:464-476), decrypted
     exact; then FheUint(8) +, < and select at SECURITY_128_BIT_FAST on
     B = 16 through the typed API;
 15. the deployment round trip at SECURITY_128_BIT_FAST: the native C++
     client (rs_tfhe_tpu_torch.native, built with g++) and a standard and a
     multi-bit cloud key generated on the card with gen_seed (keygen time,
     cold and warm); each key saved full and seeded (the JAX package's npz
     format), the sizes printed, loaded back onto the card and held equal
     buffer for buffer (the seeded load replays the masks on the card); the
     threefry stream's rate at the key-switching key's size; 4096 bit pairs
     encrypted seeded by the native client, expanded on the card, NAND on the
     seeded-loaded standard key (the whole-rotation kernel) and one NAND at
     B = 1 on the seeded-loaded multi-bit key (the multi-bit kernel), decrypted
     by the native client; proxy re-encryption Alice -> Bob at B = 4096 with a
     symmetric and an asymmetric key (key times, reencrypt times, Bob's
     correctness and phase noise; the asymmetric key with the set's own
     decomposition fails about one ciphertext in 10^3-10^4 in both packages,
     so its noise is held to the JAX package's and the key that must decrypt
     every ciphertext uses basebit 6, t = 3); and utils.profiling's Timer and
     gate_throughput on that path. Its times are host clock to the
     synchronise, warm unless marked cold, each line with the card's name and
     power limit;
 16. the multi-device paths (rs_tfhe_tpu_torch.parallel) and the Nussbaumer
     route at full width, SECURITY_128_BIT_FAST (keys made on the card) on a
     virtual mesh of the card: data-parallel NAND B = 4096 on 4 shards
     (bit-equal to the single-device batch; gates/s of both), the multi-bit
     key's data-parallel NAND B = 8 (every 2-row shard on the multi-bit
     kernel), data-parallel MUX B = 1024; tensor-parallel NAND at B = 1 and 8
     with tp = 2 (the step kernel at J = 2), B = 8 with tp = 4 (J = 1) and at
     SECURITY_128_BIT with tp = 2 (J = 3), and the tensor-parallel LUT at
     B = 8, each bit-equal to the single device; NAND B = 8 under
     step_impl="nussbaumer" at FAST and strict, bit-equal to the default
     route; dryrun_multichip on 4 shards; where two or more cards are
     visible, the data- and tensor-parallel NAND again over distinct cards.
     Every output decrypted; times host clock to the synchronise, with the
     card's name and power limit;
 17. the examples (examples/torch/, the users' entry points), each run in
     this process through its main() on the card: all twenty at their
     defaults (TEST_TINY, or the N=512 demo sets of radix_integers and
     ciphertext_multiply), then each at the parameter set and flags its JAX
     counterpart's docstring names for a production run (EXAMPLE_PRODUCTION_RUNS:
     batch_gates, low_latency_gates, keygen_speed, add_two_numbers,
     lut_bootstrapping and encrypted_max at SECURITY_128_BIT, keygen_speed,
     encrypted_sort, typed_api and multi_chip_scaling at FAST,
     lut_add_two_numbers and the 16-bit ciphertext_multiply at NIBBLE,
     radix_integers at RADIX, lut_uint_parameters_demo at all eight Uint
     sets, gates_with_strategies at the 80- and 110-bit sets). A run fails
     on an exception (its asserts included) and unless it ends on its last
     result line (EXAMPLE_DONE; an example that skips does not); each
     run's output and wall time are printed with the card's name and power
     limit;
 18. the reliability entry points (scripts/torch/, the users' evidence for
     the decryption-failure claims), in this process, at short targets
     (SOAK_SMOKE_TARGETS): the soak's four phases (FAST and strict chained
     NAND/XOR layers at B = 4096, NIBBLE add_radix on B = 256, FAST with a
     multi-bit key at B = 2), every output decrypted and sampled rotations
     held bit for bit against the plain version on the card (under
     step_impl="xla", and blind_rotate_mb_plain on the multi-bit kernel's
     own inputs), then measure_mb_noise --quick; it fails on an error, a
     mismatch, a phase without a spot check or a multi-bit noise ratio
     outside [0.5, 1.15]. Phase 3a holds the soak's strict and NIBBLE
     batches (SOAK_STRICT_BATCHES, SOAK_NIBBLE_BATCHES);
 19. the measurement entry points (scripts/torch/, the counterparts of the
     JAX repo's benches), in this process: bench.py at its defaults (FAST and
     strict NAND at B = 4096, 5 chained iterations, the B = 1 slopes with both
     keys; its line must have BENCH_r05.json's "parsed" fields and no
     correctness field below 1.0), the suite's main-path cases
     (SUITE_SMOKE_CASES: keygen warm, the B = 1 latencies, NAND B = 128 and
     4096, the rotation and key switch at B = 2048, the external-product step
     on K5), the latency sweep at B = 1, 2 and 8 for auto, auto_mb and
     fused_small_mb at FAST and strict (each row decrypted and on its
     route's kernel: K4 for fused_small_mb and for auto_mb up to the cap, K1
     otherwise) and the multi-device harness on 2 virtual shares of the card
     (MULTICHIP_SMOKE), every point decrypted. Phases 3a and 3b hold the
     instances of the batches these give the rotation kernels
     (BENCH_BATCHES, BENCH_MB_BATCHES);
 20. the last two JAX entry points' counterparts (scripts/torch/), in this
     process: tpu_validation in full at the production sets (strict,
     UINT4, RADIX, NIBBLE; every check must pass, the tripwire's
     counterpart on P1's s16 unit and the multi-bit noise stage among them,
     and every entry of tests/vectors/golden_production_torch.npz must
     verify), then its gate, MUX and PBS outputs recomputed under
     step_impl="xla" and its first multi-bit rotations through
     blind_rotate_mb_plain, bit for bit; and diag_gate_latency's four chains
     (rotation, +extract, +key switch, the NAND) at FAST and strict, B = 1,
     2 and 4 with a standard key and B = 1 and 2 with a multi-bit key, in
     host-clock and device ms (CUDA events, the chain queued behind a spin
     kernel). Phases 3a and 3b hold their instances (VALIDATION_BATCHES,
     VALIDATION_MB_BATCHES).
Each path of phases 5-20 is driven with the kernels' launch counts set to 0
just before it and read just after; every kernel of a path must have
launched, and every instance a path launched (the whole key: ring size,
tile, cluster, unit, and the step kernel's gadget row count J) and every
shape it gave the Nussbaumer dot must be one that phase 3 held against the
plain version. The line before the last is a JSON object of the kernels (launches,
max error against the plain version, times); the last line is the contract
JSON with the device.
"""

from __future__ import annotations

import collections
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
FIXTURE_CIRCUITS = os.path.join(ROOT, "tests", "vectors", "torch_port_tiny_circuits.npz")
FIXTURE_RADIX = os.path.join(ROOT, "tests", "vectors", "torch_port_tiny_radix.npz")
FIXTURE_PARALLEL = os.path.join(ROOT, "tests", "vectors", "torch_port_tiny_parallel.npz")
#: the parallel fixture's data- and tensor-parallel LUTs (message modulus 4; scripts/gen_torch_port_vectors.py)
FIXTURE_PARALLEL_LUTS = (lambda x: (3 * x) % 4, lambda x: (x + 2) % 4)
#: The radix fixture's digit base (scripts/gen_torch_port_vectors.py RADIX_BASE_BITS).
FIXTURE_RADIX_BASE_BITS = 2
#: The batches phase 13 gives the whole-rotation kernel at RADIX (B = 64:
#: add 2B and B, the complement D B, compare 2D B, 2B and 3B, select B, 2D B
#: and D B; B = 16: the casts D b B and D B, FheUintRadix (base 2, D = 4) +
#: 2B and B, * 2D B, 2D^2 B, 2B and B, < 2D B, 2B and 3B; sort_radix's
#: stages on 4 pairs: 16, 12, 8, 32 and 16), and those phase 14 gives it at
#: NIBBLE (mul_radix on B = 16 at D = 4: 2D B, 2D^2 B or D^2 B, and the
#: columns' 2B and B), as a run on the CPU records them. Phase 3a holds the
#: instance of each against the plain version.
RADIX_BATCHES = (8, 12, 16, 32, 48, 64, 128, 144, 192, 384, 512)
NIBBLE_BATCHES = (16, 32, 128, 256, 512)
#: The batches phase 18's soak gives the whole-rotation kernel beyond those of phases 5-17: strict
#: B = 4096; at NIBBLE the adds of 256 values (512 and 256 rotations) and the warm-up add of 4 (8 and 4)
SOAK_STRICT_BATCHES = (4096,)
SOAK_NIBBLE_BATCHES = (4, 8, 256, 512)
#: The batches phase 19's benches give the whole-rotation kernel beyond those of phases 5-18 (the
#: suite's rotation at FAST B = 2048; the sweep's auto route at strict B = 1 and 2), and the
#: multi-bit kernel (the sweep's fused_small_mb at FAST and strict B = 8, auto_mb at strict B = 2)
BENCH_BATCHES = {"128_BIT_FAST": (2048,), "128_BIT": (1, 2)}
BENCH_MB_BATCHES = {"128_BIT_FAST": (8,), "128_BIT": (2, 8)}
#: The batches phase 20 gives the whole-rotation kernel, by set: scripts/torch/tpu_validation.py's
#: stages (strict: the gates and MUX at 64, the LUT at 8, Kogge-Stone at 16, 8, 2 and 1, the netlist's
#: groups of 1 and 2, the radix add; UINT4 16; RADIX 512 and 256; NIBBLE the adds' 512 and 256, the
#: product's 1024, 256, 64 and 32), as a run on the CPU at tiny sets records them (a batch follows the
#: trials and digits, not the set), and the diag's standard-key chains at B = 1, 2 and 4; and those it
#: gives the multi-bit kernel (the multi-bit NAND and the noise stage at strict B = 2, the diag's
#: multi-bit chains at B = 1 and 2)
VALIDATION_BATCHES = {"128_BIT": (1, 2, 4, 8, 16, 64), "128_BIT_FAST": (1, 2, 4), "UINT4": (16,),
                      "128_BIT_RADIX": (256, 512), "128_BIT_NIBBLE": (32, 64, 256, 512, 1024)}
VALIDATION_MB_BATCHES = {"128_BIT": (1, 2), "128_BIT_FAST": (1, 2)}
DIAG_BATCHES, DIAG_MB_BATCHES = (1, 2, 4), (1, 2)
#: The batches phase 17's examples give the whole-rotation kernel, by set (the N=512 demo sets of
#: radix_integers and ciphertext_multiply as N512_DEMO); the Uint and 80/110-bit runs are cases of their own
EXAMPLE_BATCHES = {
    "TEST_TINY": (1, 2, 4, 6, 8, 16, 32, 64, 256, 1024),
    "N512_DEMO": (1, 2, 4, 8, 12, 16, 32, 128),
    "128_BIT": (1, 8, 16, 64, 256, 1024),
    "128_BIT_FAST": (2, 4, 6, 8, 16, 32, 64, 128, 1024),
    "128_BIT_RADIX": (4, 8, 12, 16, 32, 128),
    "128_BIT_NIBBLE": (1, 2, 4, 6, 16, 128),
}
#: The circuit fixture's LUT family (scripts/gen_torch_port_vectors.py MV_FUNCTIONS, MV_MODULUS).
FIXTURE_MV_MODULUS = 4
FIXTURE_MV_FUNCTIONS = (lambda x: (x + 1) % 4, lambda x: (3 * x) % 4)
#: Published peaks of one H100 SXM (NVIDIA's data sheet, dense): device memory
#: bytes/s; s8 multiply-adds/s on the tensor cores (1,979 TOP/s); 32-bit
#: integer multiply-adds/s on the CUDA cores, half the float32 lanes' rate
#: (67 TFLOP/s is 33.5 T fused multiply-adds/s on 128 lanes an SM, of which
#: 64 take int32: 132 SMs x 64 x 1.98 GHz); 32-bit integer adds/s, twice
#: that: ptxas issues them as IADD3 to the integer ALUs and as IMAD to the FMA
#: units, 64 lanes an SM a clock each, together the four schedulers' issue
#: rate of 128 lanes (132 SMs x 128 x 1.98 GHz).
PEAK_BYTES = 3.35e12
PEAK_S8_MACS = 1979e12 / 2
PEAK_INT32_MACS = 67e12 / 4
PEAK_INT32_ADDS = 67e12 / 2
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


#: Cycles a second of torch.cuda._sleep's spin on an H100 (an upper bound: the spin only has to outlast the host)
SLEEP_CYCLES_PER_S = 2.5e9


def queued_ms(fn, reps: int) -> tuple:
    """(mean device ms, mean host ms) of fn() over `reps` runs: first on the
    host clock to a synchronise, then queued behind a spin kernel that holds
    the stream for twice that long, so that the events bracket the runs'
    kernels back to back and not the host's launch path (a call whose host
    path is longer than its kernels would time the host with `cuda_ms`).
    Fails if the card reached the first event before the last run was
    queued."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * SLEEP_CYCLES_PER_S) + 100_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued = not start.query()
    torch.cuda.synchronize()
    check(queued, "the timed runs were queued before the card reached them")
    return start.elapsed_time(end) / reps, host_s * 1e3 / reps


def timed(fn):
    """(fn(), device ms of that one call)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


#: Times of the kernels before their redesign for clusters and the tensor cores
#: (ms; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md; the multi-bit kernel's
#: single-block instance for it; for probe_dot and chain_dot the s8 dots'
#: earlier mma.sync tile, read on the card before the wgmma tile replaced
#: it; for probe_dot at s16 and s32 the CUDA-core dot and for
#: probe_unpack_s16 the word-a-thread unpack, and for chain_roll_add the
#: shared-memory chain at every width, read by scripts/bench_probe_versions.py
#: before the byte-limb dot, the streaming split and the register-resident
#: chain replaced them). Not measured by this run:
#: they are printed in the log beside the new times and never enter the
#: kernels line, which holds only what this run measured.
EARLIER_MS = {
    "blind_rotate": {"128_BIT_FAST B=1": 101.6, "128_BIT_FAST B=128": 102.4, "128_BIT_FAST B=256": 200.5,
                     "128_BIT_FAST B=4096": 1551.4, "128_BIT B=512": 325.3, "128_BIT_RADIX B=2048": 5455.5},
    "external_product": {"128_BIT_FAST B=2048": 1.122, "128_BIT B=512": 0.464, "UINT4 B=8": 0.081},
    "blind_rotate_mb": {"128_BIT_FAST B=1": 32.6, "128_BIT B=1": 50.25, "128_BIT_RADIX B=1": 191.7,
                        "128_BIT_FAST B=1024": 207.8},
    "probe_dot": {"int8 [128,1024]x[1024,256]": 0.0512, "int16 [128,1024]x[1024,256]": 0.1348,
                  "int32 [128,1024]x[1024,256]": 0.1347, "int16 [4096,4096]x[4096,4096]": 5.7996,
                  "int32 [4096,4096]x[4096,4096]": 5.7031},
    "probe_unpack_s16": {"[8,256]": 0.0179, "[5600,1024]": 0.0222},
    "probe_roll": {"int8 [8,256] by 5": 0.0157},
    "probe_bitcast_i32_to_i8": {"[8,256]": 0.0171},
    "chain_roll_add": {"[128,1024] 16384 steps": 2.3616, "[128,128] 16384 steps": 1.1502,
                       "[8,1024] 16384 steps": 2.3607, "[256,2048] 16384 steps": 5.9294},
    "chain_dot": {f"[{m},{k}]x[{k},{n}] per dot": ms for (m, k, n), ms in (
        ((128, 1024, 1024), 0.0327), ((1024, 1024, 128), 0.0547), ((256, 1024, 512), 0.0371),
        ((128, 4096, 1024), 0.0963), ((4096, 1024, 128), 0.1075), ((128, 1024, 4096), 0.0536),
        ((256, 1024, 2048), 0.0447), ((128, 768, 1024), 0.0344), ((128, 512, 1024), 0.0363),
        ((1024, 768, 128), 0.0407), ((128, 128, 128), 0.0278), ((128, 128, 1024), 0.0256),
        ((128, 256, 1024), 0.0216), ((4096, 4096, 4096), 0.7200))},
}


def counters() -> dict:
    """The package's counters now (`utils.profiling.counters()`)."""
    from rs_tfhe_tpu_torch.utils import profiling

    return profiling.counters()


def counts_since(before: dict) -> dict:
    """What the package's counters moved since the snapshot `before`."""
    return {k: v - before.get(k, 0) for k, v in counters().items() if v != before.get(k, 0)}


def by_instance(counts: dict, prefix: str) -> collections.Counter:
    """The counts of a snapshot or a delta under `prefix` (`k1.instance`,
    `nussbaumer.shape`, ...) keyed as the wrapper keys them: a tuple of the
    name's '/'-separated parts, numbers as ints."""
    head = prefix + "."
    return collections.Counter({tuple(int(x) if x.isdigit() else x for x in k[len(head):].split("/")): v
                                for k, v in counts.items() if k.startswith(head) and v > 0})


def rotation_launches() -> tuple:
    """Launches so far of the two rotation kernels, and the multi-bit
    kernel's by instance."""
    now = counters()
    return now["k1.launches"], now["k4.launches"], by_instance(now, "k4.instance")


def check_route(before: tuple, whole: bool, multibit: bool, what: str) -> None:
    """Since `before` (rotation_launches()), the whole-rotation kernel ran iff
    `whole` and the multi-bit kernel iff `multibit`, the latter only as its
    cluster instance (the one `auto` gives the batches up to the cap)."""
    now = rotation_launches()
    check((now[0] > before[0]) == whole and (now[1] > before[1]) == multibit,
          f"{what} (launches: whole-rotation {now[0] - before[0]}, multi-bit {now[1] - before[1]})")
    check(all(t[2] > 1 for t in (now[2] - before[2])), f"{what}: the multi-bit kernel ran as a cluster")


def launched_tile(prefix, fn):
    """(fn(), the instance of the kernel whose launches the counters keep
    under `prefix` (`k1.instance`, ...) it launched, as the wrapper keys it):
    fn must launch that kernel exactly once."""
    before = counters()
    out = fn()
    (key,) = by_instance(counts_since(before), prefix).keys()
    return out, key


def tile_list(tiles) -> list:
    return [list(t) for t in sorted(tiles)]


def max_abs_err(out: torch.Tensor, ref: torch.Tensor) -> int:
    return int(((out.to(torch.int64) & 0xFFFFFFFF) - (ref.to(torch.int64) & 0xFFFFFFFF)).abs().max())


def bound(nbytes: float, macs: float = 0.0, s8_limbs: int | None = None, int32_adds: float = 0.0) -> dict:
    """The least time the card could take, ms, and what binds it.

    nbytes: every input read once and every output written once. macs:
    multiply-adds on 32-bit words mod 2^32 when s8_limbs is the number of s8
    limb products one of them splits into (the better of the CUDA cores and
    the tensor cores is taken), or plain s8 multiply-adds when s8_limbs is
    None. int32_adds: 32-bit integer adds, CUDA cores."""
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    out = {"bytes_ms": bytes_ms}
    if s8_limbs is None:
        ops_ms = macs / PEAK_S8_MACS * 1e3
    else:
        out["int32_cuda_core_ms"] = macs / PEAK_INT32_MACS * 1e3
        out["s8_tensor_core_ms"] = macs * s8_limbs / PEAK_S8_MACS * 1e3
        out["s8_limbs_per_mac"] = s8_limbs
        ops_ms = min(out["int32_cuda_core_ms"], out["s8_tensor_core_ms"])
    ops_ms += int32_adds / PEAK_INT32_ADDS * 1e3
    out["bound_ms"] = max(bytes_ms, ops_ms)
    out["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    return out


def roll_add_instance(words: int) -> str:
    """The chained roll+add's instance of E = `words` (`roll_add_words`; 0: shared memory), by name."""
    return f"registers E={words}" if words else "shared"


def rotation_bound(p, batch: int, tv_words: int, multibit: bool) -> dict:
    """Bound of one blind rotation of `batch` ciphertexts: n0 steps (n0/2
    groups with a multi-bit key) of 2L x 2 negacyclic products of N x N
    multiply-adds; the key streamed once. One 32-bit multiply-add is
    (4 - dropped limbs of the key) x (digit limbs) s8 products."""
    g, n = p.trgsw_lv1, p.n1
    steps = p.n0 // 2 if multibit else p.n0
    macs = batch * steps * 2 * g.l * 2 * n * n
    key_words = (p.n0 // 2 * 4 if multibit else p.n0) * 2 * g.l * 2 * n
    nbytes = 4 * (batch * (p.n0 + 1) + tv_words + key_words + batch * 2 * n)
    limbs = (4 - p.bsk_round_bits // 8) * -(-g.bgbit // 8)
    return {"macs": macs, **bound(nbytes, macs, limbs)}


def case_row(case: str, ms: float, plain_ms: float, bnd: dict, instance=None) -> dict:
    """One compared case as it goes into the kernels line."""
    row = {"case": case, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd["bound_ms"],
           "bound_by": bnd["bound_by"], "bound": bnd}
    if instance is not None:
        row["instance"] = list(instance)
    return row


def show_earlier(kernel: str, case: str) -> str:
    """The log's note of a case's time before the redesign, where PERF.md has one."""
    ms = EARLIER_MS[kernel].get(case)
    return "" if ms is None else f" (before the redesign {ms} ms, PERF.md)"


def show_bound(b: dict) -> str:
    return f"bound {b['bound_ms']:.3g} ms by {b['bound_by']}"


def sm_clock_mhz() -> float:
    """The card's highest SM clock, MHz (nvidia-smi clocks.max.sm): what the
    tile loop's cycle counts are turned into time with. An H100 SXM at its
    700 W limit held it under these loads in every earlier run (PERF.md)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0])


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
    regs = [int(line.split("Used ")[1].split()[0]) for line in log if "Used " in line and "registers" in line]
    spills = [line.strip() for line in log if "spill" in line and "0 bytes spill stores" not in line]
    print(f"[2] ptxas: {len(regs)} kernel instances, at most {max(regs)} registers per thread, "
          f"{len(spills)} with spills {elapsed()}")
    for line in spills:
        print(f"[2]   {line}")
    # the probe dots must run wgmma (SASS IGMMA) and no mma.sync (IMMA); the s16/s32 byte-limb dots also
    # its u8 forms, and they load no operand into registers (no LDG, no LDS: the copy engine feeds the
    # tensor cores, so there is no CUDA-core dot loop); the roll, the bitcast and the unpack must move 16
    # bytes a global load and store (LDG/STG with .128)
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    limb_kernels = ("dot_limbs_tile_kernel", "dot_limbs_split_kernel")
    wgmma_kernels = ("dot_wgmma_s8_kernel", "chain_dot_wgmma_kernel") + limb_kernels
    copy_kernels = ("roll_kernel", "bitcast_i32_to_i8_kernel", "unpack_s16_kernel")
    # and the chained roll+add's register instances, by E, every instruction by its name
    ops, kernel = {k: {} for k in wgmma_kernels + copy_kernels}, None
    regs, e = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = next((k for k in ops if k in line), None)
            e = int(line.split("roll_add_regs_kernelILi")[1].split("E")[0]) if "roll_add_regs_kernelILi" in line else None
            if e is not None:
                regs[e] = collections.Counter()
        elif (kernel is not None or e is not None) and "*/" in line:
            words = line.split("*/")[1].split()
            words = words[1:] if words and words[0].startswith("@") else words  # past a predicate
            if not words:
                continue
            if kernel is not None and ("MMA" in words[0] or words[0].startswith(("LDG", "STG", "LDS", "RED"))):
                ops[kernel][words[0]] = ops[kernel].get(words[0], 0) + 1
            if e is not None:
                regs[e][words[0].split(".")[0]] += 1
    print(f"[2] tensor-core instructions, loads and reductions of the probe dots (cuobjdump -sass): "
          f"{ {k: ops[k] for k in wgmma_kernels} }")
    check(all(any(op.startswith("IGMMA") for op in ops[k]) and not any(op.startswith("IMMA") for op in ops[k])
              for k in wgmma_kernels), "the probe dots run wgmma (IGMMA) and no mma.sync (IMMA)")
    check(all(any(op.startswith("IGMMA") and "U8" in op for op in ops[k]) for k in limb_kernels),
          "the byte-limb dots run the u8 forms of wgmma")
    check(not any(op.startswith(("LDG", "LDS")) for k in limb_kernels for op in ops[k]),
          "the byte-limb dots load no operand into registers (no CUDA-core dot loop)")
    # the rotation's wgmma instance: every instantiation runs the u8 x s8 wgmma and no mma.sync, and
    # ptxas serialises none of its wgmma (no note names it: C7515, or C7518 for a branch on the thread
    # between wgmma groups)
    rotation = {}
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = line.split("Function :")[1].strip() if "blind_rotate_wgmma_kernel" in line else None
            if kernel is not None:
                rotation[kernel] = collections.Counter()
        elif kernel is not None and "*/" in line:
            words = line.split("*/")[1].split()
            words = words[1:] if words and words[0].startswith("@") else words
            if words and "MMA" in words[0]:
                rotation[kernel][words[0]] += 1
    print(f"[2] tensor-core instructions of the rotation's wgmma instance: { {k: dict(v) for k, v in rotation.items()} }")
    check(len(rotation) >= 1 and all(any(op.startswith("IGMMA") and "U8" in op for op in ops)
                                     and not any(op.startswith("IMMA") for op in ops) for ops in rotation.values()),
          "the rotation's wgmma instance runs IGMMA with U8 operands and no IMMA")
    serialised = [line for line in log if "serialized" in line and "blind_rotate_wgmma_kernel" in line]
    check(not serialised, f"ptxas serialises no wgmma of the rotation's wgmma instance ({serialised[:1]})")
    print(f"[2] global loads and stores of the copy kernels: { {k: ops[k] for k in copy_kernels} }")
    check(all(any(op.startswith(kind) and ".128" in op for op in ops[k])
              for k in copy_kernels for kind in ("LDG", "STG")),
          "the roll, bitcast and unpack kernels hold 128-bit global loads and stores (LDG/STG .128)")
    # each register instance of the chained roll+add keeps its row in registers: shuffles, and no shared
    # memory, barrier or local memory
    from rs_tfhe_tpu_torch.ops import cuda_probes as CP

    shown = {e: {"all": sum(c.values()), **{k: c[k] for k in ("IADD3", "IMAD", "SHFL", "LDS", "STS", "BAR", "LDL",
                                                                 "STL", "LDG", "STG")}}
             for e, c in sorted(regs.items())}
    print(f"[2] the roll+add register instances by E, all instructions, adds, shuffles and memory instructions: "
          f"{shown}")
    check(sorted(regs) == sorted(CP.ROLL_ADD_WORDS), f"a register instance of the roll+add for each E in "
                                                     f"{CP.ROLL_ADD_WORDS} (found {sorted(regs)})")
    check(all(c["SHFL"] > 0 and not any(c[k] for k in ("LDS", "STS", "BAR", "LDL", "STL")) for c in shown.values()),
          "the roll+add register instances hold SHFL and no LDS, STS, BAR, LDL or STL")


#: Phase 3f's sweep of the key switch: the selection kernel against the
#: product route at these batches (FAST table).
KS_SWEEP_BATCHES = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)


def phase_key_switch_vs_plain(dev) -> dict:
    """The small-batch key switch kernel against its plain version, the
    one-hot product route (`ops.keyswitch._product_sum`), bit for bit, both
    device times by CUDA events around runs queued behind a spin kernel
    (`queued_ms`: the kernel's host path, also printed, is longer than its
    device time), over inputs that cycle through 8 batches (the table,
    103.8 MB, exceeds the L2), `torch._int_mm` alone on the padded
    one-hot operand as the library time, and the bound: the distinct rows
    the batch selects read once, its ciphertexts read and its results
    written, over 3.35 TB/s. Then the sweep at FAST, which prints the
    largest batch up to which the kernel beats the product at every batch
    of the sweep, beside `KS_SELECT_MAX_BATCH`."""
    import itertools

    from rs_tfhe_tpu_torch import params as P
    from rs_tfhe_tpu_torch.ops import cuda_keyswitch
    from rs_tfhe_tpu_torch.ops import keyswitch as KS

    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    rnd = _rnd(g, dev)
    tables = {}
    rows, tiles, max_err = {}, set(), 0

    def table_of(p):
        gp = p.trgsw_lv1
        if p not in tables:
            w = -(-(p.n0 + 1) // 8) * 8
            tables[p] = torch.randint(-128, 128, (p.n1 * gp.iks_t << gp.basebit, 4 * w), generator=g,
                                      dtype=torch.int8, device=dev)
        return tables[p]

    def measure(p, batch, reps):
        """(kernel ms, product ms, library ms, bound, max error, instance) at one batch."""
        nonlocal max_err
        gp, n1, width = p.trgsw_lv1, p.n1, p.n0 + 1
        t, basebit, table = gp.iks_t, gp.basebit, table_of(p)
        cts = [rnd((batch, n1 + 1)) for _ in range(8)]
        cts[0][0, :2] = torch.tensor([-(1 << 31), -1], dtype=torch.int32)
        cts[0][-1, -1] = -(1 << 31)
        a, body = cts[0][..., :n1], cts[0][..., n1]
        out, tile = launched_tile("ks.instance", lambda: cuda_keyswitch.digit_select_kernel(
            a, body, table, t, basebit, width))
        ref = -KS._product_sum(a, table, t, basebit, width)
        ref[..., width - 1] += body
        torch.cuda.synchronize()
        err = max_abs_err(out, ref)
        check(torch.equal(out, ref), f"key switch kernel == product at {_name(p)} B={batch}")
        max_err = max(max_err, err)
        tiles.add(tile)
        it = itertools.cycle(cts)

        def kernel():
            ct = next(it)
            return cuda_keyswitch.digit_select_kernel(ct[..., :n1], ct[..., n1], table, t, basebit, width)

        def product():
            ct = next(it)
            res = -KS._product_sum(ct[..., :n1], table, t, basebit, width)
            res[..., width - 1] += ct[..., n1]
            return res

        k_ms, k_host_ms = queued_ms(kernel, reps)
        p_ms, _ = queued_ms(product, max(2, reps // 10))
        # the one PyTorch call inside the product: _int_mm on the padded one-hot rows
        off = 1 << (31 - basebit * t)
        shifts = 32 - basebit * torch.arange(1, t + 1, dtype=torch.int32, device=dev)
        digits = ((a + off).unsqueeze(-1) >> shifts) & ((1 << basebit) - 1)  # [B, n1, t]
        onehot = (digits.unsqueeze(-1) == torch.arange(1 << basebit, device=dev, dtype=torch.int32))
        lhs = torch.nn.functional.pad(onehot.to(torch.int8).reshape(batch, -1), (0, 0, 0, max(0, 17 - batch)))
        lib_ms, _ = queued_ms(lambda: torch._int_mm(lhs, table), max(2, reps // 10))
        row_ids = (torch.arange(n1 * t, device=dev).reshape(n1, t) << basebit) + digits
        distinct = int(torch.unique(row_ids).numel())
        bnd = {"distinct_rows": distinct, "host_ms": k_host_ms,
               **bound(distinct * table.shape[1] + 4 * batch * (n1 + 1) + 4 * batch * width)}
        return k_ms, p_ms, lib_ms, bnd, err, tile

    for p in (P.SECURITY_128_BIT_FAST, P.SECURITY_128_BIT):
        for batch in (1, 16):
            k_ms, p_ms, lib_ms, bnd, err, tile = measure(p, batch, 200)
            case = f"{_name(p)} B={batch}"
            print(f"[3f] key_switch {case} ({tile[0]} ciphertexts a block; {bnd['distinct_rows']} distinct rows "
                  f"of {table_of(p).shape[0]}): max_abs_err={err} kernel {k_ms:.4f} ms (host path "
                  f"{bnd['host_ms']:.4f} ms a call), product route {p_ms:.4f} ms, torch._int_mm {lib_ms:.4f} ms, "
                  f"{show_bound(bnd)}")
            rows[case] = {**case_row(case, k_ms, p_ms, bnd, tile), "library_ms": lib_ms}
    sweep, cap = {}, 0
    for batch in KS_SWEEP_BATCHES:
        k_ms, p_ms, lib_ms, bnd, err, tile = measure(P.SECURITY_128_BIT_FAST, batch, 50)
        sweep[batch] = {"kernel_ms": k_ms, "kernel_host_ms": bnd["host_ms"], "product_ms": p_ms, "int_mm_ms": lib_ms,
                        "bound_ms": bnd["bound_ms"],
                        "distinct_rows": bnd["distinct_rows"], "instance": list(tile)}
        if cap == batch // 2 and k_ms < p_ms:
            cap = batch
        print(f"[3f] sweep FAST B={batch}: kernel {k_ms:.4f} ms, product route {p_ms:.4f} ms, "
              f"torch._int_mm {lib_ms:.4f} ms, {show_bound(bnd)}")
    print(f"[3f] the kernel beats the product at every swept batch up to B={cap}; "
          f"KS_SELECT_MAX_BATCH = {KS.KS_SELECT_MAX_BATCH}; sweep {json.dumps(sweep)}")
    print(f"[3f] done {elapsed()}")
    return {"max_abs_err": max_err, **rows["128_BIT_FAST B=1"], "cases": list(rows.values()), "sweep": sweep,
            "sweep_cap": cap, "tiles_compared": tile_list(tiles)}


def _rnd(g, dev):
    def rnd(shape, lo=-(1 << 31), hi=1 << 31):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32, device=dev)

    return rnd


def _name(p) -> str:
    from rs_tfhe_tpu_torch import params as P

    names = {v: k for k, v in P.ALL_SECURITY_SETS.items()}
    if p in names:
        return names[p].removeprefix("SECURITY_")
    return "TEST_TINY" if p == P.TEST_TINY else f"N{p.n1}_DEMO"  # the radix examples' N=512 sets


def phase_kernel_vs_plain(dev) -> dict:
    from rs_tfhe_tpu_torch import _build
    from rs_tfhe_tpu_torch import params as P
    from rs_tfhe_tpu_torch.key import SecretKey, gen_bootstrapping_key
    from rs_tfhe_tpu_torch.ops import cuda_blind_rotate, cuda_launch
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
    p_nibble = P.SECURITY_128_BIT_NIBBLE
    nibble_bsk = rnd((p_nibble.n0, 2 * p_nibble.trgsw_lv1.l, 2, p_nibble.n1))
    fast = P.SECURITY_128_BIT_FAST
    demo = load_example("radix_integers.py").DEMO  # N = 512; ciphertext_multiply's TINY_MUL is the same ring
    demo_bsk = rnd((demo.n0, 2 * demo.trgsw_lv1.l, 2, demo.n1))

    def random_bsk(p):
        return rnd((p.n0, 2 * p.trgsw_lv1.l, 2, p.n1))

    def instance_of(p, batch, bsk):
        """The instance the wrapper picks: tile and cluster from the batch and the clusters the
        card holds, the unit from the parameter set, the key's limbs from the key."""
        has_mma = p.n1 in cuda_blind_rotate.MMA_RING_SIZES and cuda_launch.takes_tensor_cores(p)
        limbs = cuda_blind_rotate.key_limbs(bsk, p) if has_mma else 0
        tile, cluster, limbs = cuda_blind_rotate.planned_instance(dev.index or 0, batch, p, limbs)
        unit = cuda_blind_rotate.tensor_core_unit(cuda_blind_rotate.on_wgmma(p.n1, tile, limbs), limbs)
        return (p.n1, tile, cluster, unit if limbs else "imad")

    # the wgmma instance's key operand (FAST, three limbs) against its plain build, byte for byte, a
    # stretch of steps at a time; the build's time against the bytes it writes and reads
    strips = cuda_blind_rotate.key_strips(fast_bsk, fast, 32, 3)
    step_bytes = strips.numel() // fast.n0
    strips_equal = all(
        torch.equal(strips[i * step_bytes:(i + 50) * step_bytes], cuda_blind_rotate.key_strips_plain(
            fast_bsk[i:i + 50], 3)) for i in range(0, fast.n0, 50))
    lib = _build.load()
    strip_ms = cuda_ms(lambda: lib.tfhe_blind_rotate_strips(
        fast_bsk.data_ptr(), strips.data_ptr(), fast.n0, 10, fast.trgsw_lv1.l, 32, 3,
        torch.cuda.current_stream(dev).cuda_stream), 5)
    strip_bound = bound(strips.numel() + fast_bsk.numel() * 4)
    print(f"[3a] key strips {_name(fast)} ({strips.numel()} bytes, {strips.numel() / (fast_bsk.numel() * 4):.1f} "
          f"times the key): equal to key_strips_plain={strips_equal}; build {strip_ms:.3f} ms, "
          f"{show_bound(strip_bound)}")
    check(strips_equal, "the wgmma instance's key strips == key_strips_plain at 128_BIT_FAST")
    del strips

    for log_n in (6, 10, 11, 12):
        print(f"[3a] clusters the card holds at one block an SM, N=2^{log_n}: "
              f"{cuda_launch.cluster_slots(dev.index or 0, log_n, cuda_blind_rotate.held_clusters)}")
    for p, limbs in ((fast, 3), (fast, 4), (p_strict, 4), (p_radix, 4)):
        print(f"[3a] clusters of the tensor-core instance the card holds, {_name(p)}, {limbs} key limbs, by tile: "
              f"{cuda_blind_rotate.mma_slots(dev.index or 0, p, limbs)}")
    radix_full = instance_of(p_radix, 2048, radix_bsk)  # the allow_mb=False PBS of phase 8, multi-value of phase 12
    radix_batch = next(b for b in range(1, 2049) if instance_of(p_radix, b, radix_bsk) == radix_full)
    cases = [
        (fast, fast_bsk, 1, False, True),
        (fast, fast_bsk, 8, False, True),
        (fast, fast_bsk, 8, True, True),
        (fast, fast_bsk, 16, False, True),
        (fast, fast_bsk, 128, False, True),
        (fast, fast_bsk, 256, False, True),
        (fast, fast_bsk, 4096, False, True),
        (fast, rnd(tuple(fast_bsk.shape)), 64, True, True),  # a key off the 2^8 grid keeps all four limbs
        (p_strict, strict_bsk, 4, False, True),
        (p_strict, strict_bsk, 512, False, True),
        (p_uint4, uint4_bsk, 8, False, True),
        (p_radix, radix_bsk, 528, False, True),  # N = 2048
        (p_radix, radix_bsk, radix_batch, False, True),
        (p_nibble, nibble_bsk, 1, False, True),  # N = 4096
        (p_uint4, uint4_bsk, 16, False, True),  # lut_uint_parameters_demo's batch
        (demo, demo_bsk, 16, False, True),  # N = 512: the radix examples' digit batches
    ]
    # phase 17's Uint runs at the batch lut_uint_parameters_demo gives each set (the message modulus,
    # 2 to 16), and gates_with_strategies at the 80- and 110-bit sets (B = 4)
    for k, batch in zip(range(1, 9), (2, 4, 8, 16, 16, 16, 16, 16)):
        if k != 4:  # UINT4's is timed above
            p_uint = getattr(P, f"SECURITY_UINT{k}")
            cases.append((p_uint, random_bsk(p_uint), batch, False, False))
    cases += [(p, random_bsk(p), 4, False, False) for p in (P.SECURITY_80_BIT, P.SECURITY_110_BIT)]
    # every other instance a circuit's batches (1..128 rows) can take: the largest batch of each
    held = {instance_of(p, batch, bsk) for p, bsk, batch, _, _ in cases}
    by_instance = {}
    for batch in range(1, 129):
        by_instance[instance_of(fast, batch, fast_bsk)] = batch
    cases += [(fast, fast_bsk, batch, False, False) for inst, batch in sorted(by_instance.items()) if inst not in held]
    held.update(by_instance)
    # the instances of the radix phases' batches, of phase 16's (the data-parallel shards of FAST
    # B = 4096 on four shards and on the visible cards, the strict references at B = 8, the dry run's
    # TEST_TINY shards), of phase 18's soak, of phase 19's benches and of phase 20's validation and
    # diag, each at the smallest batch that takes it
    tiny = P.TEST_TINY
    tiny_bsk = rnd((tiny.n0, 2 * tiny.trgsw_lv1.l, 2, tiny.n1))
    parallel_fast = (4096 // 4, 4096 // max(1, torch.cuda.device_count()))
    for p, bsk, batches in ((p_radix, radix_bsk, RADIX_BATCHES), (p_nibble, nibble_bsk, NIBBLE_BATCHES),
                            (fast, fast_bsk, parallel_fast), (p_strict, strict_bsk, (8, *SOAK_STRICT_BATCHES)),
                            (p_nibble, nibble_bsk, SOAK_NIBBLE_BATCHES), (tiny, tiny_bsk, (2,)),
                            (fast, fast_bsk, BENCH_BATCHES[_name(fast)]),
                            (p_strict, strict_bsk, BENCH_BATCHES[_name(p_strict)]),
                            *((p, bsk, VALIDATION_BATCHES[_name(p)]) for p, bsk in (
                                (p_strict, strict_bsk), (fast, fast_bsk), (p_uint4, uint4_bsk),
                                (p_radix, radix_bsk), (p_nibble, nibble_bsk))),
                            *((p, bsk, EXAMPLE_BATCHES[_name(p)]) for p, bsk in (
                                (tiny, tiny_bsk), (demo, demo_bsk), (p_strict, strict_bsk), (fast, fast_bsk),
                                (p_radix, radix_bsk), (p_nibble, nibble_bsk)))):
        for batch in batches:
            inst = instance_of(p, batch, bsk)
            if inst not in held:
                held.add(inst)
                cases.append((p, bsk, next(b for b in range(1, batch + 1) if instance_of(p, b, bsk) == inst),
                              False, False))
    max_err, rows, tiles = 0, {}, set()
    for p, bsk, batch, per_ct, timed_case in cases:
        n = p.n1
        tv = rnd((batch, 2, n) if per_ct else (2, n))
        bnd = rotation_bound(p, batch, tv.numel(), multibit=False)
        b_til, a_til = rnd((batch,), 0, 2 * n), rnd((batch, p.n0), 0, 2 * n)
        out, tile = launched_tile("k1.instance", lambda: blind_rotate_kernel(b_til, a_til, tv, bsk, p))
        check(tile == instance_of(p, batch, bsk), f"the wrapper launched the planned instance at B={batch}")
        tiles.add(tile)
        name = _name(p)
        where = f"(N={tile[0]}, tile {tile[1]}, cluster {tile[2]}, unit {tile[3]})"
        if not timed_case:
            ref = blind_rotate_plain(b_til, a_til, tv, bsk, p)
            torch.cuda.synchronize()
            print(f"[3a] blind_rotate {name} B={batch} {where}: equal={torch.equal(out, ref)} "
                  f"max_abs_err={max_abs_err(out, ref)}")
            check(torch.equal(out, ref), f"kernel == plain at {name} B={batch}")
            continue
        if n >= 2048:  # the plain version is costly here: one timed call each
            k_ms = timed(lambda: blind_rotate_kernel(b_til, a_til, tv, bsk, p))[1]
            ref, p_ms = timed(lambda: blind_rotate_plain(b_til, a_til, tv, bsk, p))
        else:
            ref = blind_rotate_plain(b_til, a_til, tv, bsk, p)
            reps = 1 if batch >= 512 else 3
            k_ms = cuda_ms(lambda: blind_rotate_kernel(b_til, a_til, tv, bsk, p), reps)
            p_ms = cuda_ms(lambda: blind_rotate_plain(b_til, a_til, tv, bsk, p), 1 if batch >= 128 else reps)
        torch.cuda.synchronize()
        err = max_abs_err(out, ref)
        max_err = max(max_err, err)
        case = f"{name} B={batch}" + (" per-ct testvec" if per_ct else "")
        print(
            f"[3a] blind_rotate {name} B={batch} testvec={'per-ct' if per_ct else 'shared'} {where}: "
            f"equal={torch.equal(out, ref)} max_abs_err={err} "
            f"kernel {k_ms:.3f} ms{show_earlier('blind_rotate', case)}, plain {p_ms:.3f} ms, {show_bound(bnd)}"
        )
        check(torch.equal(out, ref), f"kernel == plain at {name} B={batch}")
        rows[(name, batch, per_ct)] = case_row(case, k_ms, p_ms, bnd, tile)
    print(f"[3a] done {elapsed()}")
    return {"max_abs_err": max_err, **rows[("128_BIT_FAST", 4096, False)], "library_ms": None,
            "cases": list(rows.values()), "tiles_compared": tile_list(tiles),
            "strip_build": {"ms": strip_ms, "bound_ms": strip_bound["bound_ms"], "equal_to_plain": strips_equal}}


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
        """Full-range words, with 0x80000000 and 0xFFFFFFFF in every pattern."""
        key = rnd((p.n0 // 2, 4, 2 * p.trgsw_lv1.l, 2, p.n1))
        key[:, :, 0, 0, ::7], key[:, :, -1, 1, 3::11] = -(1 << 31), -1
        return key

    strict, radix, nibble = P.SECURITY_128_BIT, P.SECURITY_128_BIT_RADIX, P.SECURITY_128_BIT_NIBBLE
    strict_mb, radix_mb = random_key(strict), random_key(radix)
    # the batches `auto` sends (at most mb_route_batch_cap), and one batch that
    # step_impl="fused_small_mb" gives the single-block instance
    cases = [
        (fast, fast_mb, 1, False), (fast, fast_mb, 2, False), (fast, fast_mb, 2, True),
        (strict, strict_mb, 1, False), (strict, strict_mb, 4, False),
        (radix, radix_mb, 1, False), (radix, radix_mb, 2, False),
        (nibble, random_key(nibble), 1, False),
        (fast, fast_mb, 1024, False),
        (P.TEST_TINY, random_key(P.TEST_TINY), 1, False),  # low_latency_gates at its default set
    ]
    # the instances of phase 19's sweep (fused_small_mb at B = 8, auto_mb at strict B = 2) and of
    # phase 20 (VALIDATION_MB_BATCHES) that the cases above do not take, each at the smallest batch that takes it; the cluster check below is
    # the route's rule for the batches `auto` sends, so it holds the cases above only
    auto_cases = len(cases)
    held = {(p.n1, *cuda_blind_rotate_mb.planned_instance(dev.index or 0, batch, p)) for p, _, batch, _ in cases}
    for p, key in ((fast, fast_mb), (strict, strict_mb)):
        for batch in (*BENCH_MB_BATCHES[_name(p)], *VALIDATION_MB_BATCHES[_name(p)]):
            inst = (p.n1, *cuda_blind_rotate_mb.planned_instance(dev.index or 0, batch, p))
            if inst not in held:
                held.add(inst)
                first = next(b for b in range(1, batch + 1)
                             if (p.n1, *cuda_blind_rotate_mb.planned_instance(dev.index or 0, b, p)) == inst)
                cases.append((p, key, first, False))
    max_err, rows, tiles = 0, {}, set()
    for i, (p, key, batch, per_ct) in enumerate(cases):
        n = p.n1
        tv = rnd((batch, 2, n) if per_ct else (2, n))
        bnd = rotation_bound(p, batch, tv.numel(), multibit=True)
        b_til, a_til = rnd((batch,), 0, 2 * n), rnd((batch, p.n0), 0, 2 * n)
        out, tile = launched_tile("k4.instance", lambda: blind_rotate_mb_kernel(b_til, a_til, tv, key, p))
        check(tile == (n, *cuda_blind_rotate_mb.planned_instance(dev.index or 0, batch, p)),
              f"the multi-bit wrapper launched the planned instance at B={batch}")
        if i < auto_cases:
            check((tile[2] > 1) == (batch <= 4), "the batches auto sends take the cluster instance")
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
        case = f"{name} B={batch}" + (" per-ct testvec" if per_ct else "")
        print(
            f"[3b] blind_rotate_mb {name} B={batch} testvec={'per-ct' if per_ct else 'shared'} "
            f"(N={tile[0]}, tile {tile[1]}, cluster {tile[2]}): equal={torch.equal(out, ref)} max_abs_err={err} "
            f"kernel {k_ms:.3f} ms{show_earlier('blind_rotate_mb', case)}, plain {p_ms:.3f} ms, {show_bound(bnd)}"
        )
        check(torch.equal(out, ref), f"multi-bit kernel == plain at {name} B={batch}")
        rows[(name, batch, per_ct)] = case_row(case, k_ms, p_ms, bnd, tile)
    print(f"[3b] done {elapsed()}")
    return {"max_abs_err": max_err, **rows[("128_BIT_FAST", 1, False)], "library_ms": None,
            "cases": list(rows.values()), "tiles_compared": tile_list(tiles)}


def phase_step_kernel_vs_plain(dev) -> dict:
    from rs_tfhe_tpu_torch import params as P
    from rs_tfhe_tpu_torch.ops import cuda_launch
    from rs_tfhe_tpu_torch.ops.cuda_step import external_product_kernel
    from rs_tfhe_tpu_torch.ops.poly import _step_circulant, polymul_small_by_torus

    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    rnd = _rnd(g, dev)
    max_err, rows, tiles = 0, {}, set()
    fast, strict = P.SECURITY_128_BIT_FAST, P.SECURITY_128_BIT
    # (set, batch, gadget rows J; None: all 2L, the per-step route's); then the tensor-parallel shards'
    # J = 2L/tp of phase 16 (FAST tp = 4 and 2, strict tp = 2) and of its dry run (TEST_TINY tp = 2)
    plan = ((fast, 2048, None), (fast, 8, None), (strict, 512, None), (strict, 8, None),
            (P.SECURITY_128_BIT_RADIX, 64, None), (P.SECURITY_UINT4, 8, None),
            (fast, 1, 1), (fast, 8, 1), (fast, 1, 2), (fast, 8, 2), (strict, 1, 3), (strict, 8, 3),
            (P.TEST_TINY, 4, 3))
    for p, batch, j in plan:
        gp, n = p.trgsw_lv1, p.n1
        j = 2 * gp.l if j is None else j
        digits = rnd((batch, j, n), -gp.half_bg, gp.half_bg)
        trgsw = rnd((j, 2, n))
        digits[0, :, ::3], digits[-1, :, 1::2] = -gp.half_bg, gp.half_bg - 1  # the digit range's ends
        trgsw[0, 0, ::2], trgsw[-1, 1, ::3] = -(1 << 31), -1  # 0x80000000 and 0xFFFFFFFF
        out, tile = launched_tile("k5.instance", lambda: external_product_kernel(digits, trgsw, p))
        check((tile[1] == "mma_s8") == cuda_launch.takes_tensor_cores(p), "single-limb digits take the tensor cores")
        tiles.add(tile)
        ref = polymul_small_by_torus(digits, trgsw, gp.half_bg)
        torch.cuda.synchronize()
        err = max_abs_err(out, ref)
        max_err = max(max_err, err)
        k_ms = cuda_ms(lambda: external_product_kernel(digits, trgsw, p), 5)
        p_ms = cuda_ms(lambda: polymul_small_by_torus(digits, trgsw, gp.half_bg), 5)
        # the one PyTorch call that computes the product: the float64 matmul
        # inside the plain version, on operands laid out beforehand
        lhs, circ = digits.reshape(batch, -1).to(torch.float64), _step_circulant(trgsw)
        lib_ms = cuda_ms(lambda: torch.matmul(lhs, circ), 5)
        del lhs, circ
        macs = batch * j * 2 * n * n
        limbs = 4 * -(-gp.bgbit // 8)
        bnd = {"macs": macs, **bound(4 * (digits.numel() + trgsw.numel() + out.numel()), macs, limbs)}
        name = _name(p)
        case = f"{name} B={batch}" + ("" if j == 2 * gp.l else f" J={j}")
        print(f"[3c] external_product {case} (J={j} of 2L={2 * gp.l}; N={tile[0]}, unit {tile[1]}, "
              f"{tile[2]} rows a block, columns split {tile[3]} ways): "
              f"equal={torch.equal(out, ref)} max_abs_err={err} "
              f"kernel {k_ms:.4f} ms{show_earlier('external_product', case)}, plain {p_ms:.3f} ms, "
              f"float64 torch.matmul {lib_ms:.4f} ms, {show_bound(bnd)}")
        check(torch.equal(out, ref), f"step kernel == plain at {case}")
        rows[(name, batch, j)] = {**case_row(case, k_ms, p_ms, bnd, tile), "library_ms": lib_ms, "j_rows": j}
    print(f"[3c] done {elapsed()}")
    return {"max_abs_err": max_err, **rows[("128_BIT_FAST", 2048, 4)], "cases": list(rows.values()),
            "tiles_compared": tile_list(tiles)}


def phase_crossover(dev) -> dict:
    """Per rotation at B = 1, 2, 4 and 8 of FAST, strict and RADIX: the
    multi-bit kernel's cluster instance (the plan's pick), its single-block
    instance (tile 1) and the whole-rotation kernel (the plan's pick), beside
    the route that `auto` takes with a multi-bit key: the multi-bit rotation
    up to `mb_route_batch_cap` (the JAX package's cap), the standard one
    above it."""
    from rs_tfhe_tpu_torch import params as P
    from rs_tfhe_tpu_torch.ops.blind_rotate import mb_route_batch_cap
    from rs_tfhe_tpu_torch.ops.cuda_blind_rotate import blind_rotate_kernel
    from rs_tfhe_tpu_torch.ops.cuda_blind_rotate_mb import blind_rotate_mb_kernel

    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    rnd = _rnd(g, dev)
    table = {}
    for p in (P.SECURITY_128_BIT_FAST, P.SECURITY_128_BIT, P.SECURITY_128_BIT_RADIX):
        n, gp = p.n1, p.trgsw_lv1
        bsk, tv = rnd((p.n0, 2 * gp.l, 2, n)), rnd((2, n))
        bsk_mb = rnd((p.n0 // 2, 4, 2 * gp.l, 2, n))
        name, cap = _name(p), mb_route_batch_cap(p)
        for batch in (1, 2, 4, 8):
            b_til, a_til = rnd((batch,), 0, 2 * n), rnd((batch, p.n0), 0, 2 * n)
            cluster = cuda_ms(lambda: blind_rotate_mb_kernel(b_til, a_til, tv, bsk_mb, p), 1)
            single = cuda_ms(lambda: blind_rotate_mb_kernel(b_til, a_til, tv, bsk_mb, p, tile=1, cluster=1), 1)
            std = cuda_ms(lambda: blind_rotate_kernel(b_til, a_til, tv, bsk, p), 1)
            route = "multi-bit" if batch <= cap else "standard"
            bnds = [rotation_bound(p, batch, tv.numel(), multibit=m)["bound_ms"] for m in (False, True)]
            table[f"{name} B={batch}"] = {"blind_rotate_mb_cluster_ms": cluster, "blind_rotate_mb_single_ms": single,
                                          "blind_rotate_ms": std, "auto_route_mb_key": route,
                                          "blind_rotate_bound_ms": bnds[0], "blind_rotate_mb_bound_ms": bnds[1]}
            print(f"[3d] {name} B={batch}: multi-bit cluster {cluster:.2f} ms, single block {single:.2f} ms, "
                  f"whole-rotation {std:.2f} ms (bounds {bnds[1]:.3g} / {bnds[0]:.3g} ms); "
                  f"a multi-bit key takes the {route} rotation here (cap {cap})")
    print(f"[3d] crossover table: {json.dumps(table)}")
    print(f"[3d] done {elapsed()}")
    return table


def phase_fixture(dev) -> None:
    from rs_tfhe_tpu_torch import bit_utils, gates, key
    from rs_tfhe_tpu_torch.bootstrap import bootstrap_with_testvec
    from rs_tfhe_tpu_torch.lut import factor_test_vectors, multi_value_bootstrap
    from rs_tfhe_tpu_torch.models import circuits, netlist
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
    a, b, m, a5, b5 = (to_torch(v[n], dev) for n in ("ct_a", "ct_b", "ct_m", "ct_a5", "ct_b5"))
    lut, lut_per_ct = to_torch(v["lut"], dev), to_torch(v["lut_per_ct"], dev)
    b_til, a_til = rotation_exponents(a, TEST_TINY)
    k1_before = rotation_launches()[0]
    nand_b5 = gates.nand(a5, b5, ck)  # above the multi-bit route's batch cap: the standard rotation, as in JAX
    check(rotation_launches()[0] == k1_before + 1, "a multi-bit key above the cap takes the whole-rotation kernel")
    compare({
        "blind_rotate_mb": blind_rotate_mb_kernel(b_til, a_til, ck.testvec, ck.bsk_mb, TEST_TINY),
        "nand_b1": gates.nand(a[:1], b[:1], ck),
        "nand_b5": nand_b5,
        "pbs_mb": bootstrap_with_testvec(m, lut, ck, allow_mb=True),
        "pbs_std": bootstrap_with_testvec(m, lut, ck, allow_mb=False),
        "pbs_mb_per_ct": bootstrap_with_testvec(m, lut_per_ct, ck, allow_mb=True),
    }, v, os.path.basename(FIXTURE_MB))

    v = np.load(FIXTURE_CIRCUITS)
    sk = key.secret_key_from_numpy({"lv0": v["sk_lv0"], "lv1": v["sk_lv1"]}, TEST_TINY, dev)
    ck = key.cloud_key_from_numpy(v, TEST_TINY, dev)
    xs, ys, m, luts = (to_torch(v[n], dev) for n in ("ct_x", "ct_y", "ct_m", "luts"))
    ckt, _, _, sums = netlist.ripple_carry_adder(xs.shape[1])
    adder_in = torch.cat([xs[0], ys[0]])
    outputs = {
        "adder_wires": netlist.evaluate(ckt, adder_in, ck),
        "add_kogge_stone": circuits.add_kogge_stone(xs, ys, ck),
        "mul_csa": circuits.mul_csa(xs, ys, ck),
        "multi_value": multi_value_bootstrap(m, factor_test_vectors(list(luts)), ck),
    }
    compare(outputs, v, os.path.basename(FIXTURE_CIRCUITS))
    compiled = netlist.compile_circuit(ckt)(adder_in, ck)
    check(np.array_equal(to_numpy(compiled), v["adder_wires"]), "compile_circuit equals the JAX fixture")
    mask = (1 << xs.shape[1]) - 1
    for i, (x, y) in enumerate(v["pairs"]):
        check(bit_utils.decrypt_uint(outputs["add_kogge_stone"][i], sk.lv0) == (x + y) & mask, "fixture sum decrypts")
        check(bit_utils.decrypt_uint(outputs["mul_csa"][i], sk.lv0) == (x * y) & mask, "fixture product decrypts")
    check(bit_utils.decrypt_uint(outputs["adder_wires"][sums], sk.lv0) == int(v["pairs"][0].sum()) & mask,
          "fixture adder decrypts")
    from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_message

    for k, f in enumerate(FIXTURE_MV_FUNCTIONS):
        got = lwe_decrypt_message(outputs["multi_value"][:, k], sk.lv0, FIXTURE_MV_MODULUS)
        check(bool((got == f(v["msgs"])).all()), f"fixture multi-value output {k} decrypts")

    v = np.load(FIXTURE_RADIX)
    before = rotation_launches()
    compare(radix_fixture_outputs(v, dev), v, os.path.basename(FIXTURE_RADIX))
    now = rotation_launches()
    check(now[0] > before[0] and now[1] > before[1], "the radix fixture ran on both rotation kernels")

    v = np.load(FIXTURE_PARALLEL)
    before = rotation_launches()
    k5_before = counters()["k5.launches"]
    compare(parallel_fixture_outputs(v, dev), v, os.path.basename(FIXTURE_PARALLEL))
    now = rotation_launches()
    check(now[0] > before[0] and now[1] > before[1] and counters()["k5.launches"] > k5_before,
          "the parallel fixture ran on both rotation kernels and the step kernel")
    print(f"[4] done {elapsed()}")


def parallel_fixture_outputs(v, dev) -> dict:
    """The port's outputs for the parallel fixture's stored JAX outputs
    (JAX's 8 virtual CPU devices), on meshes of `dev` repeated (as
    tests/test_torch_parallel.py replays them on CPU devices)."""
    from rs_tfhe_tpu_torch import config, gates, key, parallel
    from rs_tfhe_tpu_torch.params import TEST_TINY
    from rs_tfhe_tpu_torch.torus import to_torch

    ck_mb = key.cloud_key_from_numpy(v, TEST_TINY, dev)
    ck = key.cloud_key_from_numpy({k: v[k] for k in ("testvec", "bsk", "ksk_limbs")}, TEST_TINY, dev)
    a, b, c, m3, m2 = (to_torch(v[n], dev) for n in ("ct_a", "ct_b", "ct_c", "ct_m3", "ct_m2"))
    mesh8, mesh4 = (parallel.make_mesh(n, devices=[dev] * n) for n in (8, 4))
    mesh_tp = parallel.make_mesh(8, tp=2, devices=[dev] * 8)
    dp_lut, tp_lut = FIXTURE_PARALLEL_LUTS
    out = {
        "dp_nand_b11_on8": parallel.data_parallel_gate("nand", a[:11], b[:11], ck, mesh8),
        "dp_xor_b8_on4": parallel.data_parallel_gate("xor", a[:8], b[:8], ck, mesh4),
        "dp_mux_b8_on4": parallel.data_parallel_mux(a[:8], b[:8], c[:8], ck, mesh4),
        "dp_lut_b8_on4": parallel.data_parallel_lut_bootstrap(m3, dp_lut, 4, ck, mesh4),
        "dp_nand_mb_b16_on4": parallel.data_parallel_gate("nand", a, b, ck_mb, mesh4),
        "tp_and_b8_on4x2": parallel.tensor_parallel_gate("and", a[:8], b[:8], ck, mesh_tp),
        "tp_or_b8_on4x2": parallel.tensor_parallel_gate("or", a[:8], b[:8], ck, mesh_tp),
        "tp_lut_b8_on4x2": parallel.tensor_parallel_lut_bootstrap(m2, tp_lut, 4, ck, mesh_tp),
    }
    saved = config.config.step_impl
    config.config.step_impl = "nussbaumer"
    try:
        out["nand_nussbaumer_b4"] = gates.nand(a[:4], b[:4], ck)
    finally:
        config.config.step_impl = saved
    return out


def radix_fixture_outputs(v, dev) -> dict:
    """The port's outputs for the radix fixture's stored JAX outputs, from its
    keys and ciphertexts on `dev` (as tests/test_torch_fixture.py replays
    them on the CPU)."""
    from rs_tfhe_tpu_torch import fhe, key
    from rs_tfhe_tpu_torch.models import arithmetic as A
    from rs_tfhe_tpu_torch.models.sort import sort_radix
    from rs_tfhe_tpu_torch.params import TEST_TINY
    from rs_tfhe_tpu_torch.torus import to_torch

    bb = FIXTURE_RADIX_BASE_BITS
    ck_mb = key.cloud_key_from_numpy(v, TEST_TINY, dev)
    ck = key.cloud_key_from_numpy({k: v[k] for k in ("testvec", "bsk", "ksk_limbs")}, TEST_TINY, dev)
    x, y, sel, srt, u, w = (to_torch(v[n], dev) for n in ("ct_x", "ct_y", "ct_sel", "ct_sort", "ct_u", "ct_v"))
    bits = A.radix_to_bits(x, ck, bb)
    xr, yr = fhe.FheUintRadix(x, bb, ck_mb), fhe.FheUintRadix(y, bb, ck_mb)
    fu, fw = fhe.FheUint(u, ck), fhe.FheUint(w, ck)
    return {
        "add_radix_mv": A.add_radix(x, y, ck, bb, multi_value=True),
        "sub_radix": A.sub_radix(x, y, ck, bb),
        "compare_radix": torch.stack(A.compare_radix(x, y, ck, bb)),
        "radix_to_bits": bits,
        "bits_to_radix": A.bits_to_radix(bits, ck, bb),
        "add_radix": A.add_radix(x, y, ck_mb, bb),
        "mul_radix": A.mul_radix(x, y, ck_mb, bb),
        "select_radix": A.select_radix(sel, x, y, ck_mb, bb),
        "sort_radix": sort_radix(srt, ck_mb, bb, descending=True),
        "fhe_radix_expr": (xr + yr).max(xr).digits,
        "fhe_uint_expr": ((fu + fw) ^ fw).bits,
    }


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
    auto route: the batches above the cap take the whole-rotation kernel
    (with the key's `bsk`), the B = 1 chains the multi-bit kernel's cluster
    instance."""
    from rs_tfhe_tpu_torch import gates
    from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_bool, lwe_encrypt_bool

    sk, ck, g, keygen_ms = _keygen(p, dev, SEED + 40, multibit=True)
    check(ck.bsk_mb is not None and ck.bsk_mb.is_cuda, f"{label}: multi-bit key on the card")
    rng = np.random.default_rng(SEED + 41)
    bits_a, bits_b = (rng.integers(0, 2, batch).astype(bool) for _ in range(2))
    a = lwe_encrypt_bool(g, sk.lv0, bits_a, p.tlwe_lv0.alpha)
    b = lwe_encrypt_bool(g, sk.lv0, bits_b, p.tlwe_lv0.alpha)
    before = rotation_launches()
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
    check_route(before, True, False, f"{label}: the B={batch} batches with a multi-bit key take the whole-rotation kernel")
    before = rotation_launches()
    latency_ms, t5, t25 = _latency_ms(gates.nand, a[:1], b[:1], ck, sk, bool(bits_a[0]), bool(bits_b[0]))
    check_route(before, False, True, f"{label}: the B=1 chains with a multi-bit key take the multi-bit kernel")
    print(f"[{label}] {_name(p)} multi-bit keygen (multibit=True, incl. secret key) {keygen_ms:.1f} ms; "
          f"B={batch} NAND/XOR 100% correct; {batch / per_iter:.1f} gates/s ({per_iter * 1e3:.1f} ms per "
          f"batch, {iters} chained); B=1 latency {latency_ms:.2f} ms "
          f"(chains 5/25: {t5 * 1e3:.1f}/{t25 * 1e3:.1f} ms) {elapsed()}")
    return {"gates_per_s_mb": batch / per_iter, "latency_ms_b1_mb": latency_ms, "keygen_mb_ms": keygen_ms}


def run_pbs(p, dev, label: str) -> dict:
    """Programmable bootstrapping with a multi-bit key: B = 2048 through
    LutBootstrap and B = 256 with per-ciphertext LUTs (above the cap: the
    whole-rotation kernel), B = 1 and 2 through the multi-bit route."""
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

    before = rotation_launches()
    out = pbs(ct)
    correct = float((lwe_decrypt_message(out, sk.lv0, modulus) == f(msgs)).mean())
    check(correct == 1.0, f"{label}: every PBS of the B=2048 batch decrypts correctly")
    t0 = time.perf_counter()
    out = pbs(ct)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    check(bool((lwe_decrypt_message(out, sk.lv0, modulus) == f(msgs)).all()), f"{label}: second B=2048 PBS")
    check_route(before, True, False, f"{label}: a B=2048 PBS with a multi-bit key takes the whole-rotation kernel")
    print(f"[{label}] keygen (multibit=True) {keygen_ms:.1f} ms; B=2048 (3v mod 8): correctness {correct:.6f}, "
          f"{2048 / batch_s:.1f} PBS/s ({batch_s * 1e3:.1f} ms per batch, auto route: the whole-rotation kernel)")
    lut3 = Generator(modulus, p).generate_lookup_table(f).poly.to(dev)
    out, std_ms = timed(lambda: bootstrap_with_testvec(ct, lut3, ck, allow_mb=False))
    check(bool((lwe_decrypt_message(out, sk.lv0, modulus) == f(msgs)).all()),
          f"{label}: every PBS of the B=2048 batch decrypts correctly with allow_mb=False")
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
    before = rotation_launches()
    out = bootstrap_with_testvec(ct[:256], lut, ck)
    check_route(before, True, False, f"{label}: a B=256 PBS with a multi-bit key takes the whole-rotation kernel")
    ok = bool((lwe_decrypt_message(out, sk.lv0, modulus) == (msgs[:256] + which) % modulus).all())
    check(ok, f"{label}: every per-ciphertext-LUT PBS of the B=256 batch decrypts correctly")
    _, per_ct_ms = timed(lambda: bootstrap_with_testvec(ct[:256], lut, ck))

    small = {}
    before = rotation_launches()
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
    check_route(before, False, True, f"{label}: B=1 and 2 PBS with a multi-bit key take the multi-bit kernel")
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


def _device_times(fn) -> list:
    """[(kernel name, device ms)] of one fn() call, from torch.profiler."""
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
            rows.append((evt.key, dev_us / 1e3))
    return rows


def _profile_split(fn) -> dict:
    """Device time by kernel of one fn() call (the first ten by time, the
    rest summed)."""
    rows = sorted(((k[:60], ms) for k, ms in _device_times(fn)), key=lambda r: -r[1])
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


def _load_script(name: str):
    """scripts/<name>.py as a module (the probe scripts live there)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_probes_vs_plain(dev) -> dict:
    """Each of the seven probe kernels against its plain version on random
    inputs, with times, bound and, where one PyTorch call computes the same
    function, that call's time. Returns the kernels-line fields by wrapper
    name."""
    from rs_tfhe_tpu_torch import params as P
    from rs_tfhe_tpu_torch.ops import cuda_probes as CP

    bench = _load_script("bench_hopper_prims")
    g = torch.Generator(device=dev).manual_seed(SEED + 70)
    ranges = {torch.int8: (-128, 128), torch.int16: (-(1 << 15), 1 << 15), torch.int32: (-(1 << 31), 1 << 31)}

    def rnd(shape, dtype):
        return torch.randint(*ranges[dtype], shape, generator=g, dtype=dtype, device=dev)

    def compare(label, kernel, plain, bnd, library=None, reps=20, earlier=None, also=None, timer=cuda_ms):
        """`also`: {name: call} timed beside the library call (into `<name>_ms`); `timer`: what times
        each of the calls."""
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        outs, refs = (out if isinstance(out, tuple) else (out,)), (ref if isinstance(ref, tuple) else (ref,))
        same = all(torch.equal(o, r) for o, r in zip(outs, refs))
        err = max(int((o.to(torch.int64) - r.to(torch.int64)).abs().max()) for o, r in zip(outs, refs))
        k_ms, p_ms = timer(kernel, reps), timer(plain, reps)
        lib_ms = timer(library, reps) if library is not None else None
        also_ms = {f"{name}_ms": timer(fn, reps) for name, fn in (also or {}).items()}
        lib = f", library call {lib_ms:.4f} ms" if lib_ms is not None else ""
        lib += "".join(f", {k.removesuffix('_ms')} {v:.4f} ms" for k, v in also_ms.items())
        was = show_earlier(*earlier) if earlier else ""
        print(f"[3e] {label}: equal={same} max_abs_err={err} kernel {k_ms:.4f} ms{was}, plain {p_ms:.4f} ms{lib}, "
              f"{show_bound(bnd)}")
        check(same, f"probe kernel == plain version: {label}")
        return {**case_row(label, k_ms, p_ms, bnd), "library_ms": lib_ms, **also_ms, "max_abs_err": err}

    def dot_bound(m, k, n, dtype):
        """An s8 multiply-add is one s8 product, an s16 or s32 one as many as the kernel's byte-limb pairs."""
        size = torch.empty((), dtype=dtype).element_size()
        nbytes = size * (m * k + k * n) + 4 * m * n
        return bound(nbytes, m * k * n) if size == 1 else bound(nbytes, m * k * n, len(CP.limb_pairs(size)))

    def dot_library(a, b):
        """One PyTorch call computing the same dot: torch._int_mm (s8); float64 torch.matmul wrapped to
        int32, exact since K 2^30 < 2^53 (s16); none for s32 (no PyTorch call multiplies int32 matrices
        on the card, and float64 keeps 53 of the 64 bits of an s32 product)."""
        if a.dtype == torch.int8:
            return lambda: torch._int_mm(a, b)
        if a.dtype == torch.int16:
            return lambda: (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int64).to(torch.int32)
        return None

    m, k, n = 128, 1024, 256
    dots, correct = [], []
    for dtype in (torch.int8, torch.int16, torch.int32):
        a, b = rnd((m, k), dtype), rnd((k, n), dtype)
        bnd = dot_bound(m, k, n, dtype)
        name = str(dtype).removeprefix("torch.")
        dots.append(compare(f"probe_dot {name} [{m},{k}]x[{k},{n}] on the {CP.dot_unit(dtype)}",
                            lambda: CP.probe_dot(a, b), lambda: CP.dot_plain(a, b), bnd, dot_library(a, b),
                            earlier=("probe_dot", f"{name} [{m},{k}]x[{k},{n}]")))
        if dtype == torch.int8:
            bt = b.t().contiguous()
            dots[-1]["library_b_kmajor_ms"] = cuda_ms(lambda: torch._int_mm(a, bt.t()), 20)
            print(f"[3e]   torch._int_mm with b K-major: {dots[-1]['library_b_kmajor_ms']:.4f} ms")
        elif dtype == torch.int32:
            print("[3e]   no library call: no PyTorch call multiplies int32 matrices on the card, and float64 "
                  "keeps 53 of the 64 bits of an s32 product")
        # P5: operands from numpy's default_rng(0) against the int64 numpy product (raises on a difference)
        out = CP.probe_dot_correct_s16(dev, dtype)
        ra, rb = (torch.from_numpy(v).to(dev) for v in CP.dot_correct_operands(dtype))
        check(torch.equal(out, CP.dot_plain(ra, rb)), f"probe_dot_correct {name}: kernel == plain version")
        correct.append(compare(f"probe_dot_correct {name} (default_rng(0) operands; equal to the int64 numpy product)",
                               lambda: CP.probe_dot(ra, rb), lambda: CP.dot_plain(ra, rb), bnd, dot_library(ra, rb),
                               earlier=("probe_dot", f"{name} [{m},{k}]x[{k},{n}]")))
    # s16 and s32 at a shape whose 1,024 output tiles fill the card (the in-tile instance); the extremes
    # planted, since a wrong limb sign or weight shows at them first
    m = k = n = 4096
    for dtype in (torch.int16, torch.int32):
        a, b = rnd((m, k), dtype), rnd((k, n), dtype)
        info = torch.iinfo(dtype)
        a[0, :3] = torch.tensor([info.min, info.max, -1], dtype=dtype)
        b[:3, -1] = torch.tensor([info.min, info.max, -1], dtype=dtype)
        name = str(dtype).removeprefix("torch.")
        dots.append(compare(f"probe_dot {name} [{m},{k}]x[{k},{n}] on the {CP.dot_unit(dtype)}",
                            lambda: CP.probe_dot(a, b), lambda: CP.dot_plain(a, b), dot_bound(m, k, n, dtype),
                            dot_library(a, b), reps=5, earlier=("probe_dot", f"{name} [{m},{k}]x[{k},{n}]")))
        del a, b

    # P2 and P3 at the TPU probe shape, where a call is its host path (beside the floor: the same wrapper
    # on one word), and at size: the FAST B = 4096 accumulator (4096 x 2 polynomials of N = 1024) for the
    # roll, the FAST cloud key's bsk as [n0 * 2L * 2, N] words for the bitcast. At size every call reads
    # its input from memory (the inputs rotate through copies spanning three times the L2), and the calls
    # are timed on the card behind a sleep kernel, so that a copy shorter than its host path is timed
    # and not the host path (bench_hopper_prims.device_ms).
    floor8, floor32 = rnd((1, 16), torch.int8), rnd((1, 1), torch.int32)
    rolls = []
    for dtype, size in ((torch.int8, 1), (torch.int16, 2), (torch.int32, 4)):
        name = str(dtype).removeprefix("torch.")
        x = rnd((8, 256), dtype)
        rolls.append(compare(f"probe_roll {name} [8,256] by 5", lambda: CP.probe_roll(x, 5),
                             lambda: CP.roll_plain(x, 5), bound(2 * size * x.numel()),
                             lambda: torch.roll(x, 5, dims=1), earlier=("probe_roll", f"{name} [8,256] by 5"),
                             also={"floor_int8_1x16": lambda: CP.probe_roll(floor8, 5)} if size == 1 else None))
        x = rnd((8192, 1024), dtype)
        xs = bench.copies_of(x, 2 * size * x.numel())
        for shift in (5, 1000):
            rolls.append(compare(
                f"probe_roll {name} [8192,1024] by {shift}",
                bench.rotating(lambda t, s=shift: CP.probe_roll(t, s), xs),
                bench.rotating(lambda t, s=shift: CP.roll_plain(t, s), xs), bound(2 * size * x.numel()),
                bench.rotating(lambda t, s=shift: torch.roll(t, s, dims=1), xs),
                earlier=("probe_roll", f"{name} [8192,1024] by {shift}"), timer=bench.device_ms))
        del x, xs
    x = rnd((8, 256), torch.int32)
    bitcasts = [compare("probe_bitcast_i32_to_i8 [8,256]", lambda: CP.probe_bitcast_i32_to_i8(x),
                        lambda: CP.bitcast_i32_to_i8_plain(x), bound(8 * x.numel()), lambda: x.view(torch.int8),
                        earlier=("probe_bitcast_i32_to_i8", "[8,256]"),
                        also={"clone": lambda: x.view(torch.int8).reshape(8, -1).clone(),
                              "floor_int32_1x1": lambda: CP.probe_bitcast_i32_to_i8(floor32)})]
    fast = P.SECURITY_128_BIT_FAST
    key = _keygen(fast, dev, SEED + 71)[1].bsk.reshape(-1, fast.n1)
    keys = bench.copies_of(key, 8 * key.numel())
    rows_ = key.shape[0]
    bitcasts.append(compare(
        f"probe_bitcast_i32_to_i8 [{rows_},{fast.n1}] (the FAST cloud key's bsk)",
        bench.rotating(CP.probe_bitcast_i32_to_i8, keys), bench.rotating(CP.bitcast_i32_to_i8_plain, keys),
        bound(8 * key.numel()), bench.rotating(lambda t: t.view(torch.int8), keys),
        earlier=("probe_bitcast_i32_to_i8", f"[{rows_},{fast.n1}]"),
        also={"clone": bench.rotating(lambda t: t.view(torch.int8).reshape(rows_, -1).clone(), keys)},
        timer=bench.device_ms))

    def halves(t):
        """The int16 halves of each word as [2, R, C] (low, high), one PyTorch call that launches."""
        return t.view(torch.int16).view(*t.shape, 2).permute(2, 0, 1).contiguous()

    unpacks = [compare("probe_unpack_s16 [8,256]", lambda: CP.probe_unpack_s16(x), lambda: CP.unpack_s16_plain(x),
                       bound(8 * x.numel()), lambda: halves(x), earlier=("probe_unpack_s16", "[8,256]"),
                       also={"view": lambda: x.view(torch.int16)})]
    unpacks.append(compare(
        f"probe_unpack_s16 [{rows_},{fast.n1}] (the FAST cloud key's bsk)",
        bench.rotating(CP.probe_unpack_s16, keys), bench.rotating(CP.unpack_s16_plain, keys),
        bound(8 * key.numel()), bench.rotating(halves, keys),
        earlier=("probe_unpack_s16", f"[{rows_},{fast.n1}]"),
        also={"view": bench.rotating(lambda t: t.view(torch.int16), keys)}, timer=bench.device_ms))
    del key, keys

    chains = []
    steps = 3
    clock_mhz = sm_clock_mhz()
    for _, shapes in bench.DOT_SHAPES:
        for m, k, n, _label in shapes:
            a0, b = rnd((m, k), torch.int8), rnd((k, n), torch.int8)
            fm = CP.chain_shape(m, k)[1]
            nbytes = m * k + k * n + 4 * (m * n + fm * k)
            plain = CP.chain_dot_plain(a0, b, steps)
            for unit in ("tensor", "imad"):
                res = CP.chain_dot(a0, b, steps, unit=unit)
                torch.cuda.synchronize()
                same = torch.equal(res.acc, plain[0]) and torch.equal(res.fb, plain[1])
                check(same, f"chain_dot [{m},{k}]x[{k},{n}] on {unit} == plain version after {steps} steps")
                if unit == "tensor":
                    cycles, _sms, busiest = res.tile_loop()
            reps = 1 if m * k * n > 1 << 32 else 5
            k_ms = cuda_ms(lambda: CP.chain_dot(a0, b, steps, unit="tensor"), reps) / steps
            i_ms = cuda_ms(lambda: CP.chain_dot(a0, b, steps, unit="imad"), reps) / steps
            p_ms = cuda_ms(lambda: CP.chain_dot_plain(a0, b, steps), reps) / steps
            # the library's s8 product on the same operands, one dot a call (no lhs rebuild, no barriers),
            # and on b already K-major (the layout cuBLAS takes without a transpose of its own)
            bt = b.t().contiguous()
            lib_ms = cuda_ms(lambda: torch._int_mm(a0, b), 10)
            lib_kmajor_ms = cuda_ms(lambda: torch._int_mm(a0, bt.t()), 10)
            loop_ms = cycles / steps / (clock_mhz * 1e3)
            mac_clk = CP.tile_loop_rate(m, k, n, "tensor", cycles, busiest)
            bnd = bound(nbytes / steps, m * k * n)
            case = f"[{m},{k}]x[{k},{n}] per dot"
            print(f"[3e] chain_dot [{m},{k}]x[{k},{n}] {steps} steps: both units equal to the plain version, "
                  f"max_abs_err=0; per dot: {CP.dot_unit(torch.int8)} {k_ms:.4f} ms"
                  f"{show_earlier('chain_dot', case)} (tile loop {loop_ms:.4f} ms at {clock_mhz:.0f} MHz, "
                  f"{mac_clk:.1f} MAC/clk/SM), int32 {i_ms:.4f} ms, plain {p_ms:.4f} ms, "
                  f"torch._int_mm {lib_ms:.4f} ms (b K-major {lib_kmajor_ms:.4f} ms), {show_bound(bnd)}")
            chains.append({**case_row(case, k_ms, p_ms, bnd), "int32_unit_ms": i_ms, "library_ms": lib_ms,
                           "library_b_kmajor_ms": lib_kmajor_ms,
                           "tile_loop_ms": loop_ms, "mac_per_clk_per_sm": mac_clk, "sm_clock_mhz": clock_mhz,
                           "max_abs_err": 0})
    # P7 at 64 steps, where a call is mostly its host path, and at 16,384, where it is the kernel's time; the
    # extremes planted, since a wrong lane or register in the index map shows at them
    roll_adds = []
    for rows_, cols in bench.ROLL_SHAPES:
        x = rnd((rows_, cols), torch.int32)
        x[0, :2] = torch.tensor([-(1 << 31), -1], dtype=torch.int32)
        words = CP.roll_add_words(cols)
        instance = roll_add_instance(words)
        for reps_chain, timings in ((4, 5), (1024, 3)):
            steps = 16 * reps_chain
            before = counters()
            row = compare(f"chain_roll_add [{rows_},{cols}] {steps} steps",
                          lambda: CP.chain_roll_add(x, reps_chain), lambda: CP.chain_roll_add_plain(x, reps_chain),
                          bound(8 * x.numel(), int32_adds=steps * x.numel()), reps=timings,
                          earlier=("chain_roll_add", f"[{rows_},{cols}] {steps} steps"))
            ran = {w: n for (w,), n in by_instance(counts_since(before), "probes.roll_add.instance").items()}
            check(set(ran) == {words}, f"chain_roll_add [{rows_},{cols}] ran its shape's instance "
                                       f"{instance} (launches by E, 0 shared: {dict(ran)})")
            row.update(instance=instance, ns_per_step=row["ms"] * 1e6 / steps,
                       bound_ns_per_step=row["bound_ms"] * 1e6 / steps)
            print(f"[3e]   {instance}: {row['ns_per_step']:.2f} ns a step, "
                  f"{row['ns_per_step'] / row['bound_ns_per_step']:.2f}x the step's bound "
                  f"{row['bound_ns_per_step']:.3g} ns")
            roll_adds.append(row)
    print(f"[3e] done {elapsed()}")

    def entry(cases, main=0):
        row = {k: v for k, v in cases[main].items() if k != "case"}
        return {**row, "max_abs_err": max(c["max_abs_err"] for c in cases), "case": cases[main]["case"],
                "cases": cases}

    return {
        "probe_dot": entry(dots), "probe_dot_correct_s16": entry(correct, main=1), "probe_roll": entry(rolls),
        "probe_bitcast_i32_to_i8": entry(bitcasts), "probe_unpack_s16": entry(unpacks),
        "chain_dot": entry(chains, main=len(chains) - 1), "chain_roll_add": entry(roll_adds, main=1),
    }


def phase_nussbaumer_dot_vs_plain(dev) -> dict:
    """P1's s16 unit at the Nussbaumer step's shapes (step_impl="nussbaumer"):
    [B, 2L*m] x [2L*m, 8m] for each of the 2r = 16 DFT points, [B, 512] x
    [512, 1024] at SECURITY_128_BIT_FAST (B = 1 and 8) and [8, 768] x
    [768, 1024] at SECURITY_128_BIT (phase 16 drives both at B = 8), through
    the route's wrapper (`nussbaumer.pointwise_dot`, 16 launches a call)
    against the plain dot point by point; the library call is a float64
    torch.bmm over the 16 points wrapped to int32 (exact: K 2^30 < 2^53).
    Full-range operands with the extremes planted (the route's own are below
    2^11 in magnitude). Returns the (B, K, M) shapes held, for the check that
    phase 16 launched no other."""
    from rs_tfhe_tpu_torch import params as P
    from rs_tfhe_tpu_torch.ops import cuda_probes as CP
    from rs_tfhe_tpu_torch.ops import nussbaumer as NU

    g = torch.Generator(device=dev).manual_seed(SEED + 80)
    cases, shapes = [], set()
    for p, batch in ((P.SECURITY_128_BIT_FAST, 1), (P.SECURITY_128_BIT_FAST, 8), (P.SECURITY_128_BIT, 8)):
        m = p.n1 // NU.R
        pts, k, n = 2 * NU.R, 2 * p.trgsw_lv1.l * m, 8 * m
        lhs = torch.randint(-(1 << 15), 1 << 15, (pts, batch, k), generator=g, dtype=torch.int16, device=dev)
        bop = torch.randint(-(1 << 15), 1 << 15, (pts, k, n), generator=g, dtype=torch.int16, device=dev)
        lhs[:, 0, :3] = torch.tensor([-(1 << 15), (1 << 15) - 1, -1], dtype=torch.int16)
        bop[:, :3, -1] = torch.tensor([-(1 << 15), (1 << 15) - 1, -1], dtype=torch.int16)

        def kernel():
            return NU.pointwise_dot(lhs, bop)

        def plain():
            return torch.stack([CP.dot_plain(lhs[t], bop[t]) for t in range(pts)])

        def library():
            return torch.bmm(lhs.to(torch.float64), bop.to(torch.float64)).to(torch.int64).to(torch.int32)

        before = counters()
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        moved = counts_since(before)
        check(moved.get(f"probes.launches.{NU.DOT_NAME}", 0) == pts, f"the pointwise dot launched {pts} times a call")
        shapes.update(by_instance(moved, "nussbaumer.shape"))
        err = max_abs_err(out, ref)
        k_ms, p_ms, lib_ms = cuda_ms(kernel, 10), cuda_ms(plain, 10), cuda_ms(library, 10)
        nbytes = 2 * (lhs.numel() + bop.numel()) + 4 * out.numel()
        bnd = bound(nbytes, pts * batch * k * n, len(CP.limb_pairs(2)))
        case = f"int16 [{batch},{k}]x[{k},{n}] x {pts} points ({_name(p)} Nussbaumer step)"
        print(f"[3e] {NU.DOT_NAME} {case} on the {CP.dot_unit(torch.int16)}: equal={torch.equal(out, ref)} "
              f"max_abs_err={err} kernel {k_ms:.4f} ms ({k_ms / pts:.4f} ms a point), plain {p_ms:.4f} ms, "
              f"float64 torch.bmm {lib_ms:.4f} ms, {show_bound(bnd)}")
        check(torch.equal(out, ref), f"the Nussbaumer pointwise dot == plain at {case}")
        cases.append({**case_row(case, k_ms, p_ms, bnd), "library_ms": lib_ms, "max_abs_err": err})
    print(f"[3e] Nussbaumer dot done {elapsed()}")
    main = cases[1]
    return {**{k_: v for k_, v in main.items() if k_ != "case"}, "case": main["case"],
            "max_abs_err": max(c["max_abs_err"] for c in cases), "cases": cases, "shapes_compared": tile_list(shapes)}


def run_probe_scripts(dev) -> dict:
    """The probes' own path: the two probe scripts, as a user runs them."""
    ok = _load_script("probe_hopper").main(dev)
    check(ok, "every capability probe passed")
    rates = _load_script("bench_hopper_prims").main(dev)
    print(f"[10] done {elapsed()}")
    return rates


def run_circuits(p, dev, label: str, multibit: bool) -> dict:
    """Boolean circuits at full width: the 32-bit ripple-carry adder through
    the netlist evaluator and its compiled form, a batch of Kogge-Stone
    additions and a batch of carry-save multiplications."""
    from rs_tfhe_tpu_torch import bit_utils
    from rs_tfhe_tpu_torch.models import circuits, netlist

    kind = "multi-bit" if multibit else "standard"
    sk, ck, g, _ = _keygen(p, dev, SEED + 80, multibit=multibit)
    alpha = p.tlwe_lv0.alpha
    rng = np.random.default_rng(SEED + 81)
    x, y = (int(v) for v in rng.integers(0, 1 << 32, 2))
    ckt, _, _, sums = netlist.ripple_carry_adder(32)
    plan = netlist.plan(ckt)
    boot = [(end - start) for start, end, op, _ in plan.groups if op not in ("not", "copy")]
    inputs = torch.cat([bit_utils.encrypt_uint(g, sk.lv0, x, 32, alpha), bit_utils.encrypt_uint(g, sk.lv0, y, 32, alpha)])
    check(inputs.is_cuda, f"{label}: encrypt_uint made its ciphertexts on the card")

    t0 = time.perf_counter()
    wires = netlist.evaluate(ckt, inputs, ck)
    got = bit_utils.decrypt_uint(wires[sums], sk.lv0)
    eval_s = time.perf_counter() - t0
    check(got == (x + y) % (1 << 32), f"{label}: evaluate(ripple_carry_adder(32)) decrypts to (x + y) mod 2^32")
    run = netlist.compile_circuit(ckt, plan)
    t0 = time.perf_counter()
    wires2 = run(inputs, ck)
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    check(torch.equal(wires2, wires), f"{label}: compile_circuit's run equals evaluate bit for bit")
    check(bit_utils.decrypt_uint(wires2[sums], sk.lv0) == (x + y) % (1 << 32),
          f"{label}: the compiled adder decrypts to (x + y) mod 2^32")
    print(f"[{label}] {_name(p)} {kind} key, ripple_carry_adder(32): {len(ckt.gates)} gates in {len(plan.groups)} "
          f"plan groups ({len(boot)} bootstrapped, {sum(boot)} gates, largest {max(boot)}); {x} + {y} correct; "
          f"evaluate {eval_s:.3f} s, compiled run {run_s:.3f} s (enqueued in {enqueue_s:.3f} s), "
          f"{sum(boot) / run_s:.1f} gates/s through the plan {elapsed()}")
    out = {"adder32_groups": len(plan.groups), "adder32_bootstrapped_groups": len(boot),
           "adder32_bootstrapped_gates": sum(boot), "adder32_evaluate_s": eval_s, "adder32_compiled_s": run_s,
           "adder32_compiled_enqueue_s": enqueue_s, "adder32_gates_per_s": sum(boot) / run_s}

    def enc_batch(vals, width):
        return torch.stack([bit_utils.encrypt_uint(g, sk.lv0, int(v), width, alpha) for v in vals])

    ks_batch = 16 if multibit else 4
    xs, ys = rng.integers(0, 1 << 32, ks_batch), rng.integers(0, 1 << 32, ks_batch)
    a, b = enc_batch(xs, 32), enc_batch(ys, 32)
    t0 = time.perf_counter()
    total = circuits.add_kogge_stone(a, b, ck)
    torch.cuda.synchronize()
    ks_s = time.perf_counter() - t0
    got = [bit_utils.decrypt_uint(row, sk.lv0) for row in total]
    check(got == [int(v) for v in (xs + ys) % (1 << 32)], f"{label}: every Kogge-Stone sum of the batch is right")
    mul_batch = 2
    xs8, ys8 = rng.integers(0, 256, mul_batch), rng.integers(0, 256, mul_batch)
    a8, b8 = enc_batch(xs8, 8), enc_batch(ys8, 8)
    t0 = time.perf_counter()
    prod = circuits.mul_csa(a8, b8, ck)
    torch.cuda.synchronize()
    mul_s = time.perf_counter() - t0
    got = [bit_utils.decrypt_uint(row, sk.lv0) for row in prod]
    check(got == [int(v) for v in (xs8 * ys8) % 256], f"{label}: every carry-save product of the batch is right")
    print(f"[{label}] add_kogge_stone on {ks_batch} pairs of 32 bits: all correct, {ks_s:.3f} s "
          f"({ks_s / ks_batch * 1e3:.1f} ms per addition); mul_csa on {mul_batch} pairs of 8 bits: all correct, "
          f"{mul_s:.3f} s {elapsed()}")
    out.update({"kogge_stone_add32_batch": ks_batch, "kogge_stone_add32_s": ks_s,
                "mul_csa8_batch": mul_batch, "mul_csa8_s": mul_s})
    return out


def run_multi_value(p, dev, label: str) -> dict:
    """Two LUTs from one rotation on B = 2048 messages, against the
    dedicated bootstrap of each LUT."""
    from rs_tfhe_tpu_torch import lut
    from rs_tfhe_tpu_torch.bootstrap import bootstrap_with_testvec
    from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_message, lwe_encrypt_message

    modulus, batch = 8, 2048
    fs = (lambda v: (v + 1) % modulus, lambda v: (3 * v) % modulus)
    sk, ck, g, _ = _keygen(p, dev, SEED + 90, multibit=True)
    msgs = np.random.default_rng(SEED + 91).integers(0, modulus, batch)
    ct = lwe_encrypt_message(g, sk.lv0, msgs, modulus, p.tlwe_lv0.alpha)
    gen = lut.Generator(modulus, p)
    polys = [gen.generate_lookup_table(f).poly.to(dev) for f in fs]
    mv = lut.factor_test_vectors(polys)
    check(mv.tv0.is_cuda, f"{label}: the factored accumulator lies on the card")
    out, mv_ms = timed(lambda: lut.multi_value_bootstrap(ct, mv, ck))
    check(tuple(out.shape) == (batch, len(fs), p.n0 + 1), f"{label}: output shape [B, K, n0+1]")
    dedicated_ms = 0.0
    for k, f in enumerate(fs):
        got = lwe_decrypt_message(out[:, k], sk.lv0, modulus)
        ded, ms = timed(lambda k=k: bootstrap_with_testvec(ct, polys[k], ck))
        dedicated_ms += ms
        want = lwe_decrypt_message(ded, sk.lv0, modulus)
        check(bool((want == f(msgs)).all()), f"{label}: the dedicated bootstrap of LUT {k} is right")
        check(bool((got == want).all()), f"{label}: multi-value output {k} decrypts as the dedicated bootstrap")
    print(f"[{label}] {_name(p)} multi_value_bootstrap B={batch}, {len(fs)} LUTs (norms {[round(x, 2) for x in mv.norms]}): "
          f"every output decrypts as its dedicated bootstrap; {mv_ms:.1f} ms (one rotation with the standard key) "
          f"against {dedicated_ms:.1f} ms for the {len(fs)} dedicated bootstraps (multi-bit key, above the cap: "
          f"the whole-rotation kernel) {elapsed()}")
    return {"multi_value_ms_b2048": mv_ms, "dedicated_ms_b2048": dedicated_ms, "n_luts": len(fs)}


def _kernel_share(fn) -> dict:
    """Device time of one fn() call: the rotation kernels (names with
    blind_rotate), the key switch's kernels (csrc/key_switch.cu, or the
    product route's int8 gemm kernels) and the rest, ms."""
    share = {"rotation_ms": 0.0, "key_switch_ms": 0.0, "other_ms": 0.0}
    for name, ms in _device_times(fn):
        name = name.lower()
        slot = ("rotation_ms" if "blind_rotate" in name else
                "key_switch_ms" if any(k in name for k in ("key_switch", "gemm", "xmma", "cutlass", "int_mm")) else "other_ms")
        share[slot] += ms
    share["device_ms"] = sum(share.values())
    share["rotation_share"] = share["rotation_ms"] / share["device_ms"] if share["device_ms"] else 0.0
    return {k: round(v, 4) for k, v in share.items()}


def _radix_op(label: str, name: str, fn, ok, results: dict, repeats: int = 2, profile: bool = False):
    """Run one radix operation `repeats` times, host clock to the synchronise
    each; check its result with ok(out); record the times, the launches of
    both rotation kernels in the first run and, with `profile`, the device
    time by kernel of one more run."""
    times, launches = [], None
    for _ in range(repeats):
        before = rotation_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        now = rotation_launches()
        launches = launches or {"K1": now[0] - before[0], "K4": now[1] - before[1]}
        check(bool(ok(out)), f"{label}: {name} decrypts to the numpy answer")
    row = {"ms": times, **launches}
    if profile:
        row["by_kernel"] = _kernel_share(fn)
    results[name] = row
    print(f"[{label}] {name}: correct; {' / '.join(f'{t:.1f}' for t in times)} ms (host clock, "
          f"{'cold / warm' if repeats > 1 else 'one run'}); launches K1 {launches['K1']}, K4 {launches['K4']}"
          + (f"; by kernel {json.dumps(row['by_kernel'])}" if profile else ""))
    return out


def run_radix(p, dev, label: str) -> dict:
    """Radix arithmetic at full width with a multi-bit key (the JAX bench's
    radix cases), every result decrypted against numpy."""
    from rs_tfhe_tpu_torch import fhe
    from rs_tfhe_tpu_torch.models import arithmetic as A
    from rs_tfhe_tpu_torch.models.sort import sort_radix
    from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_bool, lwe_encrypt_bool

    sk, ck, g, keygen_ms = _keygen(p, dev, SEED + 130, multibit=True)
    rng = np.random.default_rng(SEED + 131)
    results = {"keygen_mb_ms": keygen_ms}

    def enc(vals, d, bb):
        return A.encrypt_radix(g, sk.lv0, vals, d, p, bb)

    def dec(ct, bb):
        return A.decrypt_radix(ct, sk.lv0, bb)

    def bits_of(ct):
        return lwe_decrypt_bool(ct, sk.lv0).cpu().numpy()

    x8, y8 = rng.integers(0, 256, 64), rng.integers(0, 256, 64)
    a, b = enc(x8, 2, 4), enc(y8, 2, 4)
    _radix_op(label, "add_radix base 16 D=2 B=64", lambda: A.add_radix(a, b, ck, 4),
              lambda o: (dec(o, 4) == (x8 + y8) % 256).all(), results, profile=True)
    x, y = rng.integers(0, 512, 64), rng.integers(0, 512, 64)
    y[:8] = x[:8]  # equal pairs for the comparator
    a, b = enc(x, 3, 3), enc(y, 3, 3)
    for mv in (False, True):
        _radix_op(label, f"add_radix base 8 D=3 B=64{' multi_value' if mv else ''}",
                  lambda mv=mv: A.add_radix(a, b, ck, 3, multi_value=mv),
                  lambda o: (dec(o, 3) == (x + y) % 512).all(), results)
    _radix_op(label, "sub_radix D=3 B=64", lambda: A.sub_radix(a, b, ck, 3),
              lambda o: (dec(o, 3) == (x - y) % 512).all(), results)
    _radix_op(label, "compare_radix D=3 B=64", lambda: A.compare_radix(a, b, ck, 3),
              lambda o: all((bits_of(c) == want).all() for c, want in zip(o, (x == y, x > y, x < y))), results)
    _radix_op(label, "min_radix D=3 B=64", lambda: A.min_radix(a, b, ck, 3),
              lambda o: (dec(o, 3) == np.minimum(x, y)).all(), results)
    sels = rng.integers(0, 2, 64).astype(bool)
    sel = lwe_encrypt_bool(g, sk.lv0, sels, p.tlwe_lv0.alpha)
    _radix_op(label, "select_radix D=3 B=64", lambda: A.select_radix(sel, a, b, ck, 3),
              lambda o: (dec(o, 3) == np.where(sels, x, y)).all(), results)
    a16 = a[:16]
    bits = _radix_op(label, "radix_to_bits D=3 B=16", lambda: A.radix_to_bits(a16, ck, 3),
                     lambda o: (bits_of(o) == ((x[:16, None] >> np.arange(9)) & 1)).all(), results)
    _radix_op(label, "bits_to_radix W=9 B=16", lambda: A.bits_to_radix(bits, ck, 3),
              lambda o: (dec(o, 3) == x[:16]).all(), results)
    vals = rng.integers(0, 64, 8)
    srt = enc(vals, 2, 3)
    _radix_op(label, "sort_radix K=8 D=2 (base 8)", lambda: sort_radix(srt, ck, 3),
              lambda o: (dec(o, 3) == np.sort(vals)).all(), results, profile=True)
    before = rotation_launches()
    _radix_op(label, "add_radix base 8 D=3 B=1", lambda: A.add_radix(a[:1], b[:1], ck, 3),
              lambda o: (dec(o, 3) == (x[:1] + y[:1]) % 512).all(), results)
    check_route(before, False, True, f"{label}: add_radix at B=1 takes the multi-bit kernel only")
    # base 2 digits: the product's column LUTs (modulus 2 base^2) keep wide
    # margins at N = 2048, where base 4 and 8 do not (mul_radix's docstring)
    x4, y4 = x[:16] % 16, y[:16] % 16
    xr = fhe.FheUintRadix.encrypt(g, sk.lv0, x4, 4, ck, base_bits=1)
    yr = fhe.FheUintRadix.encrypt(g, sk.lv0, y4, 4, ck, base_bits=1)
    _radix_op(label, "FheUintRadix + 4 bits B=16", lambda: xr + yr,
              lambda o: (o.decrypt(sk.lv0) == (x4 + y4) % 16).all(), results)
    _radix_op(label, "FheUintRadix * 4 bits B=16", lambda: xr * yr,
              lambda o: (o.decrypt(sk.lv0) == x4 * y4).all(), results, profile=True)
    _radix_op(label, "FheUintRadix < 4 bits B=16", lambda: xr < yr,
              lambda o: (o.decrypt(sk.lv0) == (x4 < y4)).all(), results)
    print(f"[{label}] done {elapsed()}")
    return results


def run_nibble_mul(dev, label: str) -> dict:
    """mul_radix 8 x 8 bits at NIBBLE with a standard key, both ways, then
    FheUint(8) at FAST through the typed API."""
    from rs_tfhe_tpu_torch import fhe
    from rs_tfhe_tpu_torch import params as P
    from rs_tfhe_tpu_torch.models import arithmetic as A

    p = P.SECURITY_128_BIT_NIBBLE
    sk, ck, g, keygen_ms = _keygen(p, dev, SEED + 140)
    rng = np.random.default_rng(SEED + 141)
    results = {"keygen_ms": keygen_ms}
    x, y = rng.integers(0, 256, 16), rng.integers(0, 256, 16)
    x[0], y[0] = 255, 255
    a, b = A.encrypt_radix(g, sk.lv0, x, 4, p, 2), A.encrypt_radix(g, sk.lv0, y, 4, p, 2)
    for mv in (False, True):
        _radix_op(label, f"mul_radix 8x8 base 4 D=4 B=16{' multi_value' if mv else ''}",
                  lambda mv=mv: A.mul_radix(a, b, ck, 2, multi_value=mv),
                  lambda o: (A.decrypt_radix(o, sk.lv0, 2) == x * y).all(), results, repeats=1, profile=mv)
    fast = P.SECURITY_128_BIT_FAST
    sk_f, ck_f, g_f, _ = _keygen(fast, dev, SEED + 142)
    u = fhe.FheUint.encrypt(g_f, sk_f.lv0, x, 8, ck_f)
    v = fhe.FheUint.encrypt(g_f, sk_f.lv0, y, 8, ck_f)
    _radix_op(label, "FheUint(8) + B=16 (FAST)", lambda: u + v,
              lambda o: (o.decrypt(sk_f.lv0) == (x + y) % 256).all(), results)
    lt = _radix_op(label, "FheUint(8) < B=16 (FAST)", lambda: u < v,
                   lambda o: (o.decrypt(sk_f.lv0) == (x < y)).all(), results)
    _radix_op(label, "FheBool.select FheUint(8) B=16 (FAST)", lambda: lt.select(u, v),
              lambda o: (o.decrypt(sk_f.lv0) == np.where(x < y, x, y)).all(), results)
    print(f"[{label}] done {elapsed()}")
    return results


def _host_ms(fn):
    """(fn(), host-clock ms from the call to the synchronise after it)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def run_deployment(p, dev, label: str, smi: str) -> dict:
    """The deployment round trip at full width: keygen with gen_seed, key
    files full and seeded (saved, loaded onto the card, held equal bit for
    bit), the threefry rate, the native client's seeded encryption expanded
    on the card and gated on the loaded keys (K1 at B = 4096 with the
    standard key, K4 at B = 1 with the seeded multi-bit key), proxy
    re-encryption both ways at B = 4096, and utils.profiling. Every time is
    host clock to the synchronise, warm unless it says cold."""
    import tempfile

    from rs_tfhe_tpu_torch import gates, native
    from rs_tfhe_tpu_torch import proxy_reenc as PR
    from rs_tfhe_tpu_torch.key import CloudKey, SecretKey
    from rs_tfhe_tpu_torch.tlwe import lwe_expand_seeded
    from rs_tfhe_tpu_torch.torus import key_data, split, threefry2x32_bits, to_numpy, to_torch
    from rs_tfhe_tpu_torch.utils import noise, profiling
    from rs_tfhe_tpu_torch.utils import serialization as S

    card = f"({smi})"
    res = {}
    _, build_ms = _host_ms(native.load)  # raises if g++ fails: no fallback
    print(f"[{label}] native client built and loaded: {build_ms:.0f} ms, {os.path.relpath(native.library_path(), ROOT)}")

    # 1. keygen: masks from gen_seed's threefry streams, noise from the generator
    g = torch.Generator(device=dev).manual_seed(SEED + 150)
    sk = SecretKey.generate(p, g)
    _, cold_ms = _host_ms(lambda: CloudKey.generate(sk, g))
    ck, warm_ms = _host_ms(lambda: CloudKey.generate(sk, g))
    ck_mb, mb_ms = _host_ms(lambda: CloudKey.generate(sk, g, multibit=True))
    check(ck.gen_seed is not None and ck_mb.gen_seed is not None, f"{label}: generated keys carry gen_seed")
    res["keygen_ms"] = {"cold": cold_ms, "warm": warm_ms, "multibit_warm": mb_ms}
    print(f"[{label}] {_name(p)} cloud keygen with gen_seed: cold {cold_ms:.1f} ms, warm {warm_ms:.1f} ms, "
          f"multi-bit {mb_ms:.1f} ms {card}")

    # 2. key files, full and seeded, loaded back onto the card
    loaded, files = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for kind, key in (("standard", ck), ("multibit", ck_mb)):
            for seeded in (False, True):
                name = f"{kind}_{'seeded' if seeded else 'full'}"
                path = os.path.join(tmp, f"{name}.npz")
                _, save_ms = _host_ms(lambda: S.save_cloud_key(path, key, seeded=seeded))
                back, load_ms = _host_ms(lambda: S.load_cloud_key(path, dev))
                for buf in ("testvec", "bsk", "ksk_limbs", "bsk_mb"):
                    a, b = getattr(back, buf), getattr(key, buf)
                    check((a is None) == (b is None) and (a is None or (a.device == dev and torch.equal(a, b))),
                          f"{label}: {name}: {buf} loaded onto the card equals the key's bit for bit")
                check(torch.equal(back.gen_seed, key.gen_seed) if seeded else back.gen_seed is None,
                      f"{label}: {name}: gen_seed")
                loaded[name] = back
                files[name] = {"bytes": os.path.getsize(path), "save_ms": save_ms, "load_ms": load_ms}
                print(f"[{label}] {name}: {files[name]['bytes']:,} bytes, save {save_ms:.0f} ms, load onto the card "
                      f"{load_ms:.1f} ms, every buffer equal {card}")
    for kind in ("standard", "multibit"):
        ratio = files[f"{kind}_full"]["bytes"] / files[f"{kind}_seeded"]["bytes"]
        files[f"{kind}_full_over_seeded"] = ratio
        print(f"[{label}] {kind}: the full file is {ratio:.2f}x the seeded one")
        check(ratio > 2, f"{label}: the seeded {kind} file is less than half the full one")
    res["files"] = files

    # 3. the threefry stream at the key-switching key's size
    g1 = p.trgsw_lv1
    words = p.n1 * g1.iks_t * p.ks_base * p.n0
    mask_key = split(key_data(SEED + 151))[0]
    stream_ms = cuda_ms(lambda: threefry2x32_bits(mask_key, 0, words, dev), reps=5)
    res["threefry"] = {"words": words, "ms": stream_ms, "words_per_s": words / stream_ms * 1e3,
                       "bound_ms": 4 * words / PEAK_BYTES * 1e3}
    print(f"[{label}] threefry stream, {words:,} words (the KSK's masks): {stream_ms:.3f} ms (CUDA events), "
          f"{words / stream_ms * 1e3:.3e} words/s; bound {res['threefry']['bound_ms']:.3f} ms by bytes {card}")

    # 4. the native client encrypts seeded; the server expands and gates on the loaded keys
    batch = 4096
    rng = np.random.default_rng(SEED + 152)
    bits_a, bits_b = (rng.integers(0, 2, batch).astype(bool) for _ in range(2))
    s_host = to_numpy(sk.lv0)

    def mu(bits):
        return np.where(bits, np.uint32(1 << 29), np.uint32((1 << 32) - (1 << 29)))

    seed_a, seed_b = (to_numpy(k) for k in split(key_data(SEED + 153), 2))
    t0 = time.perf_counter()
    bodies_a = native.lwe_encrypt_seeded(seed_a, SEED + 154, s_host, mu(bits_a), p.tlwe_lv0.alpha)
    bodies_b = native.lwe_encrypt_seeded(seed_b, SEED + 155, s_host, mu(bits_b), p.tlwe_lv0.alpha)
    client_ms = (time.perf_counter() - t0) * 1e3
    (a, b), expand_ms = _host_ms(lambda: (lwe_expand_seeded(seed_a, to_torch(bodies_a, dev), p.n0),
                                          lwe_expand_seeded(seed_b, to_torch(bodies_b, dev), p.n0)))
    check(np.array_equal(to_numpy(a), native.lwe_expand_seeded(seed_a, bodies_a, p.n0)),
          f"{label}: the card expands the seeded batch as the native client does")
    server = loaded["standard_seeded"]
    gates.batch_gate("nand", a, b, server)
    before = rotation_launches()
    out, nand_ms = _host_ms(lambda: gates.batch_gate("nand", a, b, server))
    check_route(before, True, False, f"{label}: NAND B={batch} on the loaded standard key takes the whole-rotation kernel")
    correct = float((native.lwe_decrypt_bool(to_numpy(out), s_host) == ~(bits_a & bits_b)).mean())
    check(correct == 1.0, f"{label}: the native client decrypts every NAND of the B={batch} batch correctly")
    mb_server = loaded["multibit_seeded"]
    gates.nand(a[:1], b[:1], mb_server)
    before = rotation_launches()
    out1, nand1_ms = _host_ms(lambda: gates.nand(a[:1], b[:1], mb_server))
    check_route(before, False, True, f"{label}: NAND B=1 on the loaded seeded multi-bit key takes the multi-bit kernel")
    check(bool(native.lwe_decrypt_bool(to_numpy(out1), s_host)[0]) == (not (bits_a[0] and bits_b[0])),
          f"{label}: the native client decrypts the B=1 multi-bit NAND correctly")
    res["client_server"] = {"client_encrypt_ms": client_ms, "expand_ms": expand_ms, "nand_b4096_ms": nand_ms,
                            "correctness": correct, "nand_b1_mb_ms": nand1_ms,
                            "wire_bytes": 2 * (4 * batch + 8), "full_bytes": 2 * 4 * batch * (p.n0 + 1)}
    print(f"[{label}] native client: seeded encryption of {batch} bit pairs {client_ms:.1f} ms (host), "
          f"{res['client_server']['wire_bytes']:,} bytes on the wire against {res['client_server']['full_bytes']:,} "
          f"full; expand on the card {expand_ms:.2f} ms; NAND B={batch} on the seeded-loaded key {nand_ms:.1f} ms, "
          f"correctness {correct:.6f}; NAND B=1 on the seeded multi-bit key {nand1_ms:.2f} ms {card}")

    # 5. proxy re-encryption Alice -> Bob at B = 4096, both ways of making the key. An asymmetric
    # re-key with FAST's own decomposition (basebit 2, t = 9: 4,725 selected rows, each a +/-1 sum of
    # about 700 of Bob's 1,400 public encryptions) leaves phase noise of std 0.030-0.034 and a per-key
    # offset up to 0.03 against the margin 1/8, in the JAX package as here: it fails about one
    # ciphertext in 10^3-10^4 (scripts/proxy_reenc_noise.py), so its rate is reported and its noise held
    # to the reference's range; the asymmetric key that must decrypt every ciphertext uses basebit 6,
    # t = 3 (the same 18 bits, 2,100 rows selected of 134,400).
    bob = SecretKey.generate(p, g)
    bob_host = to_numpy(bob.lv0)
    PR.new_symmetric(g, sk.lv0, bob.lv0, p)
    rk_sym, sym_ms = _host_ms(lambda: PR.new_symmetric(g, sk.lv0, bob.lv0, p))
    pk_bob, pk_ms = _host_ms(lambda: PR.PublicKeyLv0.generate(g, bob.lv0, p))
    PR.new_asymmetric(g, sk.lv0, pk_bob, p)
    rk_asym, asym_ms = _host_ms(lambda: PR.new_asymmetric(g, sk.lv0, pk_bob, p))
    rk_asym_63, asym63_ms = _host_ms(lambda: PR.new_asymmetric(g, sk.lv0, pk_bob, p, basebit=6, t=3))
    proxy = {"new_symmetric_ms": sym_ms, "public_key_ms": pk_ms, "new_asymmetric_ms": asym_ms,
             "new_asymmetric_basebit6_t3_ms": asym63_ms}
    for mode, rk, must in (("symmetric", rk_sym, True), ("asymmetric", rk_asym, False),
                           ("asymmetric basebit 6 t 3", rk_asym_63, True)):
        PR.reencrypt(a, rk)
        re, re_ms = _host_ms(lambda: PR.reencrypt(a, rk))
        rate = float((native.lwe_decrypt_bool(to_numpy(re), bob_host) == bits_a).mean())
        err = noise.measure_phase_noise(re, bob.lv0, mu(bits_a))
        proxy[mode] = {"reencrypt_ms": re_ms, "correctness": rate, "noise_mean": float(err.mean()),
                       "noise_std": float(err.std()), "max_abs_noise": float(np.abs(err).max())}
        print(f"[{label}] proxy {mode}: reencrypt B={batch} {re_ms:.2f} ms; Bob decrypts {rate:.6f} correct; "
              f"phase noise mean {err.mean():+.5f}, std {err.std():.5f}, max |noise| {np.abs(err).max():.4f}; "
              f"(1/8 - |mean|) / std = {(0.125 - abs(err.mean())) / err.std():.2f} {card}")
        if must:
            check(rate == 1.0, f"{label}: Bob decrypts every ciphertext re-encrypted {mode} correctly")
        else:
            check(0.025 <= err.std() <= 0.040, f"{label}: the {mode} re-encryption noise std is the JAX "
                                               f"package's (0.0295-0.0335 at FAST, scripts/proxy_reenc_noise.py)")
    print(f"[{label}] proxy keys: new_symmetric {sym_ms:.1f} ms, PublicKeyLv0.generate {pk_ms:.1f} ms, "
          f"new_asymmetric {asym_ms:.1f} ms (basebit 6, t 3: {asym63_ms:.1f} ms) {card}")
    res["proxy"] = proxy

    # 6. utils.profiling on the same path
    timer = profiling.Timer()
    for _ in range(3):
        with timer.span(f"reencrypt B={batch}", sync_on=a):
            PR.reencrypt(a, rk_sym)
        with timer.span(f"expand B={batch}", sync_on=a):
            lwe_expand_seeded(seed_a, to_torch(bodies_a, dev), p.n0)
    rate = profiling.gate_throughput(gates.nand, a, b, server, iters=3)
    res["profiling"] = {"spans_ms": {k: [t * 1e3 for t in v] for k, v in timer.spans.items()}, "nand_gates_per_s": rate}
    print(f"[{label}] utils.profiling.Timer:\n" + "\n".join(f"[{label}]   {line}" for line in timer.report().splitlines()))
    print(f"[{label}] utils.profiling.gate_throughput: {rate:.1f} NAND gates/s at B={batch} on the seeded-loaded "
          f"key {card} {elapsed()}")
    return res


def run_parallel(dev, label: str, smi: str) -> dict:
    """The multi-device paths at full width (SECURITY_128_BIT_FAST unless
    marked) on a virtual mesh of the card, and over distinct cards where
    there are two or more: data-parallel NAND B = 4096 on four shards against
    the single-device batch (the whole-rotation kernel in every shard), the
    multi-bit key's data-parallel NAND B = 8 (2-row shards, each on the
    multi-bit kernel), data-parallel MUX B = 1024; tensor-parallel NAND B = 1
    and 8 at tp = 2 (the step kernel at J = 2, n0 launches a shard), B = 8 at
    tp = 4 (J = 1) and at strict tp = 2 (J = 3), and the tensor-parallel LUT
    B = 8, each against its single-device output; NAND B = 8 under
    step_impl="nussbaumer" at FAST and strict against the default route (P1's
    s16 unit, 2r launches a step); the dry run on four shards. Times are host
    clock to the synchronise, warm."""
    from rs_tfhe_tpu_torch import config, gates, parallel
    from rs_tfhe_tpu_torch import params as P
    from rs_tfhe_tpu_torch.bootstrap import LutBootstrap
    from rs_tfhe_tpu_torch.key import CloudKey
    from rs_tfhe_tpu_torch.ops import nussbaumer as NU
    from rs_tfhe_tpu_torch.parallel.dryrun import dryrun_multichip
    from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_bool, lwe_decrypt_message, lwe_encrypt_bool, lwe_encrypt_message

    card = f"({smi})"
    fast, strict = P.SECURITY_128_BIT_FAST, P.SECURITY_128_BIT
    res = {}
    sk, ck_mb, g, keygen_ms = _keygen(fast, dev, SEED + 160, multibit=True)
    ck = CloudKey(ck_mb.testvec, ck_mb.bsk, ck_mb.ksk_limbs, fast)  # the standard key: the same bsk and ksk
    sk_s, ck_s, g_s, _ = _keygen(strict, dev, SEED + 161)
    rng = np.random.default_rng(SEED + 162)

    def enc(p, sk_, g_, n):
        bits = rng.integers(0, 2, n).astype(bool)
        return bits, lwe_encrypt_bool(g_, sk_.lv0, bits, p.tlwe_lv0.alpha)

    def correct(out, sk_, truth):
        return float((lwe_decrypt_bool(out, sk_.lv0).cpu().numpy() == truth).mean())

    def best_ms(fn, reps=2):
        """(fn(), the least host-clock ms of `reps` warm calls)."""
        fn()
        outs = [_host_ms(fn) for _ in range(reps)]
        return outs[-1][0], min(ms for _, ms in outs)

    virtual4 = parallel.make_mesh(4, devices=[dev] * 4)
    print(f"[{label}] keys on the card: FAST multi-bit (its bsk and ksk also the standard key) and strict; "
          f"FAST keygen {keygen_ms:.1f} ms {card}")

    # data parallel: NAND B = 4096 on four shards (B = 1024 each) against one batch
    bits_a, a = enc(fast, sk, g, 4096)
    bits_b, b = enc(fast, sk, g, 4096)
    single, single_ms = best_ms(lambda: gates.batch_gate("nand", a, b, ck))
    launches = rotation_launches()[0]
    dp, dp_ms = best_ms(lambda: parallel.data_parallel_gate("nand", a, b, ck, virtual4))
    check(rotation_launches()[0] - launches == 3 * 4, f"{label}: each data-parallel call launched the whole-rotation "
                                                      f"kernel once a shard")
    check(torch.equal(dp, single), f"{label}: data-parallel NAND B=4096 equals the single-device batch bit for bit")
    check(correct(dp, sk, ~(bits_a & bits_b)) == 1.0, f"{label}: every data-parallel NAND decrypts correctly")
    res["dp_nand_b4096"] = {"gates_per_s": 4096 / dp_ms * 1e3, "single_gates_per_s": 4096 / single_ms * 1e3,
                            "ms": dp_ms, "single_ms": single_ms}
    print(f"[{label}] data-parallel NAND B=4096 on 4 shards of the card: {4096 / dp_ms * 1e3:.1f} gates/s "
          f"({dp_ms:.1f} ms), single device {4096 / single_ms * 1e3:.1f} gates/s ({single_ms:.1f} ms); "
          f"bit-equal, 100% correct {card}")

    # the multi-bit key at B = 8 on four shards: 2-row shards, each at the cap, on the multi-bit kernel
    before = rotation_launches()
    dp_mb, mb_ms = _host_ms(lambda: parallel.data_parallel_gate("nand", a[:8], b[:8], ck_mb, virtual4))
    now = rotation_launches()
    check(now[1] - before[1] == 4 and now[0] == before[0], f"{label}: the multi-bit key's 2-row shards each took "
                                                           f"the multi-bit kernel (launches {now[1] - before[1]})")
    check(all(t[2] > 1 for t in (now[2] - before[2])), f"{label}: the multi-bit kernel ran as a cluster")
    want = torch.cat([gates.nand(a[i:i + 2], b[i:i + 2], ck_mb) for i in range(0, 8, 2)])
    check(torch.equal(dp_mb, want), f"{label}: the multi-bit shards equal single-device NANDs of their 2 rows")
    check(correct(dp_mb, sk, ~(bits_a[:8] & bits_b[:8])) == 1.0, f"{label}: multi-bit DP NAND decrypts")
    res["dp_nand_mb_b8_ms"] = mb_ms
    print(f"[{label}] data-parallel NAND B=8, multi-bit key, 4 shards of 2 rows: multi-bit kernel launches 4, "
          f"whole-rotation 0; {mb_ms:.2f} ms; equal to the shards' single-device NANDs, 100% correct {card}")

    # MUX B = 1024 on four shards
    mux_single, mux_single_ms = best_ms(lambda: gates.mux(a[:1024], b[:1024], a[1024:2048], ck), reps=1)
    mux, mux_ms = best_ms(lambda: parallel.data_parallel_mux(a[:1024], b[:1024], a[1024:2048], ck, virtual4), reps=1)
    check(torch.equal(mux, mux_single), f"{label}: data-parallel MUX B=1024 equals the single-device MUX")
    check(correct(mux, sk, np.where(bits_a[:1024], bits_b[:1024], bits_a[1024:2048])) == 1.0,
          f"{label}: every data-parallel MUX decrypts correctly")
    res["dp_mux_b1024"] = {"mux_per_s": 1024 / mux_ms * 1e3, "single_mux_per_s": 1024 / mux_single_ms * 1e3}
    print(f"[{label}] data-parallel MUX B=1024 on 4 shards: {1024 / mux_ms * 1e3:.1f} MUX/s ({mux_ms:.1f} ms), "
          f"single device {1024 / mux_single_ms * 1e3:.1f} MUX/s ({mux_single_ms:.1f} ms); bit-equal, 100% correct "
          f"{card}")

    # tensor parallel on one card's virtual mesh: (1, tp)
    def tp_case(p, sk_, ck_, a_, b_, bits_a_, bits_b_, tp, what):
        mesh = parallel.make_mesh(tp, tp=tp, devices=[dev] * tp)
        ref = gates.nand(a_, b_, ck_)
        parallel.tensor_parallel_gate("nand", a_, b_, ck_, mesh)  # warm
        before = counters()
        out, ms = _host_ms(lambda: parallel.tensor_parallel_gate("nand", a_, b_, ck_, mesh))
        moved = counts_since(before)
        j = 2 * p.trgsw_lv1.l // tp
        check(moved.get("k5.launches", 0) == tp * p.n0, f"{label}: {what}: the step kernel launched n0 times a shard")
        check({key[-1] for key in by_instance(moved, "k5.instance")} == {j}, f"{label}: {what}: J = {j}")
        check(torch.equal(out, ref), f"{label}: {what} equals the single-device NAND bit for bit")
        check(correct(out, sk_, ~(bits_a_ & bits_b_)) == 1.0, f"{label}: {what} decrypts correctly")
        batch = a_.shape[0]
        print(f"[{label}] tensor-parallel NAND {_name(p)} B={batch} tp={tp} (J={j}, {tp * p.n0} step-kernel "
              f"launches): {ms:.1f} ms, {ms / batch:.2f} ms a gate; bit-equal to the single device, 100% correct "
              f"{card}")
        return {"ms": ms, "ms_per_gate": ms / batch, "j_rows": j, "step_launches": tp * p.n0}

    res["tp_nand_fast_b1_tp2"] = tp_case(fast, sk, ck, a[:1], b[:1], bits_a[:1], bits_b[:1], 2, "TP B=1 tp=2")
    res["tp_nand_fast_b8_tp2"] = tp_case(fast, sk, ck, a[:8], b[:8], bits_a[:8], bits_b[:8], 2, "TP B=8 tp=2")
    res["tp_nand_fast_b8_tp4"] = tp_case(fast, sk, ck, a[:8], b[:8], bits_a[:8], bits_b[:8], 4, "TP B=8 tp=4")
    sbits_a, sa = enc(strict, sk_s, g_s, 8)
    sbits_b, sb = enc(strict, sk_s, g_s, 8)
    res["tp_nand_strict_b8_tp2"] = tp_case(strict, sk_s, ck_s, sa, sb, sbits_a, sbits_b, 2, "strict TP B=8 tp=2")

    # the tensor-parallel LUT, (x + 1) mod 4 on B = 8
    msgs = np.arange(8) % 4
    m = lwe_encrypt_message(g, sk.lv0, msgs, 4, fast.tlwe_lv0.alpha)
    f = lambda x: (x + 1) % 4  # noqa: E731
    mesh2 = parallel.make_mesh(2, tp=2, devices=[dev] * 2)
    lut_ref = LutBootstrap().bootstrap_func(m, f, 4, ck)
    lut, lut_ms = _host_ms(lambda: parallel.tensor_parallel_lut_bootstrap(m, f, 4, ck, mesh2))
    check(torch.equal(lut, lut_ref), f"{label}: the tensor-parallel LUT equals the single-device LUT bootstrap")
    check(bool((lwe_decrypt_message(lut, sk.lv0, 4) == (msgs + 1) % 4).all()), f"{label}: the TP LUT decrypts")
    res["tp_lut_fast_b8_tp2_ms"] = lut_ms
    print(f"[{label}] tensor-parallel LUT (x+1) mod 4, FAST B=8 tp=2: {lut_ms:.1f} ms; bit-equal to "
          f"LutBootstrap, decrypts {card}")

    # step_impl="nussbaumer" against the default route
    for p, sk_, ck_, a_, b_, ba, bb in ((fast, sk, ck, a[:8], b[:8], bits_a[:8], bits_b[:8]),
                                        (strict, sk_s, ck_s, sa, sb, sbits_a, sbits_b)):
        default, default_ms = best_ms(lambda: gates.nand(a_, b_, ck_), reps=1)
        saved = config.config.step_impl
        config.config.step_impl = "nussbaumer"
        try:
            before = counters()
            out, ms = _host_ms(lambda: gates.nand(a_, b_, ck_))
            launched = counts_since(before).get(f"probes.launches.{NU.DOT_NAME}", 0)
        finally:
            config.config.step_impl = saved
        check(launched == 2 * NU.R * p.n0, f"{label}: the Nussbaumer route launched P1's s16 unit 2r times a step")
        check(torch.equal(out, default), f"{label}: step_impl='nussbaumer' equals the default route at {_name(p)}")
        check(correct(out, sk_, ~(ba & bb)) == 1.0, f"{label}: the Nussbaumer NAND decrypts correctly")
        res[f"nussbaumer_nand_{_name(p)}_b8"] = {"ms": ms, "ms_per_gate": ms / 8, "default_ms": default_ms,
                                                 "dot_launches": launched}
        print(f"[{label}] step_impl='nussbaumer' NAND {_name(p)} B=8: {ms:.1f} ms ({ms / 8:.1f} ms a gate, "
              f"{launched} launches of the s16 dot), default route {default_ms:.1f} ms; bit-equal, 100% correct "
              f"{card}")

    _, dry_ms = _host_ms(lambda: dryrun_multichip(4, [dev] * 4))
    print(f"[{label}] dryrun_multichip(4) on 4 shards of the card: OK, {dry_ms:.0f} ms")

    cards = torch.cuda.device_count()
    if cards >= 2:
        devs = [torch.device("cuda", i) for i in range(cards)]
        out, ms = best_ms(lambda: parallel.data_parallel_gate("nand", a, b, ck, parallel.make_mesh(devices=devs)))
        check(torch.equal(out, single), f"{label}: data-parallel NAND over {cards} cards equals the single device")
        out_tp, tp_ms = _host_ms(lambda: parallel.tensor_parallel_gate(
            "nand", a[:8], b[:8], ck, parallel.make_mesh(2, tp=2, devices=devs[:2])))
        check(torch.equal(out_tp, gates.nand(a[:8], b[:8], ck)), f"{label}: TP NAND over 2 cards equals the single device")
        res["cards"] = {"count": cards, "dp_gates_per_s": 4096 / ms * 1e3, "tp_b8_ms": tp_ms}
        print(f"[{label}] over {cards} cards: data-parallel NAND B=4096 {4096 / ms * 1e3:.1f} gates/s; "
              f"tensor-parallel NAND B=8 tp=2 {tp_ms:.1f} ms {card}")
    else:
        print(f"[{label}] one visible card: every multi-device path above ran on one card's virtual mesh "
              f"(the cross-card copies of reduce_sum and of the key, and the overlap of cards, are not measured) {card}")
    print(f"[{label}] done {elapsed()}")
    return res


EXAMPLES_DIR = os.path.join(ROOT, "examples", "torch")

#: Phase 17 runs each example of examples/torch/ once with its defaults (TEST_TINY, or the N=512 demo sets of
#: radix_integers and ciphertext_multiply), then these: each at the parameter set its JAX counterpart's
#: docstring names for a production run, with the flags of that line; lut_uint_parameters_demo at each of the
#: eight Uint sets its --params takes, keygen_speed at FAST too, and gates_with_strategies at the 80- and
#: 110-bit sets.
EXAMPLE_PRODUCTION_RUNS = [
    ("batch_gates.py", ["--params", "SECURITY_128_BIT"]),
    ("low_latency_gates.py", ["--params", "SECURITY_128_BIT"]),
    ("keygen_speed.py", ["--params", "SECURITY_128_BIT"]),
    ("keygen_speed.py", ["--params", "SECURITY_128_BIT_FAST"]),
    ("add_two_numbers.py", ["--params", "SECURITY_128_BIT", "--x", "4059", "--y", "27063"]),
    ("lut_bootstrapping.py", ["--params", "SECURITY_128_BIT"]),
    ("lut_add_two_numbers.py", ["--params", "SECURITY_128_BIT_NIBBLE", "--x", "137", "--y", "205"]),
    *[("lut_uint_parameters_demo.py", ["--params", f"SECURITY_UINT{k}"]) for k in range(1, 9)],
    ("encrypted_max.py", ["--params", "SECURITY_128_BIT"]),
    ("encrypted_sort.py", ["--params", "SECURITY_128_BIT_FAST"]),
    ("radix_integers.py", ["--params", "SECURITY_128_BIT_RADIX"]),
    ("ciphertext_multiply.py", ["--params", "SECURITY_128_BIT_NIBBLE", "--x", "40590", "--y", "27063",
                                "--bits", "16"]),
    ("typed_api.py", ["--params", "SECURITY_128_BIT_FAST"]),
    ("multi_chip_scaling.py", ["--params", "SECURITY_128_BIT_FAST", "--batch", "1024"]),
    ("gates_with_strategies.py", ["--params", "SECURITY_80_BIT"]),
    ("gates_with_strategies.py", ["--params", "SECURITY_110_BIT"]),
]

#: The line that ends each example's run when every assert of it held (its last result line).
EXAMPLE_DONE = {
    "security_levels.py": r"^ +-> Security level: 8 bits \(Uint8",
    "gates_with_strategies.py": r"^default: vanilla$",
    "batch_gates.py": r"^ +1024 ",
    "low_latency_gates.py": r"^\[speedup\] ",
    "keygen_speed.py": r"^full CloudKey: \d+ ms \(warm\)$",
    "lut_bootstrapping.py": r"^ threshold>2: f\(\[0\.\.\d\]\) = .*  OK$",
    "key_serialization.py": r"^reloaded keys evaluate correctly: OK$",
    "compressed_transport.py": r"^64 XOR \+ 64 AND evaluated on expanded ciphertexts: OK$",
    "proxy_reenc_with_bootstrap.py": r"^chain OK$",
}


def load_example(name: str):
    """A fresh module of examples/torch/<name> (its helper, _torch_common, found beside it)."""
    import importlib.util

    if EXAMPLES_DIR not in sys.path:
        sys.path.insert(0, EXAMPLES_DIR)
    spec = importlib.util.spec_from_file_location(f"_example_{name[:-3]}", os.path.join(EXAMPLES_DIR, name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_examples(label: str, smi: str) -> dict:
    """Every example of examples/torch/ at its defaults, then every run of
    EXAMPLE_PRODUCTION_RUNS, on the card and in this process (so that the
    kernels' launch counts see it): each example's main() with its argv and
    no --cpu, its output captured and then printed under the label. A run
    fails on any exception (an assert of the example, a kernel or build
    error), and where its last line is not the one EXAMPLE_DONE (else "OK")
    gives, which is also the case for an example that skipped."""
    import contextlib
    import io
    import re

    card = f"({smi})"
    names = sorted(f for f in os.listdir(EXAMPLES_DIR) if f.endswith(".py") and not f.startswith("_"))
    runs = [(name, []) for name in names] + EXAMPLE_PRODUCTION_RUNS
    res = {}
    for name, argv in runs:
        run = " ".join([name[:-3], *argv])
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                load_example(name).main(argv)
            torch.cuda.synchronize()
        finally:
            wall = time.perf_counter() - t0
            out = buf.getvalue()
            for line in out.splitlines():
                print(f"[{label} {run}] {line}")
        lines = out.splitlines()
        check("MISMATCH" not in out, f"example {run}: every LUT output decrypted to its function's value")
        done = EXAMPLE_DONE.get(name, r"^OK$")
        check(bool(lines) and re.search(done, lines[-1]) is not None,
              f"example {run} ended on its last result line ({done!r}), not {lines[-1:]}")
        print(f"[{label}] example {run}: {wall:.2f} s wall, keygen and warm-up included (host clock) {card}")
        res[run] = {"wall_s": wall}
    print(f"[{label}] {len(runs)} runs of the {len(names)} examples, {sum(r['wall_s'] for r in res.values()):.1f} s "
          f"{card} {elapsed()}")
    return res


SOAK_DIR = os.path.join(ROOT, "scripts", "torch")
#: Phase 18's short soak: the target of each phase of scripts/torch/soak.py (gates; adds at NIBBLE),
#: whole dispatches of 8 layers (32,768 gates at B = 4096, 16 at B = 2) or of 256 adds
SOAK_SMOKE_TARGETS = {"fast": 65_536, "strict": 32_768, "nibble": 256, "fast_mb": 2_000}


def run_soak(dev, label: str, smi: str) -> dict:
    """The reliability entry points (scripts/torch/soak.py and
    measure_mb_noise.py) in this process, so that the kernels' launch counts
    see them: each soak phase at SOAK_SMOKE_TARGETS, every output decrypted
    and spot-checked against the plain version on the card, then
    measure_mb_noise --quick (FAST, K = 256 NANDs at B = 2 with a multi-bit
    key, 128 with a standard key). Fails on an error, a mismatch, a phase
    without a spot check, or a multi-bit noise ratio outside the range."""
    if SOAK_DIR not in sys.path:
        sys.path.insert(0, SOAK_DIR)
    import measure_mb_noise
    import soak

    card = f"({smi})"
    res = {}
    for phase, target in SOAK_SMOKE_TARGETS.items():
        row = soak.run_phase(phase, target, dev)
        unit = "adds" if phase == "nibble" else "gates"
        rate = row["adds_per_s"] if phase == "nibble" else row["gates_per_s"]
        print(f"[{label}] soak {phase}: {row[unit]} {unit}, {row['errors']} errors, {row['spot_checks']} spot "
              f"checks (every {row['spot_every']} dispatches), {row['mismatches']} mismatches; {rate:.1f} {unit}/s, "
              f"{row['seconds']:.2f} s host clock {card} {elapsed()}")
        check(row["errors"] == 0, f"soak {phase}: every output decrypted correctly")
        check(row["spot_checks"] >= 1, f"soak {phase}: at least one spot check ran")
        check(row["mismatches"] == 0, f"soak {phase}: every spot check equal to the plain version bit for bit")
        check(row["device"] == smi.rsplit(",", 1)[0].strip(), f"soak {phase}: the row names the card")
        res[phase] = row
    print(f"[{label}] measure_mb_noise --quick {card}")
    rows = measure_mb_noise.measure(["SECURITY_128_BIT_FAST"], 256, dev)
    measure_mb_noise.check(rows)
    res["mb_noise"] = rows
    print(f"[{label}] done {elapsed()}")
    return res


#: Phase 19: the suite's main-path cases, and the sweep's routes and batches
SUITE_SMOKE_CASES = ["keygen_warm", "gate_nand_b1_latency", "gate_nand_b1_latency_mb", "gate_nand_b128",
                     "gate_nand_b4096", "blind_rotate_b2048", "keyswitch_b2048", "external_product_step_b2048"]
SWEEP_SMOKE_ROUTES = ("auto", "auto_mb", "fused_small_mb")
SWEEP_SMOKE_BATCHES = (1, 2, 8)
#: Phase 19's multi-device harness: 2 shares of the card, DP strong B = 64 and weak 32 a share,
#: TP against DP at B = 1 and 8 (the J = 2 shards of phase 3c)
MULTICHIP_SMOKE = {"n_devices": 2, "total_b": 64, "per_dev": 32, "tp_batches": (1, 8)}


def load_bench_script(name: str):
    """A fresh module of scripts/torch/<name>.py under a name of its own
    (the root bench.py is the JAX bench; its helpers found beside it)."""
    import importlib.util

    if SOAK_DIR not in sys.path:
        sys.path.insert(0, SOAK_DIR)
    spec = importlib.util.spec_from_file_location(f"_torch_bench_{name}", os.path.join(SOAK_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_benches(dev, label: str, smi: str) -> dict:
    """The measurement entry points (scripts/torch/bench.py, bench_suite.py,
    bench_latency_sweep.py, bench_multichip.py) in this process, so that the
    kernels' launch counts see them: bench.py at its defaults (FAST and
    strict at B = 4096), the suite's main-path cases (SUITE_SMOKE_CASES),
    the sweep at SWEEP_SMOKE_BATCHES for SWEEP_SMOKE_ROUTES at both sets,
    and the multi-device harness at MULTICHIP_SMOKE. Fails on a correctness
    below 1.0, a field or name the JAX scripts' artifacts do not have, or a
    route that launched another kernel than its own."""
    from rs_tfhe_tpu_torch.ops.blind_rotate import mb_route_batch_cap

    card = f"({smi})"
    bench, suite, sweep, multichip = (load_bench_script(n) for n in (
        "bench", "bench_suite", "bench_latency_sweep", "bench_multichip"))
    res = {}
    out = bench.run(dev)
    line = out["line"]
    print(f"[{label}] bench line {card}: {json.dumps(line)}")
    with open(os.path.join(ROOT, "BENCH_r05.json")) as f:
        check(set(line) == set(json.load(f)["parsed"]), "the bench line has the fields of BENCH_r05.json parsed")
    for pname, p_res in out["passes"].items():
        print(f"[{label}] bench {pname}: kernels {p_res['kernels']}")
        check(p_res["correctness"] == 1.0 and "mb_correct" not in p_res, f"bench {pname}: every gate right")
        check(set(p_res["kernels"]["batch"]) == {"K1 blind_rotate"}, f"bench {pname}: B=4096 on K1")
        check(set(p_res["kernels"]["b1_mb"]) == {"K4 blind_rotate_mb"}, f"bench {pname}: multi-bit B=1 on K4")
    res["bench"] = out
    rows = suite.run_cases(suite.Suite(dev), SUITE_SMOKE_CASES)
    for row in rows:
        print(f"[{label}] suite {json.dumps(row)}")
    check([r["name"] for r in rows] == SUITE_SMOKE_CASES, "the suite measured every case it was given")
    check(set(next(r for r in rows if r["name"] == "external_product_step_b2048")["kernels"])
          == {"K5 external_product"}, "the suite's step case ran on K5")
    res["suite"] = rows
    rows = sweep.sweep(dev, sweep.SETS, SWEEP_SMOKE_ROUTES, SWEEP_SMOKE_BATCHES)
    for row in rows:
        print(f"[{label}] sweep {json.dumps(row)}")
        check(row["correctness"] == 1.0, f"sweep {row['params']} B={row['batch']} {row['impl']}: every gate right")
        mb = row["impl"] == "fused_small_mb" or (
            row["impl"] == "auto_mb" and row["batch"] <= mb_route_batch_cap(sweep.params_by_name(row["params"])))
        check(set(row["kernels"]) == {"K4 blind_rotate_mb" if mb else "K1 blind_rotate"},
              f"sweep {row['params']} B={row['batch']} {row['impl']}: the route's kernel")
    res["sweep"] = rows
    scaling = multichip.run(dev, **MULTICHIP_SMOKE)
    print(f"[{label}] multichip {card}: {json.dumps(scaling)}")
    points = scaling["dp_strong_scaling"] + scaling["dp_weak_scaling"]
    check(all(r["correctness"] == 1.0 for r in points), "multichip: every data-parallel point right")
    check(all(r["dp_correctness"] == 1.0 and r["tp_correctness"] == 1.0 for r in scaling["tp_vs_dp_latency"]),
          "multichip: every latency point right, tensor parallel included")
    check(scaling["virtual"] == (torch.cuda.device_count() < 2), "multichip: a mesh of one card is virtual")
    res["multichip"] = scaling
    print(f"[{label}] done {elapsed()}")
    return res


#: Phase 20: the multi-bit rotations of the validation replayed through the plain version (the
#: multi-bit NAND's, then some of the noise stage's; each ~0.26 s of plain rotation at strict B = 2)
VALIDATION_MB_REPLAYS = 4


def run_validation(dev, label: str, smi: str) -> dict:
    """scripts/torch/tpu_validation.py in this process, in full, at the
    production sets: every check must pass, every golden entry of
    tests/vectors/golden_production_torch.npz among them. Then the card's
    cross-route check: the gate, MUX and PBS stages recomputed under
    step_impl="xla" (the plain rotation on the card, the --cpu path's
    arithmetic), and the first multi-bit rotations it ran held against
    blind_rotate_mb_plain on their own inputs; all bit for bit."""
    from rs_tfhe_tpu_torch.ops.blind_rotate import blind_rotate_mb_plain

    val = load_bench_script("tpu_validation")
    import soak

    card = f"({smi})"
    t0 = time.perf_counter()
    v = val.Validation(dev)
    with soak.recorded_mb_rotations(dev) as mb_calls:
        try:
            v.run()
        except SystemExit as err:
            check(False, f"tpu_validation: {err}")
    wall = time.perf_counter() - t0
    with np.load(val.GOLDEN) as z:
        golden = sorted(z.files)
    print(f"[{label}] tpu_validation: {len(v.passed)} checks passed in {wall:.1f} s {card}; stage seconds "
          + ", ".join(f"{k} {s:.2f}" for k, s in v.stage_s.items()))
    check(len(golden) == 9 and [f"golden[{n}]" for n in golden] == sorted(n for n in v.passed
                                                                        if n.startswith("golden[")),
          "tpu_validation verified every golden entry")
    check(any("s16 dot" in n for n in v.passed) and any("noise" in n for n in v.passed),
          "tpu_validation ran the card-only checks (the tripwire's counterpart, the multi-bit noise)")
    t1 = time.perf_counter()
    with soak.route("xla"):
        for name, fn, out in v.replays:
            check(torch.equal(fn(), out), f"tpu_validation '{name}' under step_impl='xla' equals its output")
    torch.cuda.synchronize()
    xla_s = time.perf_counter() - t1
    check(len(mb_calls) > VALIDATION_MB_REPLAYS, "tpu_validation ran the multi-bit kernel")
    for args, out in mb_calls[:VALIDATION_MB_REPLAYS]:
        check(torch.equal(blind_rotate_mb_plain(*args), out),
              "tpu_validation's multi-bit rotation equals blind_rotate_mb_plain on its inputs")
    print(f"[{label}] replays equal bit for bit: {len(v.replays)} stage outputs under step_impl='xla' "
          f"({xla_s:.1f} s), {VALIDATION_MB_REPLAYS} of {len(mb_calls)} multi-bit rotations through "
          f"blind_rotate_mb_plain {elapsed()}")
    return {"checks": len(v.passed), "wall_s": wall, "stage_s": v.stage_s, "golden": golden,
            "xla_replays": len(v.replays), "xla_s": xla_s, "mb_replays": VALIDATION_MB_REPLAYS}


def run_diag(dev, label: str, smi: str) -> dict:
    """scripts/torch/diag_gate_latency.py's four chains (rotation, +extract,
    +key switch, the NAND) at FAST and strict with a standard key at
    DIAG_BATCHES and a multi-bit key at DIAG_MB_BATCHES (the multi-bit
    kernel): host-clock ms a call as the script times them, and device ms
    by CUDA events with the chain queued behind a spin kernel. The split
    answers where a small-batch gate's time goes; device ms must not fall
    along the chain beyond the spread of a device-bound time (3%)."""
    from rs_tfhe_tpu_torch import params as P

    diag = load_bench_script("diag_gate_latency")
    card = f"({smi})"
    rows, kernels = [], {}
    for p in (P.SECURITY_128_BIT_FAST, P.SECURITY_128_BIT):
        for multibit, batches in ((False, DIAG_BATCHES), (True, DIAG_MB_BATCHES)):
            sk, ck = diag.keys(p, dev, multibit=multibit)
            # the rotation, extraction and key switch of one B=1 call by kernel (torch.profiler, a
            # chain of 5 over 5)
            a, b = diag.inputs(sk, 1)
            split = {k: v / 5 for k, v in _profile_split(lambda: diag.full_bs(a, b, ck, 5)).items()}
            kernels[f"{_name(p)} {'multibit' if multibit else 'standard'}"] = split
            print(f"[{label}] diag {_name(p)} {'multibit' if multibit else 'standard'} B=1 rot+ext+ks by kernel, "
                  f"device ms a call (profiler): {json.dumps({k: round(v, 4) for k, v in split.items()})}")
            for batch in batches:
                _, d = diag.measure(batch, sk, ck, events=True)
                row = {"params": _name(p), "key": "multibit" if multibit else "standard", **d}
                rows.append(row)
                host = [d[s + "_ms"] for s in diag.STAGES]
                devc = [d[s + "_device_ms"] for s in diag.STAGES]
                print(f"[{label}] diag {row['params']} {row['key']} B={batch}: ms a call host / device: "
                      + ", ".join(f"{s} {h:.3f} / {e:.3f}" for s, h, e in zip(diag.STAGES, host, devc))
                      + f"; split (host / device): extract {host[1] - host[0]:.3f} / {devc[1] - devc[0]:.3f}, "
                        f"key switch {host[2] - host[1]:.3f} / {devc[2] - devc[1]:.3f}, linear form and host "
                        f"{host[3] - host[2]:.3f} / {devc[3] - devc[2]:.3f} {card}")
                check(all(d[s + "_queued"] for s in diag.STAGES),
                      f"diag {row['params']} B={batch}: each chain was queued before the card reached it")
                check(all(b >= 0.97 * a for a, b in zip(devc, devc[1:])),
                      f"diag {row['params']} {row['key']} B={batch}: device ms rot <= +ext <= +ks <= nand")
    print(f"[{label}] done {elapsed()}")
    return {"rows": rows, "b1_kernels": kernels}


#: kernels-line name -> (source, file:line of the TPU kernel it replaces, others it also replaces)
SOURCES = {
    "blind_rotate": ("rs_tfhe_tpu_torch/csrc/blind_rotate.cu", "rs_tfhe_tpu/ops/pallas_blind_rotate.py:929",
                     ["rs_tfhe_tpu/ops/pallas_blind_rotate.py:828", "rs_tfhe_tpu/ops/pallas_blind_rotate.py:725"]),
    "blind_rotate_mb": ("rs_tfhe_tpu_torch/csrc/blind_rotate_mb.cu", "rs_tfhe_tpu/ops/pallas_blind_rotate.py:668", []),
    "external_product": ("rs_tfhe_tpu_torch/csrc/external_product.cu", "rs_tfhe_tpu/ops/pallas_step.py:91", []),
    "probe_dot": ("rs_tfhe_tpu_torch/csrc/probes.cu", "scripts/probe_mosaic.py:33", []),
    "probe_roll": ("rs_tfhe_tpu_torch/csrc/probes.cu", "scripts/probe_mosaic.py:50", []),
    "probe_bitcast_i32_to_i8": ("rs_tfhe_tpu_torch/csrc/probes.cu", "scripts/probe_mosaic.py:63", []),
    "probe_unpack_s16": ("rs_tfhe_tpu_torch/csrc/probes.cu", "scripts/probe_mosaic.py:76", []),
    "probe_dot_correct_s16": ("rs_tfhe_tpu_torch/csrc/probes.cu", "scripts/probe_mosaic.py:96", []),
    "chain_dot": ("rs_tfhe_tpu_torch/csrc/probes.cu", "scripts/bench_kernel_prims.py:46", []),
    "chain_roll_add": ("rs_tfhe_tpu_torch/csrc/probes.cu", "scripts/bench_kernel_prims.py:120", []),
    # P1's s16 unit as the Nussbaumer route calls it (ops/nussbaumer.pointwise_dot), counted apart
    "nussbaumer_dot": ("rs_tfhe_tpu_torch/csrc/probes.cu", "scripts/probe_mosaic.py:33", []),
    # no TPU kernel: the JAX key switch is a plain XLA product (rs_tfhe_tpu/ops/keyswitch.py:25)
    "key_switch": ("rs_tfhe_tpu_torch/csrc/key_switch.cu", None, []),
}


def main() -> int:
    smi = phase_environment()
    import rs_tfhe_tpu_torch  # noqa: F401  (fails outside a checkout)
    from rs_tfhe_tpu_torch import params as P

    # the kernels whose launches the counters keep by instance: name -> the counters' prefix
    modules = {"blind_rotate": "k1", "blind_rotate_mb": "k4", "external_product": "k5", "key_switch": "ks"}
    probe_names = [k for k in SOURCES if k not in modules]

    path_tiles = {k: set() for k in modules}
    path_dot_shapes = set()  # the Nussbaumer dot's (B, K, M) on the paths
    roll_add_instances = collections.Counter()

    def drive(path, fn, *args):
        """Run one path; return its result and the launch counts it moved
        (the counters' difference over the path)."""
        before = counters()
        out = fn(*args)
        moved = counts_since(before)
        counts = {k: moved.get(f"{c}.launches", 0) for k, c in modules.items()}
        counts.update({k: moved.get(f"probes.launches.{k}", 0) for k in probe_names})
        counts["bsk.strip_builds"] = moved.get("bsk.strip_builds", 0)
        roll_add_instances.update({w: n for (w,), n in by_instance(moved, "probes.roll_add.instance").items()})
        launched = {k: by_instance(moved, f"{c}.instance") for k, c in modules.items()}
        tiles = {k: tile_list(t) for k, t in launched.items()}
        for k, t in launched.items():
            path_tiles[k].update(t)
        path_dot_shapes.update(by_instance(moved, "nussbaumer.shape"))
        print(f"[{path}] kernel launches on this path: { {k: v for k, v in counts.items() if v} }; "
              f"instances launched: {tiles}")
        return out, counts

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    compare = {
        "blind_rotate": phase_kernel_vs_plain(dev),
        "blind_rotate_mb": phase_mb_kernel_vs_plain(dev),
        "external_product": phase_step_kernel_vs_plain(dev),
        "key_switch": phase_key_switch_vs_plain(dev),
    }
    crossover = phase_crossover(dev)
    compare.update(phase_probes_vs_plain(dev))
    compare["nussbaumer_dot"] = phase_nussbaumer_dot_vs_plain(dev)
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
    check(paths["mb_gates"]["blind_rotate"] > 0, "the multi-bit gate path launched the whole-rotation kernel")
    results["pbs_radix"], paths["pbs_radix"] = drive("8", run_pbs, P.SECURITY_128_BIT_RADIX, dev, "8")
    check(paths["pbs_radix"]["blind_rotate_mb"] > 0, "the PBS path launched the multi-bit kernel")
    check(paths["pbs_radix"]["blind_rotate"] > 0, "the PBS path launched the blind-rotation kernel")
    results["pallas"], paths["pallas"] = drive("9", run_pallas_route, P.SECURITY_128_BIT_FAST, 4096, dev, "9")
    check(paths["pallas"]["external_product"] > 0, "the per-step route launched the step kernel")
    results["probes"], paths["probes"] = drive("10", run_probe_scripts, dev)
    for name in probe_names:
        if name != "nussbaumer_dot":  # the Nussbaumer route's count (phase 16)
            check(paths["probes"][name] > 0, f"the probe scripts launched {name}")
    fast = P.SECURITY_128_BIT_FAST
    results["circuits_std"], paths["circuits_std"] = drive("11", run_circuits, fast, dev, "11", False)
    check(paths["circuits_std"]["blind_rotate"] > 0, "circuits with a standard key launched the blind-rotation kernel")
    check(paths["circuits_std"]["key_switch"] > 0, "the circuits' small plan groups launched the key switch kernel")
    results["circuits_mb"], paths["circuits_mb"] = drive("11", run_circuits, fast, dev, "11", True)
    check(paths["circuits_mb"]["blind_rotate_mb"] > 0, "circuits with a multi-bit key launched the multi-bit kernel")
    check(paths["circuits_mb"]["blind_rotate"] > 0, "circuits with a multi-bit key launched the whole-rotation kernel")
    results["multi_value"], paths["multi_value"] = drive("12", run_multi_value, P.SECURITY_128_BIT_RADIX, dev, "12")
    check(paths["multi_value"]["blind_rotate"] > 0, "multi-value bootstrapping launched the blind-rotation kernel")
    check(paths["multi_value"]["blind_rotate_mb"] == 0,
          "the dedicated B=2048 bootstraps with a multi-bit key took the whole-rotation kernel (above the cap)")
    results["radix"], paths["radix"] = drive("13", run_radix, P.SECURITY_128_BIT_RADIX, dev, "13")
    check(paths["radix"]["blind_rotate"] > 0, "radix arithmetic launched the whole-rotation kernel")
    check(paths["radix"]["blind_rotate_mb"] > 0, "radix arithmetic with a multi-bit key launched the multi-bit kernel")
    results["nibble_mul"], paths["nibble_mul"] = drive("14", run_nibble_mul, dev, "14")
    check(paths["nibble_mul"]["blind_rotate"] > 0, "mul_radix at NIBBLE launched the whole-rotation kernel")
    results["deployment"], paths["deployment"] = drive("15", run_deployment, fast, dev, "15", smi)
    check(paths["deployment"]["blind_rotate"] > 0, "the deployment path launched the whole-rotation kernel")
    check(paths["deployment"]["blind_rotate_mb"] > 0, "the deployment path launched the multi-bit kernel")
    results["parallel"], paths["parallel"] = drive("16", run_parallel, dev, "16", smi)
    check(paths["parallel"]["blind_rotate"] > 0, "the data-parallel paths launched the whole-rotation kernel")
    check(paths["parallel"]["blind_rotate_mb"] > 0, "the multi-bit key's data-parallel shards launched the multi-bit "
                                                    "kernel")
    check(paths["parallel"]["external_product"] > 0, "the tensor-parallel paths launched the step kernel")
    check(paths["parallel"]["nussbaumer_dot"] > 0, "the Nussbaumer route launched P1's s16 unit")
    results["examples"], paths["examples"] = drive("17", run_examples, "17", smi)
    check(paths["examples"]["blind_rotate"] > 0, "the examples launched the whole-rotation kernel")
    check(paths["examples"]["blind_rotate_mb"] > 0, "low_latency_gates' multi-bit key launched the multi-bit kernel")
    results["soak"], paths["soak"] = drive("18", run_soak, dev, "18", smi)
    check(paths["soak"]["blind_rotate"] > 0, "the soak launched the whole-rotation kernel")
    check(paths["soak"]["blind_rotate_mb"] > 0, "the multi-bit soak and the noise measurement launched the "
                                                "multi-bit kernel")
    results["benches"], paths["benches"] = drive("19", run_benches, dev, "19", smi)
    check(paths["benches"]["blind_rotate"] > 0, "the benches launched the whole-rotation kernel")
    check(paths["benches"]["blind_rotate_mb"] > 0, "the benches launched the multi-bit kernel")
    check(paths["benches"]["external_product"] > 0, "the suite's step case and the TP points launched the step "
                                                    "kernel")
    results["validation"], paths["validation"] = drive("20", run_validation, dev, "20", smi)
    check(paths["validation"]["blind_rotate"] > 0, "the validation launched the whole-rotation kernel")
    check(paths["validation"]["blind_rotate_mb"] > 0, "the validation's multi-bit stages launched the multi-bit "
                                                      "kernel")
    check(paths["validation"]["probe_dot"] > 0, "the tripwire's counterpart launched P1's s16 unit")
    results["diag"], paths["diag"] = drive("20", run_diag, dev, "20", smi)
    check(paths["diag"]["blind_rotate"] > 0, "the diag's standard-key chains launched the whole-rotation kernel")
    check(paths["diag"]["blind_rotate_mb"] > 0, "the diag's multi-bit chains launched the multi-bit kernel")
    print(f"[5-20] peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
          f"total {elapsed()}")
    shapes_compared = {tuple(t) for t in compare["nussbaumer_dot"]["shapes_compared"]}
    print(f"[5-20] nussbaumer_dot (B, K, M) on the paths {tile_list(path_dot_shapes)}, held against the plain "
          f"version in phase 3e: {tile_list(shapes_compared)}")
    check(not path_dot_shapes - shapes_compared,
          f"every shape of the Nussbaumer dot the paths launched was held against the plain version "
          f"(missing: {tile_list(path_dot_shapes - shapes_compared)})")
    for name in modules:
        compared = {tuple(t) for t in compare[name]["tiles_compared"]}
        missing = path_tiles[name] - compared
        print(f"[5-20] {name}: instances on the paths {tile_list(path_tiles[name])}, "
              f"held against the plain version in phase 3: {tile_list(compared)}")
        check(not missing, f"every {name} instantiation the paths launched was held against the plain "
                           f"version (missing: {tile_list(missing)})")

    kernels = []
    for name, (source, replaces, also) in SOURCES.items():
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(c[name] for c in paths.values()),
            "launches_by_path": {k: c[name] for k, c in paths.items() if c[name]},
            **compare[name],
        }
        if name in modules:
            entry["tiles_on_path"] = tile_list(path_tiles[name])
        if name == "blind_rotate":  # the wgmma instance's key strips built, beside the launches
            entry["strip_builds"] = sum(c["bsk.strip_builds"] for c in paths.values())
            entry["strip_builds_by_path"] = {k: c["bsk.strip_builds"] for k, c in paths.items()
                                             if c["bsk.strip_builds"]}
        if name == "nussbaumer_dot":
            entry["shapes_on_path"] = tile_list(path_dot_shapes)
        if name == "chain_roll_add":
            entry["launches_by_instance"] = {roll_add_instance(w): n for w, n in sorted(roll_add_instances.items())}
        if also:
            entry["also_replaces"] = also
        missing = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
                   "bound_ms", "bound_by", "library_ms"} - entry.keys()
        check(not missing, f"kernel {name} has every key of the kernels line (missing: {sorted(missing)})")
        kernels.append(entry)
    print(smi)
    print(json.dumps({"kernels": kernels, "main_path": results, "crossover_ms": crossover, "card": smi,
                      "peaks": {"bytes_per_s": PEAK_BYTES, "s8_macs_per_s": PEAK_S8_MACS,
                                "int32_macs_per_s": PEAK_INT32_MACS, "int32_adds_per_s": PEAK_INT32_ADDS}}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
