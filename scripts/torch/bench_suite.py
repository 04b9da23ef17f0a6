"""Per-op benchmark suite of the PyTorch port on the card: the counterpart
of scripts/bench_suite.py, with its 38 metrics by name, unit and count of
iterations.

Every metric is a row of CASES, (name, unit, function of a `Suite`), in the
JAX script's order; the names can be listed without running anything, and
`--only name[,name]` runs a subset. Metrics the JAX script measures
together (the 10,240 batch and its wall time; the 32-bit adder's six
readings) share one measurement, made once per run.

Timing, as the JAX script's helpers (scripts/bench_suite.py:52-122):
`timeit` is the best of 2 runs of `iters` chained calls after a warm run,
divided by `iters`; `timeit_slope` the slope between chains of 5 and 25
calls, each the minimum of 4 repeats after a warm call; `xor_into_body`
folds the parity of the whole output into the next input's last word, with
wrapping adds on the int32 carrier. Chains are eager loops on the card's
stream (bench_common.chain), ended by a scalar read. The ops are the
port's: `ops.blind_rotate.blind_rotate` with the key's `bsk` (the port has
no `bsk_packed`), the external-product step as
`ops.decompose.gadget_decompose` then `ops.cuda_step.external_product` (K5)
against the JAX script's random step polynomials, the Nussbaumer step as
`ops.nussbaumer` runs it (P1's s16 unit), the adder through
`models.netlist` (`evaluate` with the plan, the gate-at-a-time `Plan`,
`compile_circuit`). Functions given to LUT bootstraps are made once, so
the port's LUT cache holds them as the JAX script's trace does.

Seeds: where the JAX script calls jax.random.key(k), a torch generator
seeded k (bench_common.generator); plaintexts from np.random.default_rng(0)
drawn in the JAX script's order (`draw_plaintexts`), so a subset run uses
the same plaintexts as a full one. Correctness: the circuit, the sorts and
the NIBBLE products are decrypted and asserted as in the JAX script, and
the 80/110-bit NANDs must all decrypt true.

    python scripts/torch/bench_suite.py                        # all 38 on the card (RS_TFHE_BENCH_EXTRA=0: the FAST ones)
    python scripts/torch/bench_suite.py --only mul8x8_b16_NIBBLE,mul8x8_b16_NIBBLE_mv
    python scripts/torch/bench_suite.py --list
    RS_TFHE_BENCH_PARAMS=TEST_TINY python scripts/torch/bench_suite.py --cpu --only gate_nand_b128,keyswitch_b2048

Environment, as the JAX script: RS_TFHE_BENCH_PARAMS (the headline set,
SECURITY_128_BIT_FAST; TEST_TINY for a rehearsal) and RS_TFHE_BENCH_EXTRA=0 (skip the other sets'
metrics). Each run merges its rows by name into BENCH_SUITE_torch_h100.json
at the repo root (--out; on the CPU only where --out is given), with the
card's name and power limit, and attaches the latency-vs-batch rows of
LATENCY_SWEEP_torch_h100.json when that file exists beside it. Without --cpu it runs
on the card and raises where there is none.
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
    ROOT, barrier, card_fields, chain, device_of, generator, launched_since, launches, load_json, log,
    min_time, params_by_name, parity, write_json, xor_into_body,
)

from rs_tfhe_tpu_torch import ALL_SECURITY_SETS, gates, proxy_reenc  # noqa: E402
from rs_tfhe_tpu_torch.bit_utils import decrypt_uint, encrypt_uint  # noqa: E402
from rs_tfhe_tpu_torch.bootstrap import LutBootstrap  # noqa: E402
from rs_tfhe_tpu_torch.key import CloudKey, SecretKey  # noqa: E402
from rs_tfhe_tpu_torch.models import netlist  # noqa: E402
from rs_tfhe_tpu_torch.models.arithmetic import add_radix, decrypt_radix, encrypt_radix, mul_radix  # noqa: E402
from rs_tfhe_tpu_torch.models.circuits import add_kogge_stone  # noqa: E402
from rs_tfhe_tpu_torch.models.sort import sort_bits, sort_radix  # noqa: E402
from rs_tfhe_tpu_torch.ops import nussbaumer  # noqa: E402
from rs_tfhe_tpu_torch.ops.blind_rotate import blind_rotate  # noqa: E402
from rs_tfhe_tpu_torch.ops.cuda_step import external_product  # noqa: E402
from rs_tfhe_tpu_torch.ops.decompose import gadget_decompose  # noqa: E402
from rs_tfhe_tpu_torch.ops.extract import sample_extract  # noqa: E402
from rs_tfhe_tpu_torch.ops.keyswitch import identity_key_switch  # noqa: E402
from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_bool, lwe_encrypt_bool, lwe_encrypt_message  # noqa: E402
from rs_tfhe_tpu_torch.torus import to_torch, wrap_i32  # noqa: E402

OUT = os.path.join(ROOT, "BENCH_SUITE_torch_h100.json")
SWEEP = os.path.join(ROOT, "LATENCY_SWEEP_torch_h100.json")

#: the other parameter families' (set, secret-key seed, cloud-key seed), scripts/bench_suite.py:375-521
EXTRA_KEYS = {
    "RADIX": ("SECURITY_128_BIT_RADIX", 30, 31),
    "UINT4": ("SECURITY_UINT4", 40, 41),
    "NIBBLE": ("SECURITY_128_BIT_NIBBLE", 50, 51),
    "STRICT": ("SECURITY_128_BIT", 60, 61),
    "80BIT": ("SECURITY_80_BIT", 70, 71),
    "110BIT": ("SECURITY_110_BIT", 80, 81),
}


# ---------------------------------------------------------------------------
# Timing helpers (scripts/bench_suite.py:52-122)
# ---------------------------------------------------------------------------

def timeit(fn, *args, iters=3, carry=None) -> float:
    """Seconds a call: the best of 2 runs of `iters` chained calls after a
    warm run, over `iters`."""
    return min_time(lambda: chain(fn, args, iters, carry), 2) / iters


def timeit_slope(fn, *args, short=5, long=25, carry=None, repeats=4) -> float:
    """Seconds a call from the slope between chains of `long` and `short`
    calls, each the minimum of `repeats` after a warm call."""
    t_long = min_time(lambda: chain(fn, args, long, carry), repeats)
    t_short = min_time(lambda: chain(fn, args, short, carry), repeats)
    return (t_long - t_short) / (long - short)


def add_parity(out, cur):
    """The step cases' carry: every word of the input plus the output's
    parity (scripts/bench_suite.py:261)."""
    return (wrap_i32(cur[0].to(torch.int64) + parity(out)),)


# ---------------------------------------------------------------------------
# The ops the suite times, as functions the tests can call
# ---------------------------------------------------------------------------

def six_gates(x, y, ck):
    """The reference's six-gate group: nand, then and, or, xor, xnor, nor,
    each of the previous output and y (scripts/bench_suite.py:182-186)."""
    out = gates.nand(x, y, ck)
    for g in (gates.and_, gates.or_, gates.xor, gates.xnor, gates.nor):
        out = g(out, y, ck)
    return out


def rotation_input(a):
    """The rotation cases' input: the NAND linear form of a with itself
    (scripts/bench_suite.py:200)."""
    return gates._nand_lin(a, a)


def ext_step(x, step_polys, params):
    """One external-product step on a TRLWE batch: the gadget digits of x
    against the step polynomials, on K5 (scripts/bench_suite.py:255-258)."""
    return external_product(gadget_decompose(x, params), step_polys, params)


def nuss_step(x, step_polys, params):
    """The same step through the Nussbaumer transform (scripts/bench_suite.py:265-267)."""
    return nussbaumer.external_product_step(
        gadget_decompose(x, params), nussbaumer.prepare_bsk_step(step_polys, params), params)


def draw_plaintexts(rng: np.random.Generator, params) -> dict:
    """Every plaintext the JAX script draws from its default_rng(0), in its
    order (the step polynomials' shape follows `params`)."""
    def bits(n):
        return rng.integers(0, 2, n).astype(bool)

    g = params.trgsw_lv1
    d = {"b1": bits(1)}
    for batch in (128, 2048, 4096, 10240):
        d[f"b{batch}"] = bits(batch)
    d["six"] = bits(2048)
    d["mux_ab"], d["mux_c"] = bits(1024), bits(1024)
    d["rot"] = bits(2048)
    d["lut"] = rng.integers(0, 8, 2048)
    d["radix"] = (rng.integers(0, 256, 64), rng.integers(0, 256, 64))
    d["step_polys"] = rng.integers(0, 1 << 32, (2 * g.l, 2, params.n1), dtype=np.uint32)
    d["trlwe"] = rng.integers(0, 1 << 32, (2048, 2, params.n1), dtype=np.uint32)
    d["sort_bits"] = rng.integers(0, 256, 8)
    d["proxy"] = bits(4096)
    d["radix16"] = (rng.integers(0, 256, 64), rng.integers(0, 256, 64))
    d["sort_radix"] = rng.integers(0, 64, 8)
    d["uint4"] = rng.integers(0, 16, 2048)
    d["nibble"] = (rng.integers(0, 256, 64), rng.integers(0, 256, 64))
    d["mul16"] = (rng.integers(0, 1 << 16, 16), rng.integers(0, 1 << 16, 16))
    d["mul8"] = (rng.integers(0, 256, 16), rng.integers(0, 256, 16))
    for tag in ("STRICT", "80BIT", "110BIT"):
        d[tag] = bits(4096)
    return d


class Suite:
    """One run: the device, the headline set, keys made on first use with
    the JAX script's seeds, the plaintexts, and the measurements shared by
    several metrics. `max_batch` caps every batch (a rehearsal at a small
    size: the batches' plaintexts are then prefixes of the full run's)."""

    def __init__(self, device, pname: str = "SECURITY_128_BIT_FAST", max_batch: int | None = None):
        self.device, self.pname, self.params = device, pname, params_by_name(pname)
        self.max_batch = max_batch
        self.draws = draw_plaintexts(np.random.default_rng(0), self.params)
        self._keys: dict = {}
        self._shared: dict = {}

    def n(self, batch: int) -> int:
        return batch if self.max_batch is None else min(batch, self.max_batch)

    def gen(self, seed: int) -> torch.Generator:
        return generator(self.device, seed)

    def main_keys(self):
        """(sk, ck, keygen_warm ms): sk from key 42, a first cloud key from 7,
        the warm one from 8, which every headline case uses."""
        if "main" not in self._keys:
            sk = SecretKey.generate(self.params, self.gen(42))
            t0 = time.perf_counter()
            ck = CloudKey.generate(sk, self.gen(7))
            barrier(ck.bsk)
            log(f"keygen first: {time.perf_counter() - t0:.1f}s")
            t0 = time.perf_counter()
            ck = CloudKey.generate(sk, self.gen(8))
            barrier(ck.bsk)
            self._keys["main"] = (sk, ck, (time.perf_counter() - t0) * 1e3)
        return self._keys["main"]

    def mb_key(self):
        """The headline set's multi-bit key (key 7), or None where n0 is odd."""
        if "main_mb" not in self._keys:
            sk = self.main_keys()[0]
            self._keys["main_mb"] = (CloudKey.generate(sk, self.gen(7), multibit=True)
                                     if self.params.n0 % 2 == 0 else None)
        return self._keys["main_mb"]

    def extra_keys(self, tag: str, multibit: bool = False):
        """(params, sk, ck) of another family (EXTRA_KEYS), the multi-bit key
        from the same cloud-key seed."""
        key = (tag, multibit)
        if key not in self._keys:
            name, ks, kc = EXTRA_KEYS[tag]
            p = ALL_SECURITY_SETS[name]
            sk = self.extra_keys(tag)[1] if multibit else SecretKey.generate(p, self.gen(ks))
            self._keys[key] = (p, sk, CloudKey.generate(sk, self.gen(kc), multibit=multibit))
        return self._keys[key]

    def enc_pair(self, bits, seed: int = 1, sk=None, params=None):
        """(Enc(bits), Enc(~bits)) from keys `seed` and `seed + 1`
        (scripts/bench_suite.py:144-150)."""
        sk = sk if sk is not None else self.main_keys()[0]
        params = params or self.params
        bits = bits[: self.n(len(bits))]
        a = lwe_encrypt_bool(self.gen(seed), sk.lv0, bits, params.tlwe_lv0.alpha)
        b = lwe_encrypt_bool(self.gen(seed + 1), sk.lv0, ~bits, params.tlwe_lv0.alpha)
        return a, b

    def shared(self, fn) -> dict:
        """`fn(self)`'s metrics, measured once per run."""
        if fn.__name__ not in self._shared:
            self._shared[fn.__name__] = fn(self)
        return self._shared[fn.__name__]


# ---------------------------------------------------------------------------
# The cases (scripts/bench_suite.py:133-521)
# ---------------------------------------------------------------------------

def _b1_latency(s: Suite, ck) -> float:
    a1, b1 = s.enc_pair(s.draws["b1"])
    return timeit_slope(lambda a, b: gates.nand(a, b, ck), a1, b1, carry=xor_into_body) * 1e3


def _latency_mb(s: Suite):
    ck_mb = s.mb_key()
    return None if ck_mb is None else _b1_latency(s, ck_mb)


def _nand_rate(batch: int):
    def case(s: Suite) -> float:
        ck = s.main_keys()[1]
        a, b = s.enc_pair(s.draws[f"b{batch}"])
        dt = timeit(lambda x, y: gates.nand(x, y, ck), a, b, iters=3 if batch >= 2048 else 5, carry=xor_into_body)
        return s.n(batch) / dt
    return case


def _batch10k(s: Suite) -> dict:
    rate = _nand_rate(10240)(s)
    return {"gate_nand_b10240": rate, "gate_batch10k_wall": s.n(10240) / rate * 1e3}


def _six(s: Suite) -> float:
    ck = s.main_keys()[1]
    a, b = s.enc_pair(s.draws["six"])
    return 6 * s.n(2048) / timeit(lambda x, y: six_gates(x, y, ck), a, b, iters=1)


def _mux(s: Suite) -> float:
    ck = s.main_keys()[1]
    am, bm = s.enc_pair(s.draws["mux_ab"])
    cm, _ = s.enc_pair(s.draws["mux_c"], seed=5)
    return s.n(1024) / timeit(lambda x, y, z: gates.mux(x, y, z, ck), am, bm, cm, iters=2, carry=xor_into_body)


def _rotation_case(s: Suite) -> dict:
    """blind_rotate_b2048 and keyswitch_b2048: the rotation of the NAND
    linear form, then the key switch of its extracted lv1 ciphertexts."""
    ck, p = s.main_keys()[1], s.params
    a, _ = s.enc_pair(s.draws["rot"])
    lin = rotation_input(a)
    res = {"blind_rotate_b2048": s.n(2048) / timeit(lambda x: blind_rotate(x, ck.testvec, ck.bsk, p), lin,
                                                    iters=3, carry=xor_into_body)}
    lv1 = sample_extract(blind_rotate(lin, ck.testvec, ck.bsk, p))
    res["keyswitch_b2048"] = s.n(2048) / timeit(lambda x: identity_key_switch(x, ck.ksk_limbs, p), lv1, iters=5,
                                                carry=xor_into_body)
    return res


def _times_three_mod_8(v):
    return (v * 3) % 8


def _times_three_plus_one_mod_16(v):
    return (v * 3 + 1) % 16


def _lut(s: Suite) -> float:
    sk, ck, _ = s.main_keys()
    lb = LutBootstrap()
    msgs = s.draws["lut"][: s.n(2048)]
    ct = lwe_encrypt_message(s.gen(3), sk.lv0, msgs, 8, s.params.tlwe_lv0.alpha)
    return s.n(2048) / timeit(lambda x: lb.bootstrap_func(x, _times_three_mod_8, 8, ck), ct, iters=3,
                              carry=xor_into_body)


def _radix_add(s: Suite) -> float:
    sk, ck, _ = s.main_keys()
    xs, ys = (v[: s.n(64)] for v in s.draws["radix"])
    ra = encrypt_radix(s.gen(4), sk.lv0, xs, 3, s.params)
    rb = encrypt_radix(s.gen(5), sk.lv0, ys, 3, s.params)
    return timeit(lambda x, y: add_radix(x, y, ck), ra, rb, iters=1) * 1e3 / s.n(64)


def _step_inputs(s: Suite):
    return (to_torch(s.draws["step_polys"], s.device),
            to_torch(s.draws["trlwe"][: s.n(2048)], s.device))


def _ext_step(s: Suite) -> float:
    step_polys, trlwe = _step_inputs(s)
    return s.n(2048) / timeit(lambda x: ext_step(x, step_polys, s.params), trlwe, iters=3, carry=add_parity)


def _nuss_step(s: Suite):
    if not nussbaumer.check_bounds(s.params):
        return None
    step_polys, trlwe = _step_inputs(s)
    return s.n(2048) / timeit(lambda x: nuss_step(x, step_polys, s.params), trlwe, iters=3, carry=add_parity)


def _best_of_2(run) -> float:
    """ms of `run()` (which ends at a barrier): the best of 2 after a warm run."""
    return min_time(run, 2) * 1e3


def _adder_inputs(s: Suite):
    sk = s.main_keys()[0]
    alpha = s.params.tlwe_lv0.alpha
    xv, yv = 0xDEADBEEF, 0x12345678
    return xv, yv, encrypt_uint(s.gen(70), sk.lv0, xv, 32, alpha), encrypt_uint(s.gen(71), sk.lv0, yv, 32, alpha)


def _circuit(s: Suite) -> dict:
    """The netlist-scheduled 32-bit ripple-carry adder with each key, its
    gate-at-a-time plan and its compiled plan (scripts/bench_suite.py:280-337)."""
    sk, ck, _ = s.main_keys()
    ck_mb = s.mb_key()
    ckt, _, _, sums = netlist.ripple_carry_adder(32)
    the_plan = netlist.plan(ckt)
    n_boot = sum(1 for g in ckt.gates if g.op not in ("not", "copy"))
    xv, yv, ea, eb = _adder_inputs(s)
    inputs = torch.cat([ea, eb], dim=0)

    def run_plan(pl_, key):
        wires = netlist.evaluate(ckt, inputs, key, pl_)
        barrier(wires)
        return wires

    wires = run_plan(the_plan, ck_mb)  # warm + correctness
    got = decrypt_uint(wires[sums], sk.lv0)
    assert int(got) == (xv + yv) % (1 << 32), got
    res = {}
    for label, key in (("circuit_rc_adder32_wall", ck), ("circuit_rc_adder32_wall_mb", ck_mb)):
        res[label] = _best_of_2(lambda: run_plan(the_plan, key))
    res["circuit_rc_adder32_rate_mb"] = n_boot / res["circuit_rc_adder32_wall_mb"] * 1e3
    order = the_plan.order
    singles = netlist.Plan(
        levels=the_plan.levels, order=order,
        groups=[(i, i + 1, ckt.gates[int(g)].op, int(the_plan.levels[int(g)])) for i, g in enumerate(order)],
        n_levels=the_plan.n_levels,
    )
    run_plan(singles, ck_mb)  # warm
    t0 = time.perf_counter()
    run_plan(singles, ck_mb)
    res["circuit_rc_adder32_gate_at_a_time_wall"] = (time.perf_counter() - t0) * 1e3
    run_jit = netlist.compile_circuit(ckt, the_plan)
    wires = run_jit(inputs, ck_mb)
    got = decrypt_uint(wires[sums], sk.lv0)
    assert int(got) == (xv + yv) % (1 << 32), got
    res["circuit_rc_adder32_wall_jit_mb"] = _best_of_2(lambda: run_jit(inputs, ck_mb))
    res["circuit_rc_adder32_rate_jit_mb"] = n_boot / res["circuit_rc_adder32_wall_jit_mb"] * 1e3
    return res


def _kogge_stone(s: Suite) -> float:
    ck = s.main_keys()[1]
    _, _, ea, eb = _adder_inputs(s)
    return _best_of_2(lambda: add_kogge_stone(ea, eb, ck))


def _sort_bits(s: Suite) -> float:
    sk, ck, _ = s.main_keys()
    vals = s.draws["sort_bits"]
    scts = torch.stack([encrypt_uint(s.gen(80 + i), sk.lv0, int(v), 8, s.params.tlwe_lv0.alpha)
                        for i, v in enumerate(vals)])
    sorted_cts = sort_bits(scts, ck)  # warm + correctness
    got = [int(decrypt_uint(sorted_cts[i], sk.lv0)) for i in range(len(vals))]
    assert got == sorted(vals.tolist()), got
    t0 = time.perf_counter()
    barrier(sort_bits(scts, ck))
    return (time.perf_counter() - t0) * 1e3


def _proxy(s: Suite) -> float:
    sk = s.main_keys()[0]
    sk_b = SecretKey.generate(s.params, s.gen(9))
    rk = proxy_reenc.new_symmetric(s.gen(10), sk.lv0, sk_b.lv0, s.params)
    a, _ = s.enc_pair(s.draws["proxy"])
    return s.n(4096) / timeit(lambda x: proxy_reenc.reencrypt(x, rk), a, iters=5, carry=xor_into_body)


def _radix_nibble_add(s: Suite) -> float:
    pr, skr, ckr = s.extra_keys("RADIX")
    xs, ys = (v[: s.n(64)] for v in s.draws["radix16"])
    ra = encrypt_radix(s.gen(32), skr.lv0, xs, 2, pr, base_bits=4)
    rb = encrypt_radix(s.gen(33), skr.lv0, ys, 2, pr, base_bits=4)
    return timeit(lambda x, y, k: add_radix(x, y, k, base_bits=4), ra, rb, ckr, iters=1) * 1e3 / s.n(64)


def _sort_radix(s: Suite) -> float:
    pr, skr, ckr = s.extra_keys("RADIX")
    svals = s.draws["sort_radix"]
    rcts = torch.stack([encrypt_radix(s.gen(90 + i), skr.lv0, np.array(int(v)), 2, pr, base_bits=3)
                        for i, v in enumerate(svals)])
    rsorted = sort_radix(rcts, ckr, base_bits=3)  # warm + correctness
    rgot = [int(decrypt_radix(rsorted[i], skr.lv0, base_bits=3)) for i in range(len(svals))]
    assert rgot == sorted(svals.tolist()), rgot
    t0 = time.perf_counter()
    barrier(sort_radix(rcts, ckr, base_bits=3))
    return (time.perf_counter() - t0) * 1e3


def _uint4_pbs(s: Suite) -> float:
    pu, sku, cku = s.extra_keys("UINT4")
    lb = LutBootstrap()
    m16 = s.draws["uint4"][: s.n(2048)]
    ctu = lwe_encrypt_message(s.gen(42), sku.lv0, m16, 16, pu.tlwe_lv0.alpha)
    return s.n(2048) / timeit(lambda x, k: lb.bootstrap_func(x, _times_three_plus_one_mod_16, 16, k), ctu, cku,
                              iters=2, carry=xor_into_body)


def _nibble_add(s: Suite) -> float:
    pb, skb, ckb = s.extra_keys("NIBBLE")
    xs, ys = (v[: s.n(64)] for v in s.draws["nibble"])
    na = encrypt_radix(s.gen(52), skb.lv0, xs, 2, pb, base_bits=4)
    nb = encrypt_radix(s.gen(53), skb.lv0, ys, 2, pb, base_bits=4)
    return timeit(lambda x, y, k: add_radix(x, y, k, base_bits=4), na, nb, ckb, iters=1) * 1e3 / s.n(64)


def _mul16(s: Suite) -> dict:
    """16 x 16-bit products, base 4, D = 8, both ways (scripts/bench_suite.py:444-463)."""
    pb, skb, ckb = s.extra_keys("NIBBLE")
    xs, ys = (v[: s.n(16)] for v in s.draws["mul16"])
    wa = encrypt_radix(s.gen(54), skb.lv0, xs, 8, pb, base_bits=2)
    wb = encrypt_radix(s.gen(55), skb.lv0, ys, 8, pb, base_bits=2)
    res = {}
    for mv, tag in ((False, ""), (True, "_mv")):
        got = decrypt_radix(mul_radix(wa, wb, ckb, base_bits=2, multi_value=mv), skb.lv0, base_bits=2)
        if mv:
            assert (got == xs * ys).all(), "mul16 mv correctness"
        else:
            assert (got == (xs * ys) & 0xFFFF).all() or (got == xs * ys).all(), "mul16 correctness"
        dt = timeit(lambda x, y, k: mul_radix(x, y, k, base_bits=2, multi_value=mv), wa, wb, ckb, iters=1)
        res[f"mul16x16_b16_NIBBLE{tag}"] = dt * 1e3 / s.n(16)
    return res


def _mul8(s: Suite) -> dict:
    """8 x 8-bit products, base 4, D = 4, both ways (scripts/bench_suite.py:466-477)."""
    pb, skb, ckb = s.extra_keys("NIBBLE")
    xs, ys = (v[: s.n(16)] for v in s.draws["mul8"])
    va = encrypt_radix(s.gen(56), skb.lv0, xs, 4, pb, base_bits=2)
    vb = encrypt_radix(s.gen(57), skb.lv0, ys, 4, pb, base_bits=2)
    res = {}
    for mv, tag in ((False, ""), (True, "_mv")):
        got = decrypt_radix(mul_radix(va, vb, ckb, base_bits=2, multi_value=mv), skb.lv0, base_bits=2)
        assert (got == xs * ys).all(), f"mul8 mv={mv} correctness"
        dt = timeit(lambda x, y, k: mul_radix(x, y, k, base_bits=2, multi_value=mv), va, vb, ckb, iters=1)
        res[f"mul8x8_b16_NIBBLE{tag}"] = dt * 1e3 / s.n(16)
    return res


def _strict_inputs(s: Suite, tag: str, multibit: bool = False):
    p, sk, ck = s.extra_keys(tag, multibit)
    _, ks, _ = EXTRA_KEYS[tag]
    a, b = s.enc_pair(s.draws[tag], seed=ks + 2, sk=sk, params=p)
    return sk, ck, a, b


def _strict_rate(s: Suite) -> float:
    _, cks, sa, sb = _strict_inputs(s, "STRICT")
    return sa.shape[0] / timeit(lambda x, y: gates.nand(x, y, cks), sa, sb, iters=3, carry=xor_into_body)


def _strict_latency(multibit: bool):
    def case(s: Suite) -> float:
        _, cks, sa, sb = _strict_inputs(s, "STRICT", multibit)
        return timeit_slope(lambda x, y: gates.nand(x, y, cks), sa[:1], sb[:1], carry=xor_into_body) * 1e3
    return case


def _other_set_rate(tag: str):
    """The 80- and 110-bit sets at their literal constants: every NAND of
    b and not b decrypts true, then the rate (scripts/bench_suite.py:507-521)."""
    def case(s: Suite) -> float:
        skz, ckz, za, zb = _strict_inputs(s, tag)
        assert bool(lwe_decrypt_bool(gates.nand(za, zb, ckz), skz.lv0).all()), tag
        return za.shape[0] / timeit(lambda x, y: gates.nand(x, y, ckz), za, zb, iters=3, carry=xor_into_body)
    return case


def _pick(fn, name: str):
    """A metric of a shared measurement."""
    def case(s: Suite):
        return s.shared(fn)[name]
    return case


#: (name, unit, function of a Suite -> value, or None where the set does not
#: have the case), in scripts/bench_suite.py's order; EXTRA from the first
#: of the other families on (RS_TFHE_BENCH_EXTRA=0 skips them)
CASES = [
    ("keygen_warm", "ms", lambda s: s.main_keys()[2]),
    ("gate_nand_b1_latency", "ms", lambda s: _b1_latency(s, s.main_keys()[1])),
    ("gate_nand_b1_latency_mb", "ms", _latency_mb),
    ("gate_nand_b128", "gates/s", _nand_rate(128)),
    ("gate_nand_b2048", "gates/s", _nand_rate(2048)),
    ("gate_nand_b4096", "gates/s", _nand_rate(4096)),
    ("gate_nand_b10240", "gates/s", _pick(_batch10k, "gate_nand_b10240")),
    ("gate_batch10k_wall", "ms", _pick(_batch10k, "gate_batch10k_wall")),
    ("six_gate_group_b2048", "gates/s", _six),
    ("mux_b1024", "mux/s", _mux),
    ("blind_rotate_b2048", "rot/s", _pick(_rotation_case, "blind_rotate_b2048")),
    ("keyswitch_b2048", "ops/s", _pick(_rotation_case, "keyswitch_b2048")),
    ("lut_bootstrap_b2048", "PBS/s", _lut),
    ("radix_add8_b64", "ms/add", _radix_add),
    ("external_product_step_b2048", "ops/s", _ext_step),
    ("nussbaumer_step_b2048", "ops/s", _nuss_step),
    ("circuit_rc_adder32_wall", "ms", _pick(_circuit, "circuit_rc_adder32_wall")),
    ("circuit_rc_adder32_wall_mb", "ms", _pick(_circuit, "circuit_rc_adder32_wall_mb")),
    ("circuit_rc_adder32_rate_mb", "gates/s", _pick(_circuit, "circuit_rc_adder32_rate_mb")),
    ("circuit_rc_adder32_gate_at_a_time_wall", "ms", _pick(_circuit, "circuit_rc_adder32_gate_at_a_time_wall")),
    ("circuit_rc_adder32_wall_jit_mb", "ms", _pick(_circuit, "circuit_rc_adder32_wall_jit_mb")),
    ("circuit_rc_adder32_rate_jit_mb", "gates/s", _pick(_circuit, "circuit_rc_adder32_rate_jit_mb")),
    ("kogge_stone_add32_wall", "ms", _kogge_stone),
    ("sort8x8bit_gates_wall", "ms", _sort_bits),
    ("proxy_hop_b4096", "hops/s", _proxy),
    ("radix_nibble_add8_b64_RADIX", "ms/add", _radix_nibble_add),
    ("sort8_radix_wall_RADIX", "ms", _sort_radix),
    ("uint4_pbs_b2048", "PBS/s", _uint4_pbs),
    ("nibble_add8_3pbs_b64_NIBBLE", "ms/add", _nibble_add),
    ("mul16x16_b16_NIBBLE", "ms/mul", _pick(_mul16, "mul16x16_b16_NIBBLE")),
    ("mul16x16_b16_NIBBLE_mv", "ms/mul", _pick(_mul16, "mul16x16_b16_NIBBLE_mv")),
    ("mul8x8_b16_NIBBLE", "ms/mul", _pick(_mul8, "mul8x8_b16_NIBBLE")),
    ("mul8x8_b16_NIBBLE_mv", "ms/mul", _pick(_mul8, "mul8x8_b16_NIBBLE_mv")),
    ("gate_nand_b4096_STRICT", "gates/s", _strict_rate),
    ("gate_nand_b1_latency_STRICT", "ms", _strict_latency(False)),
    ("gate_nand_b1_latency_STRICT_mb", "ms", _strict_latency(True)),
    ("gate_nand_b4096_80BIT", "gates/s", _other_set_rate("80BIT")),
    ("gate_nand_b4096_110BIT", "gates/s", _other_set_rate("110BIT")),
]
NAMES = [name for name, _, _ in CASES]
EXTRA = NAMES[NAMES.index("radix_nibble_add8_b64_RADIX"):]


def run_cases(suite: Suite, names=None) -> list:
    """The rows of `names` (default: every case, the EXTRA ones unless
    RS_TFHE_BENCH_EXTRA=0), in CASES order: {name, value, unit, kernels:
    the launches the case made}. A case the set does not have gives no row."""
    if names is None:
        names = [n for n in NAMES if os.environ.get("RS_TFHE_BENCH_EXTRA", "1") == "1" or n not in EXTRA]
    unknown = set(names) - set(NAMES)
    if unknown:
        raise ValueError(f"unknown metrics {sorted(unknown)}; see --list")
    rows = []
    for name, unit, fn in CASES:
        if name not in names:
            continue
        before = launches()
        t0 = time.perf_counter()
        value = fn(suite)
        if value is None:
            log(f"  {name}: not measured at {suite.pname}")
            continue
        row = {"name": name, "value": round(value, 3), "unit": unit, "kernels": launched_since(before)}
        log(f"  {name}: {value:.3f} {unit} (kernels {row['kernels']}) [wall {time.perf_counter() - t0:.1f}s]")
        rows.append(row)
    return rows


def merge(path: str, pname: str, rows: list, fields: dict) -> dict:
    """Put `rows` into the artifact at `path` by name (a metric measured
    again replaces its row), in CASES order, with this call's card beside
    each row, the latency table of LATENCY_SWEEP_torch_h100.json beside it
    when that exists, and write it back."""
    art = load_json(path)
    stamp = {"device": fields["device"], "power_limit": fields["power_limit"], "ts": time.time()}
    by_name = {r["name"]: r for r in art.get("metrics", [])}
    by_name.update({r["name"]: {**r, **stamp} for r in rows})
    art.update({k: v for k, v in fields.items()}, params=pname,
               metrics=[by_name[n] for n in NAMES if n in by_name])
    sweep = load_json(os.path.join(os.path.dirname(os.path.abspath(path)), os.path.basename(SWEEP)))
    if sweep:
        art["latency_vs_batch"] = sweep["rows"]
    write_json(path, art)
    return art


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--only", help="comma-separated metric names (default: all)")
    ap.add_argument("--list", action="store_true", help="print the metric names and units, run nothing")
    ap.add_argument("--out", help="the artifact (default: BENCH_SUITE_torch_h100.json at the repo root on the card)")
    args = ap.parse_args(argv)
    if args.list:
        for name, unit, _ in CASES:
            print(f"{name}\t{unit}")
        return 0
    device = device_of(args.cpu)
    pname = os.environ.get("RS_TFHE_BENCH_PARAMS", "SECURITY_128_BIT_FAST")
    fields = card_fields(device)
    log(f"device={fields['device']} power limit {fields['power_limit']} params={pname}")
    rows = run_cases(Suite(device, pname), args.only.split(",") if args.only else None)
    out = args.out or (OUT if device.type == "cuda" else None)
    if out:
        merge(out, pname, rows, fields)
        log(f"merged {len(rows)} rows into {out}")
    print(json.dumps({**fields, "params": pname, "metrics": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
