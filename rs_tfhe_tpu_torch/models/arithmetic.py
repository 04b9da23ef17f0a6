"""Radix (LUT-based) homomorphic integer arithmetic, as
rs_tfhe_tpu/models/arithmetic.py computes it, bit for bit.

Integers are vectors of base-2^b digits, LSB first, int32 [..., D, n0+1],
each digit an LWE message encoded with modulus 2^(b+1) so that one digit can
absorb a carry without wrapping. Every operation is a short sequence of
batched programmable bootstraps (`bootstrap_with_testvec`,
`multi_value_bootstrap`); per-ciphertext test vectors let one blind rotation
apply different LUTs to different ciphertexts.

Which rotation a batch takes decides the ciphertext that comes out: with a
multi-bit key, `blind_rotate` sends batches of at most `mb_route_batch_cap`
ciphertexts through the multi-bit rotation. So every function here stacks,
concatenates and flattens its ciphertexts exactly as the JAX package does,
which gives the same batch sizes and the same order within a batch.

The LUT families are built on the host once per (base_bits, parameter set)
and moved to each device once (`_cached_tables`); everything else runs on
the inputs' device. The seeded transport (`encrypt_radix_seeded`,
`expand_radix_seeded`) ships one word a digit.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..bootstrap import bootstrap, bootstrap_with_testvec
from ..key import CloudKey
from ..lut.generator import Generator
from ..lut.multi_value import MultiValueLuts, factor_test_vectors, multi_value_bootstrap
from ..tlwe import (
    lwe_decrypt_message,
    lwe_encrypt_message,
    lwe_encrypt_torus_seeded,
    lwe_expand_seeded,
    lwe_trivial_message,
    message_mu,
)
from ..torus import f64_to_torus, i32
from ..utils.profiling import counter, span

#: Radix operations called in this process, by name ("add", "sub",
#: "compare", "mul"); each runs inside the span `tfhe.radix.<name>`.
radix_ops = counter("radix.ops", ("add", "sub", "compare", "mul"))

#: mul_radix's column stage in this process: "column_calls" (its
#: programmable bootstraps, those of the normalization rounds included) and
#: "norm_rounds" (the normalization rounds).
radix_mul = counter("radix.mul", ("column_calls", "norm_rounds"))


def _radix_op(name: str):
    """Count each call of the decorated operation under `name` and run it
    inside its span (`__wrapped__`: the operation uncounted, outside it)."""
    span_name = f"tfhe.radix.{name}"

    def wrap(fn):
        @functools.wraps(fn)
        def counted(*args, **kwargs):
            radix_ops[name] += 1
            with span(span_name):
                return fn(*args, **kwargs)

        return counted

    return wrap


def _digits_of(val, num_digits: int, base_bits: int) -> np.ndarray:
    """[..., num_digits] base-2^base_bits digits of an integer array, LSB first."""
    val = np.asarray(val)
    return np.stack(
        [(val >> (base_bits * i)) & ((1 << base_bits) - 1) for i in range(num_digits)], axis=-1
    )


def encrypt_radix(generator, sk_lv0: torch.Tensor, val, num_digits: int, params, base_bits: int = 3):
    """Encrypt integers as [..., num_digits, n0+1] base-2^base_bits digit
    vectors (LSB first), encoded with message modulus 2^(base_bits+1), on the
    key's device."""
    modulus = 1 << (base_bits + 1)
    return lwe_encrypt_message(
        generator, sk_lv0, _digits_of(val, num_digits, base_bits), modulus, params.tlwe_lv0.alpha
    )


def encrypt_radix_seeded(
    generator, mask_key, sk_lv0: torch.Tensor, val, num_digits: int, params, base_bits: int = 3
) -> tuple[torch.Tensor, torch.Tensor]:
    """Seeded (compressed) radix encryption, one word a digit on the wire
    (rs_tfhe_tpu/models/arithmetic.py:53-83): the digits of `encrypt_radix`,
    flattened row-major onto the mask stream of `mask_key` (digit d of value
    i is stream row i*D+d, the native client's `lwe_expand_seeded` layout),
    the noise from `generator`. Returns (seed int32 [2], bodies int32
    [..., num_digits]); the server expands with `expand_radix_seeded`."""
    mu = message_mu(_digits_of(val, num_digits, base_bits), 1 << (base_bits + 1), sk_lv0.device)
    seed, bodies = lwe_encrypt_torus_seeded(generator, mask_key, sk_lv0, mu.reshape(-1), params.tlwe_lv0.alpha)
    return seed, bodies.reshape(mu.shape)


def expand_radix_seeded(seed, bodies: torch.Tensor, n: int) -> torch.Tensor:
    """Server side: (seed, bodies [..., D]) -> digit vectors [..., D, n+1]."""
    return lwe_expand_seeded(seed, bodies.reshape(-1), n).reshape(*bodies.shape, n + 1)


def decrypt_radix(ct: torch.Tensor, sk_lv0: torch.Tensor, base_bits: int = 3) -> np.ndarray:
    """Decrypt [..., D, n0+1] digit vectors back to integers (int64 numpy,
    D * base_bits up to 63 bits)."""
    modulus = 1 << (base_bits + 1)
    digits = lwe_decrypt_message(ct, sk_lv0, modulus)
    val = np.zeros(digits.shape[:-1], dtype=np.int64)
    for i in range(digits.shape[-1]):
        val |= (digits[..., i] & ((1 << base_bits) - 1)) << (base_bits * i)
    return val


# ---------------------------------------------------------------------------
# LUT families: host-built once, moved to each device once
# ---------------------------------------------------------------------------

def _to_device(tables, device: torch.device):
    if isinstance(tables, torch.Tensor):
        return tables.to(device)
    if isinstance(tables, MultiValueLuts):
        return dataclasses.replace(tables, tv0=tables.tv0.to(device))
    return {k: _to_device(v, device) for k, v in tables.items()}


def _cached_tables(build):
    """`build(base_bits, params)` -> tables on the host, as
    `f(base_bits, params, device)` -> the same tables on `device`
    (`f.host(base_bits, params)`: the host tables). Both levels are cached
    (64 entries each, as the JAX package's lru_caches), so a family is built
    once and copied to a device once; a table cached for one device never
    serves another. Callers must not write into them."""
    host = functools.lru_cache(maxsize=64)(build)

    @functools.lru_cache(maxsize=64)
    def on_device(base_bits: int, params, device: torch.device):
        return _to_device(host(base_bits, params), device)

    @functools.wraps(build)
    def tables(base_bits: int, params, device):
        return on_device(base_bits, params, torch.device(device))

    tables.host = host
    return tables


def _raw(value: int, modulus: int) -> int:
    """Raw torus encoding value/(2*modulus) as an int in [0, 2^32)."""
    return value * (1 << 32) // (2 * modulus) % (1 << 32)


def _bool_raw(flag: bool) -> int:
    """Raw torus of a gate-encoded boolean (+/- 1/8)."""
    mu = int(f64_to_torus(0.125))
    return mu if flag else (1 << 32) - mu


def _full(gen: Generator, f) -> torch.Tensor:
    return gen.generate_lookup_table_full(f).poly


@_cached_tables
def _add_luts(base_bits: int, params) -> dict:
    """add_radix's (sum, carry) and sub_radix's complement test vectors."""
    base = 1 << base_bits
    gen = Generator(2 * base, params)
    return {
        "mod": gen.generate_lookup_table(lambda x: x % base).poly,
        "div": gen.generate_lookup_table(lambda x: x // base).poly,
        "comp": gen.generate_lookup_table(lambda v: (base - 1 - v) % base).poly,
    }


@_cached_tables
def _add_mv(base_bits: int, params) -> MultiValueLuts:
    """Factored (sum, carry) test-vector family for multi-value add."""
    luts = _add_luts.host(base_bits, params)
    return factor_test_vectors([luts["mod"], luts["div"]])


@_cached_tables
def _mul_luts(base_bits: int, params) -> dict:
    """mul_radix's test vectors: stage 1 re-encodes (input modulus 2^(b+1)),
    stage 2 the bivariate lo/hi products (input modulus base^2), stage 3 the
    column splits (input modulus 2*base^2)."""
    base = 1 << base_bits
    m_pair, m_col, m_enc = base * base, 2 * base * base, 1 << (base_bits + 1)
    gen_enc, gen_pair, gen_col = Generator(m_enc, params), Generator(m_pair, params), Generator(m_col, params)
    return {
        "a": _full(gen_enc, lambda v: _raw(v % base, base)),
        "b": _full(gen_enc, lambda v: _raw(v % base, m_pair)),
        "lo": _full(gen_pair, lambda w: _raw((w // base) * (w % base) % base, m_col)),
        "hi": _full(gen_pair, lambda w: _raw((w // base) * (w % base) // base, m_col)),
        "dig": _full(gen_col, lambda t: _raw(t % base, m_enc)),
        "car": _full(gen_col, lambda t: _raw((t % m_col) // base, m_col)),
        # normalization digit: back at the COLUMN scale so it re-enters the sum
        "dig_col": _full(gen_col, lambda t: _raw(t % base, m_col)),
    }


@_cached_tables
def _mul_mv(base_bits: int, params) -> dict:
    """Factored test vectors for multi-value mul_radix: only stage 2's
    (lo, hi) pair shares a rotation; the JAX package measured the column
    stage's factoring norms against its noise model and refused them
    (rs_tfhe_tpu/models/arithmetic.py:243-270)."""
    luts = _mul_luts.host(base_bits, params)
    return {"pair": factor_test_vectors([luts["lo"], luts["hi"]])}


@_radix_op("add")
def add_radix(a: torch.Tensor, b: torch.Tensor, ck: CloudKey, base_bits: int = 3,
              carry_in: torch.Tensor | None = None, multi_value: bool = False) -> torch.Tensor:
    """Digit-vector addition, 2D - 1 programmable bootstraps for D digits.

    a, b: int32 [..., D, n0+1]. The linear ciphertext add gives the raw digit
    sum in [0, 2^(b+1)); one PBS extracts sum mod 2^b and a second, in the
    same blind rotation, the carry. carry_in: an optional [..., n0+1]
    ciphertext of 0 or 1 added into digit 0 (sub_radix's +1).
    multi_value=True runs each digit's (sum, carry) pair through one blind
    rotation (lut.multi_value): D rotations instead of 2D - 1, the same
    decoded results. Margins as rs_tfhe_tpu/models/arithmetic.py:112-142.
    """
    d = a.shape[-2]
    carry = carry_in
    outs = []
    if multi_value:
        mv = _add_mv(base_bits, ck.params, a.device)
        for i in range(d):
            s = a[..., i, :] + b[..., i, :]
            if carry is not None:
                s = s + carry
            res = multi_value_bootstrap(s, mv, ck)  # [..., 2, n0+1]
            outs.append(res[..., 0, :])
            carry = res[..., 1, :]
        return torch.stack(outs, dim=-2)
    luts = _add_luts(base_bits, ck.params, a.device)
    pair_tv = torch.stack([luts["mod"], luts["div"]])  # [2, 2, N]
    for i in range(d):
        s = a[..., i, :] + b[..., i, :]
        if carry is not None:
            s = s + carry
        if i + 1 < d:
            pair = torch.stack([s, s], dim=-2)  # [..., 2, n0+1]
            res = bootstrap_with_testvec(pair, pair_tv.expand(*s.shape[:-1], *pair_tv.shape), ck)
            outs.append(res[..., 0, :])
            carry = res[..., 1, :]
        else:
            outs.append(bootstrap_with_testvec(s, luts["mod"], ck))
    return torch.stack(outs, dim=-2)


@_radix_op("sub")
def sub_radix(a: torch.Tensor, b: torch.Tensor, ck: CloudKey, base_bits: int = 3,
              multi_value: bool = False) -> torch.Tensor:
    """Digit-vector subtraction a - b (mod base^D) in 2D programmable
    bootstraps: a + (base^D - 1 - b) + 1, the radix complement digit-wise in
    one batched PBS, the +1 through add_radix's carry_in."""
    modulus = 2 << base_bits
    comp_tv = _add_luts(base_bits, ck.params, b.device)["comp"]
    comp = bootstrap_with_testvec(b, comp_tv.expand(*b.shape[:-1], *comp_tv.shape), ck)
    one = lwe_trivial_message(
        torch.ones(a.shape[:-2], dtype=torch.int64, device=a.device), modulus, a.shape[-1] - 1, a.device
    )
    return add_radix.__wrapped__(a, comp, ck, base_bits, carry_in=one, multi_value=multi_value)


def apply_lut_radix(ct: torch.Tensor, f, ck: CloudKey, base_bits: int = 3) -> torch.Tensor:
    """Apply a per-digit function via one batched programmable bootstrap over
    all digit positions (and any outer batch) at once. The table is built
    for `f` on each call, as the JAX package builds it."""
    lut = Generator(2 << base_bits, ck.params).generate_lookup_table(f).poly
    return bootstrap_with_testvec(ct, lut.to(ct.device), ck)


def _col_bounds(d: int, base: int) -> list[int]:
    """Exact worst-case column-sum bounds for mul_radix's carry-save stage:
    column k sums (base-1)-valued lo products (i+j=k), hi products
    (i+j=k-1) and the incoming carry."""
    def n_pairs(k):
        return max(0, min(k, d - 1) - max(0, k - d + 1) + 1)

    bounds, carry = [], 0
    for k in range(2 * d):
        t = (base - 1) * (n_pairs(k) + n_pairs(k - 1)) + carry
        bounds.append(t)
        carry = t // base
    return bounds


def _greedy_chunks(terms, cap_val: int, cap_terms: int):
    """Split [(ct, maxval), ...] into chunks whose summed maxval <= cap_val
    and term count <= cap_terms."""
    chunks, cur, curmax = [], [], 0
    for ct, mx in terms:
        if cur and (curmax + mx > cap_val or len(cur) >= cap_terms):
            chunks.append((cur, curmax))
            cur, curmax = [], 0
        cur.append(ct)
        curmax += mx
    chunks.append((cur, curmax))
    return chunks


def _sum(cts: list) -> torch.Tensor:
    s = cts[0]
    for c in cts[1:]:
        s = s + c
    return s


def _per_ct(polys: list, lead_shapes: list) -> torch.Tensor:
    """Per-ciphertext test vectors: poly k expanded over lead_shapes[k]
    ([..., C_k]) and concatenated along the ciphertext axis -> [..., sum C_k, 2, N]."""
    return torch.cat([p.expand(*lead, *p.shape) for p, lead in zip(polys, lead_shapes)], dim=-3)


@_radix_op("mul")
def mul_radix(a: torch.Tensor, b: torch.Tensor, ck: CloudKey, base_bits: int = 2,
              multi_value: bool = False) -> torch.Tensor:
    """Ciphertext x ciphertext multiplication over base-2^b digit vectors:
    a, b int32 [..., D, n0+1] -> the full 2D-digit product.

      1. re-encode (one batched PBS over 2D ciphertexts) so that base*a_i +
         b_j is a modulus-base^2 encoding of the digit pair;
      2. the bivariate lo/hi products of all D^2 pairs (one batched PBS of
         2D^2 ciphertexts; D^2 with multi_value=True, which factors the pair
         through one rotation);
      3. carry-save columns, LSB first, with greedy normalization rounds
         where a column's worst case exceeds the modulus-2*base^2 range.

    2D^2 + 6D programmable bootstraps without normalization. Margins as
    rs_tfhe_tpu/models/arithmetic.py:273-320. The three stages run inside
    the spans `tfhe.radix.mul.encode`, `.pairs` and `.columns`; the column
    stage counts its calls and rounds in `radix_mul`.
    """
    d, n = a.shape[-2], a.shape[-1]
    base = 1 << base_bits
    m_col = 2 * base * base
    max_chunk_terms = 8
    luts = _mul_luts(base_bits, ck.params, a.device)

    # stage 1: re-encode digits for pairing
    with span("tfhe.radix.mul.encode"):
        both = torch.cat([a, b], dim=-2)  # [..., 2D, n+1]
        enc = bootstrap_with_testvec(both, _per_ct([luts["a"], luts["b"]], [a.shape[:-1], b.shape[:-1]]), ck)
        a2, b2 = enc[..., :d, :], enc[..., d:, :]

    # stage 2: all D^2 pairs, lo/hi products via per-ciphertext LUTs
    with span("tfhe.radix.mul.pairs"):
        pairs = a2[..., :, None, :] + b2[..., None, :, :]  # [..., D, D, n+1]
        pairs = pairs.reshape(*pairs.shape[:-3], d * d, n)
        if multi_value:
            prod = multi_value_bootstrap(pairs, _mul_mv(base_bits, ck.params, a.device)["pair"], ck)
            lo = prod[..., 0, :].reshape(*a.shape[:-2], d, d, n)
            hi = prod[..., 1, :].reshape(*a.shape[:-2], d, d, n)
        else:
            pp = torch.cat([pairs, pairs], dim=-2)  # lo block then hi block
            prod = bootstrap_with_testvec(pp, _per_ct([luts["lo"], luts["hi"]], [pairs.shape[:-1]] * 2), ck)
            lo = prod[..., : d * d, :].reshape(*a.shape[:-2], d, d, n)
            hi = prod[..., d * d :, :].reshape(*a.shape[:-2], d, d, n)

    # stage 3: column carry-save with normalization (input modulus m_col)
    with span("tfhe.radix.mul.columns"):
        pmax = base - 1
        terms = [[] for _ in range(2 * d + 1)]  # [(ct, worst-case value)]
        for i in range(d):
            for j in range(d):
                terms[i + j].append((lo[..., i, j, :], pmax))
                terms[i + j + 1].append((hi[..., i, j, :], pmax))
        pair_tv = torch.stack([luts["dig"], luts["car"]])
        outs = []
        for k in range(2 * d):
            tk = terms[k]
            while True:
                chunks = _greedy_chunks(tk, m_col - 1, max_chunk_terms)
                if len(chunks) == 1:
                    break
                # one batched per-ct-LUT PBS re-splits every chunk into a
                # column-scale digit (re-enters this column) and a carry
                radix_mul["norm_rounds"] += 1
                radix_mul["column_calls"] += 1
                cs = torch.stack([_sum(ct_list) for ct_list, _ in chunks], dim=-2)  # [..., C, n0+1]
                n_c = len(chunks)
                cc = torch.cat([cs, cs], dim=-2)
                res = bootstrap_with_testvec(cc, _per_ct([luts["dig_col"], luts["car"]], [cs.shape[:-1]] * 2), ck)
                tk = [(res[..., i, :], pmax) for i in range(n_c)]
                terms[k + 1].extend((res[..., n_c + i, :], chunks[i][1] // base) for i in range(n_c))
            chunk_cts, total = chunks[0]
            s = _sum(chunk_cts)
            radix_mul["column_calls"] += 1
            if k + 1 < 2 * d and total >= base:
                pair = torch.stack([s, s], dim=-2)
                res = bootstrap_with_testvec(pair, pair_tv.expand(*s.shape[:-1], *pair_tv.shape), ck)
                outs.append(res[..., 0, :])
                terms[k + 1].append((res[..., 1, :], total // base))
            else:
                outs.append(bootstrap_with_testvec(s, luts["dig"], ck))
    return torch.stack(outs, dim=-2)


# ---------------------------------------------------------------------------
# Comparisons and selection over radix digit vectors
# ---------------------------------------------------------------------------

_TRI_MOD = 16  # combine-stage modulus: w = 3*t_hi + t_lo in [0, 9) < 16


def _tri(v: int, base: int) -> int:
    """Trichotomy of the shifted digit difference v = a_i - b_i + base:
    0 = equal, 1 = a > b, 2 = a < b."""
    return 0 if v == base else (1 if v > base else 2)


def _tri_combine(w: int) -> int:
    """Merge two trichotomies packed as w = 3*t_hi + t_lo: the higher digit
    wins unless it says equal."""
    q = w // 3
    return q if q else w % 3


@_cached_tables
def _cmp_luts(base_bits: int, params) -> dict:
    """compare_radix's test vectors."""
    base = 1 << base_bits
    gen_in = Generator(2 * base, params)
    gen_w = Generator(_TRI_MOD, params)

    def t(v):
        return _tri(v, base)

    return {
        # leaf stage: shifted difference (modulus 2*base) -> trichotomy at
        # the two combine scales (3t and t, modulus 16)
        "leaf_e3": _full(gen_in, lambda v: _raw(3 * t(v), _TRI_MOD)),
        "leaf_e1": _full(gen_in, lambda v: _raw(t(v), _TRI_MOD)),
        # tree stage: w = 3*t_hi + t_lo -> merged trichotomy, same scales
        "comb_e3": _full(gen_w, lambda w: _raw(3 * _tri_combine(w), _TRI_MOD)),
        "comb_e1": _full(gen_w, lambda w: _raw(_tri_combine(w), _TRI_MOD)),
        # final stages: trichotomy -> (eq, gt, lt) gate-encoded booleans
        "leaf_bool": torch.stack([_full(gen_in, lambda v, k=k: _bool_raw(t(v) == k)) for k in range(3)]),
        "comb_bool": torch.stack([_full(gen_w, lambda w, k=k: _bool_raw(_tri_combine(w) == k)) for k in range(3)]),
    }


@_cached_tables
def _cmp_mv(base_bits: int, params) -> dict:
    """Factored test-vector families for multi-value compare_radix."""
    luts = _cmp_luts.host(base_bits, params)
    return {
        "leaf": factor_test_vectors([luts["leaf_e3"], luts["leaf_e1"]]),
        "comb": factor_test_vectors([luts["comb_e3"], luts["comb_e1"]]),
        "leaf_bool": factor_test_vectors(list(luts["leaf_bool"])),
        "comb_bool": factor_test_vectors(list(luts["comb_bool"])),
    }


@_radix_op("compare")
def compare_radix(a: torch.Tensor, b: torch.Tensor, ck: CloudKey, base_bits: int = 3,
                  multi_value: bool = False):
    """Encrypted comparison of two radix digit vectors: the triple
    (eq, gt, lt) of gate-encoded boolean ciphertexts [..., n0+1], gt meaning
    a > b.

    An MSB-first trichotomy tree: one batched PBS maps each digit's shifted
    difference a_i - b_i + base to its verdict at two torus scales, so that
    the linear sum w = 3*t_hi + t_lo of adjacent nodes feeds one combine LUT
    per level; the last level emits all three booleans from one rotation.
    1 + ceil(log2 D) batched blind rotations. multi_value=True factors each
    stage's test vectors through one rotation.
    """
    d = a.shape[-2]
    luts = _cmp_luts(base_bits, ck.params, a.device)
    mvs = _cmp_mv(base_bits, ck.params, a.device) if multi_value else None
    diff = a - b
    # + base at the modulus-2*base scale = + base/(4*base) = exactly 1/4
    diff[..., -1] += 1 << 30

    def _three(ct, polys, mv):
        if multi_value:
            res = multi_value_bootstrap(ct, mv, ck)  # [..., 3, n0+1]
        else:
            trip = torch.stack([ct, ct, ct], dim=-2)
            res = bootstrap_with_testvec(trip, polys.expand(*ct.shape[:-1], *polys.shape), ck)
        return res[..., 0, :], res[..., 1, :], res[..., 2, :]

    if d == 1:
        return _three(diff[..., 0, :], luts["leaf_bool"], mvs["leaf_bool"] if multi_value else None)

    if multi_value:
        res = multi_value_bootstrap(diff, mvs["leaf"], ck)  # [..., D, 2, n0+1]
        nodes = [(res[..., i, 0, :], res[..., i, 1, :]) for i in range(d)]
    else:
        both = torch.cat([diff, diff], dim=-2)  # [..., 2D, n0+1]
        res = bootstrap_with_testvec(both, _per_ct([luts["leaf_e3"], luts["leaf_e1"]], [diff.shape[:-1]] * 2), ck)
        # (e3, e1) per digit, LSB first
        nodes = [(res[..., i, :], res[..., d + i, :]) for i in range(d)]

    while True:
        ws = [nodes[i + 1][0] + nodes[i][1] for i in range(0, len(nodes) - 1, 2)]
        leftover = [nodes[-1]] if len(nodes) % 2 else []
        if len(ws) == 1 and not leftover:
            return _three(ws[0], luts["comb_bool"], mvs["comb_bool"] if multi_value else None)
        stack_w = torch.stack(ws, dim=-2)
        k = len(ws)
        if multi_value:
            res = multi_value_bootstrap(stack_w, mvs["comb"], ck)
            nodes = [(res[..., i, 0, :], res[..., i, 1, :]) for i in range(k)] + leftover
            continue
        both = torch.cat([stack_w, stack_w], dim=-2)
        res = bootstrap_with_testvec(
            both, _per_ct([luts["comb_e3"], luts["comb_e1"]], [stack_w.shape[:-1]] * 2), ck
        )
        nodes = [(res[..., i, :], res[..., k + i, :]) for i in range(k)] + leftover


@_cached_tables
def _sel_luts(base_bits: int, params) -> dict:
    """select_radix's test vectors (input modulus 2*base)."""
    base = 1 << base_bits
    m = 2 * base
    gen = Generator(m, params)
    return {
        # w = base*sel + digit: keep the branch its mask selects, else 0
        "take": _full(gen, lambda w: _raw(w - base, m) if w >= base else 0),
        "drop": _full(gen, lambda w: 0 if w >= base else _raw(w, m)),
        "ident": _full(gen, lambda v: _raw(v % base, m)),
    }


def select_radix(sel: torch.Tensor, t: torch.Tensor, f: torch.Tensor, ck: CloudKey,
                 base_bits: int = 3, refresh: bool = True) -> torch.Tensor:
    """Encrypted select over radix digit vectors: sel ? t : f, element-wise.

    sel: a gate-encoded boolean ciphertext [..., n0+1]; t, f: [..., D, n0+1].
    Three batched blind rotations: a gate bootstrap turns sel into a
    {0, 1/4} mask; per-digit bivariate LUTs on w = base*sel + digit zero the
    unselected branch, so the sum of the two masked branches is the selected
    digit; an identity PBS refreshes it (refresh=False skips it).
    """
    d = t.shape[-2]
    luts = _sel_luts(base_bits, ck.params, t.device)
    mask = bootstrap(sel, ck)  # +/- 1/8
    mask[..., -1] += i32(int(f64_to_torus(0.125)))  # {0, 1/4}
    wt = t + mask[..., None, :]
    wf = f + mask[..., None, :]
    both = torch.cat([wt, wf], dim=-2)
    res = bootstrap_with_testvec(both, _per_ct([luts["take"], luts["drop"]], [wt.shape[:-1], wf.shape[:-1]]), ck)
    out = res[..., :d, :] + res[..., d:, :]
    if refresh:
        out = bootstrap_with_testvec(out, luts["ident"], ck)
    return out


def min_radix(a: torch.Tensor, b: torch.Tensor, ck: CloudKey, base_bits: int = 3,
              multi_value: bool = False) -> torch.Tensor:
    """Encrypted min of two radix digit vectors (compare + select)."""
    _, _, lt = compare_radix(a, b, ck, base_bits, multi_value=multi_value)
    return select_radix(lt, a, b, ck, base_bits)


def max_radix(a: torch.Tensor, b: torch.Tensor, ck: CloudKey, base_bits: int = 3,
              multi_value: bool = False) -> torch.Tensor:
    """Encrypted max of two radix digit vectors (compare + select)."""
    _, _, lt = compare_radix(a, b, ck, base_bits, multi_value=multi_value)
    return select_radix(lt, b, a, ck, base_bits)


# ---------------------------------------------------------------------------
# Radix <-> bit-level conversion
# ---------------------------------------------------------------------------

@_cached_tables
def _cast_luts(base_bits: int, params) -> dict:
    """radix <-> bits test vectors (input modulus 2*base)."""
    base = 1 << base_bits
    m = 2 * base
    gen = Generator(m, params)
    return {
        # digit -> its j-th bit as a gate-encoded boolean
        "bits": torch.stack([
            _full(gen, lambda v, j=j: _bool_raw(((v % base) >> j) & 1)) for j in range(base_bits)
        ]),
        "ident": _full(gen, lambda v: _raw(v % base, m)),
    }


def radix_to_bits(ct: torch.Tensor, ck: CloudKey, base_bits: int = 3) -> torch.Tensor:
    """Radix digit vectors [..., D, n0+1] -> gate-encoded bit vectors
    [..., D*base_bits, n0+1] (LSB first, bit_utils layout) in one batched
    blind rotation: each digit repeated base_bits times against a
    per-ciphertext bit-extraction LUT."""
    d = ct.shape[-2]
    bits_tv = _cast_luts(base_bits, ck.params, ct.device)["bits"]
    rep = torch.repeat_interleave(ct, base_bits, dim=-2)  # [..., D*b, n0+1]
    tvs = bits_tv.repeat(d, 1, 1)  # [D*b, 2, N]
    return bootstrap_with_testvec(rep, tvs.expand(*rep.shape[:-2], *tvs.shape), ck)


def bits_to_radix(bits: torch.Tensor, ck: CloudKey, base_bits: int = 3,
                  num_digits: int | None = None) -> torch.Tensor:
    """Gate-encoded bit vectors [..., W, n0+1] (LSB first) -> radix digit
    vectors [..., ceil(W/b), n0+1] in two batched blind rotations: each bit
    against a constant test vector of amplitude encode(2^j)/2 plus a trivial
    shift gives a {0, encode(2^j)} mask; each digit's sum of its masks is
    refreshed by one identity PBS."""
    w = bits.shape[-2]
    n1 = ck.params.n1
    d = num_digits if num_digits is not None else -(-w // base_bits)
    if w > d * base_bits:
        raise ValueError(f"{w} bits do not fit {d} base-2^{base_bits} digits")
    dev = bits.device
    ident = _cast_luts(base_bits, ck.params, dev)["ident"]

    # amplitude c_j = encode(2^j)/2 = 2^(30-base_bits+j-1): the +/-c sign
    # output plus the trivial +c shift lands exactly on {0, encode(2^j)}
    cs = [1 << (30 + j - (base_bits + 1)) for j in range(base_bits)]
    tv_js = torch.zeros((base_bits, 2, n1), dtype=torch.int32, device=dev)
    tv_js[:, 1, :] = torch.tensor([i32(c) for c in cs], dtype=torch.int32, device=dev)[:, None]
    order = torch.arange(w, device=dev) % base_bits
    tvs = tv_js[order]  # [W, 2, N]
    masks = bootstrap_with_testvec(bits, tvs.expand(*bits.shape[:-2], *tvs.shape), ck)  # +/- c_j
    masks[..., -1] += tv_js[order, 1, 0]  # broadcast over the bit axis

    # per-digit linear sums (the top digit's missing bits add nothing)
    digits = [_sum([masks[..., k, :] for k in range(i * base_bits, min((i + 1) * base_bits, w))])
              for i in range(d)]
    return bootstrap_with_testvec(torch.stack(digits, dim=-2), ident, ck)


def shift_digits(ct: torch.Tensor, k: int, base_bits: int = 3) -> torch.Tensor:
    """Multiply (k > 0) or divide (k < 0) by base^k mod base^D: digit-row
    moves with trivial zero digits, no bootstrap."""
    d, n = ct.shape[-2], ct.shape[-1]
    if k == 0:
        return ct
    zeros = torch.zeros((*ct.shape[:-2], min(abs(k), d), n), dtype=ct.dtype, device=ct.device)
    if k > 0:
        return torch.cat([zeros, ct[..., : max(d - k, 0), :]], dim=-2)
    return torch.cat([ct[..., min(-k, d):, :], zeros], dim=-2)
