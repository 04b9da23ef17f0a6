"""The plain reference of the timed product: ciphertext x ciphertext
multiplication of radix digit vectors in plain PyTorch, written from the
published description of the three-stage product (the JAX package's
`models.arithmetic.mul_radix` docstring and examples/ciphertext_multiply.py:
re-encode, bivariate digit products through per-ciphertext LUTs, carry-save
columns with greedy normalization) and the configuration file's numbers
alone.

It imports nothing of the program, as reference.py and reference_lut.py,
whose LUT bootstrap it calls (`reference_lut.lut_bootstrap`: the rotation,
the extract and the key switch in float64, each sum checked below 2^53; at
N=4096, L=3, Bg=2^8 a product sums 6 * 4096 digits of |d| <= 128 by 32-bit
words, below 2^52.6). What it adds, for digits of b bits (base = 2^b):

  testvec_raw(f, m) = the trivial TRLWE (0, v) of rs-tfhe's full-table
      generator (lut/generator.rs:146-194): v[i] = f(x), a raw torus word,
      on the box of x, i in [x*N/m, (x+1)*N/m) rounded, rotated left by
      N/(2m), the N/(2m) coefficients that wrap negated;
  raw(v, m) = v * 2^32 / (2m): message v at modulus m;
  the tables, with m_enc = 2^(b+1), m_pair = base^2, m_col = 2 base^2:
      stage 1 at m_enc: a-digits v -> raw(v mod base, base), b-digits
          v -> raw(v mod base, m_pair), so base*a_i + b_j sums to the pair
          w = base*a_i + b_j at modulus m_pair;
      stage 2 at m_pair: lo(w) = raw((w div base)(w mod base) mod base,
          m_col), hi(w) = raw((w div base)(w mod base) div base, m_col);
      stage 3 at m_col: dig(t) = raw(t mod base, m_enc), car(t) =
          raw(t div base, m_col), dig_col(t) = raw(t mod base, m_col);
  column_plan(D, base): stage 3's schedule from worst-case values alone:
      column k holds lo_ij (i+j = k) and hi_ij (i+j = k-1), each at most
      base-1, and the carries into it; while a greedy chunking of its terms
      (in order, a chunk's bound at most m_col - 1 and at most 8 terms)
      gives more than one chunk, one normalization call splits every chunk
      into (dig_col, car): the digits re-enter the column, the carries
      (bound / base) go to column k+1. Then the column's sum takes one call
      of the pair (dig, car) where its bound reaches base and k < 2D-1, the
      carry to column k+1; else one call of dig alone;
  mul_radix(a, b): the three stages, each a call of
      `reference_lut.lut_bootstrap` with a test vector a row, in the order
      the program calls them.

Departures from the published description, each to match what the
deployment runs:
  - the lo and hi products of all D^2 pairs go through one call (2 D^2
    ciphertexts, lo block then hi block), and each column's digit and carry
    through one call of the sum twice, where the description counts them as
    two lookups;
  - the terms of a column are taken in the order the pairs are enumerated
    (i, then j; lo_ij into column i+j, hi_ij into column i+j+1), carries
    last in the order they arose: the greedy chunking depends on it;
  - the key switch and the extract are this repository's (reference.py).
"""

from __future__ import annotations

import dataclasses

import torch

from . import reference as R
from . import reference_lut as RL

#: the most terms a column chunk may sum (the bound on summed bootstrap noise)
MAX_CHUNK_TERMS = 8


def raw(v: int, modulus: int) -> int:
    """The raw torus word of message v at `modulus`, in [0, 2^32)."""
    return v * (1 << R.TORUS_BITS) // (2 * modulus) % (1 << R.TORUS_BITS)


def testvec_raw(f, modulus: int, p: R.Params, device) -> torch.Tensor:
    """The full-table test vector of `f` (message -> raw torus word) at
    `modulus`: int32 [2, N], mask row zero."""
    n = p.n1
    values = torch.zeros(n, dtype=torch.int64)
    for x in range(modulus):
        values[RL._div_round(x * n, modulus) : RL._div_round((x + 1) * n, modulus)] = f(x)
    offset = RL._div_round(n, 2 * modulus)
    rotated = torch.roll(values, -offset)
    rotated[n - offset :] = 0 - rotated[n - offset :]
    return torch.stack([torch.zeros(n, dtype=torch.int32), R.wrap(rotated)]).to(device)


def tables(base_bits: int, p: R.Params, device) -> dict:
    """The product's seven test vectors, int32 [2, N] each."""
    base = 1 << base_bits
    m_enc, m_pair, m_col = 2 * base, base * base, 2 * base * base
    return {
        "a": testvec_raw(lambda v: raw(v % base, base), m_enc, p, device),
        "b": testvec_raw(lambda v: raw(v % base, m_pair), m_enc, p, device),
        "lo": testvec_raw(lambda w: raw((w // base) * (w % base) % base, m_col), m_pair, p, device),
        "hi": testvec_raw(lambda w: raw((w // base) * (w % base) // base, m_col), m_pair, p, device),
        "dig": testvec_raw(lambda t: raw(t % base, m_enc), m_col, p, device),
        "car": testvec_raw(lambda t: raw(t // base, m_col), m_col, p, device),
        "dig_col": testvec_raw(lambda t: raw(t % base, m_col), m_col, p, device),
    }


@dataclasses.dataclass(frozen=True)
class Step:
    """One LUT call of stage 3: `kind` "norm" (each chunk of `chunks` to
    (dig_col, car), named `outs` then `carries`), "pair" (the sum of
    chunks[0] to (dig, car): the digit, then carries[0]) or "single" (the
    sum of chunks[0] to dig)."""

    kind: str
    column: int
    chunks: tuple
    outs: tuple = ()
    carries: tuple = ()


def _greedy(terms: list, cap_val: int) -> list:
    """[(name, bound), ...] -> chunks [([names], bound)], each bound at most
    cap_val and at most MAX_CHUNK_TERMS names, in order."""
    chunks, cur, bound = [], [], 0
    for name, mx in terms:
        if cur and (bound + mx > cap_val or len(cur) >= MAX_CHUNK_TERMS):
            chunks.append((cur, bound))
            cur, bound = [], 0
        cur.append(name)
        bound += mx
    chunks.append((cur, bound))
    return chunks


def column_plan(digits: int, base: int) -> list[Step]:
    """Stage 3's calls for D-digit operands at `base`, from the worst-case
    bounds alone. Terms are named ("lo", i, j), ("hi", i, j), ("nd", k, r,
    c), ("nc", k, r, c) (round r's digit and carry of chunk c in column k)
    and ("car", k) (column k's carry)."""
    m_col = 2 * base * base
    terms = [[] for _ in range(2 * digits + 1)]
    for i in range(digits):
        for j in range(digits):
            terms[i + j].append((("lo", i, j), base - 1))
            terms[i + j + 1].append((("hi", i, j), base - 1))
    steps = []
    for k in range(2 * digits):
        tk, rnd = terms[k], 0
        while len(chunks := _greedy(tk, m_col - 1)) > 1:
            outs = tuple(("nd", k, rnd, c) for c in range(len(chunks)))
            carries = tuple(("nc", k, rnd, c) for c in range(len(chunks)))
            steps.append(Step("norm", k, tuple(tuple(c) for c, _ in chunks), outs, carries))
            tk = [(o, base - 1) for o in outs]
            terms[k + 1].extend((c, b // base) for c, (_, b) in zip(carries, chunks))
            rnd += 1
        names, bound = chunks[0]
        if k + 1 < 2 * digits and bound >= base:
            steps.append(Step("pair", k, (tuple(names),), carries=(("car", k),)))
            terms[k + 1].append((("car", k), bound // base))
        else:
            steps.append(Step("single", k, (tuple(names),)))
    return steps


def call_batches(digits: int, base_bits: int, pairs: int) -> list[int]:
    """The ciphertexts of each LUT call of one product of `pairs` operand
    pairs, in order: 2D, 2D^2, then stage 3's."""
    cols = [{"norm": 2 * len(s.chunks), "pair": 2}.get(s.kind, 1) for s in column_plan(digits, 1 << base_bits)]
    return [2 * digits * pairs, 2 * digits * digits * pairs, *(c * pairs for c in cols)]


def _sum(cts: list) -> torch.Tensor:
    total = cts[0].to(torch.int64)
    for c in cts[1:]:
        total = total + c.to(torch.int64)
    return R.wrap(total)


def _per_row(tvs: list, rows: tuple) -> torch.Tensor:
    """Test vectors for a call whose rows are [..., C, n0+1]: tvs[c] for
    position c of the last axis -> [prod(rows), 2, N]."""
    stacked = torch.stack(tvs)  # [C, 2, N]
    return stacked.expand(*rows, *stacked.shape[1:]).reshape(-1, *stacked.shape[1:])


def _call(ct: torch.Tensor, tvs: list, keys: R.Keys, p: R.Params, group_batch: int, dtype) -> torch.Tensor:
    """One LUT call over rows ct [..., C, n0+1], row (.., c) against tvs[c]
    (one shared table when C == 1 and a single table is given)."""
    flat = ct.reshape(-1, ct.shape[-1])
    tv = tvs[0] if len(tvs) == 1 else _per_row(tvs, ct.shape[:-1])
    return RL.lut_bootstrap(flat, tv, keys, p, group_batch, dtype).reshape(ct.shape)


def mul_radix(a: torch.Tensor, b: torch.Tensor, keys: R.Keys, p: R.Params, base_bits: int,
              dtype=torch.float64) -> torch.Tensor:
    """R requests' products at once: a, b int32 [R, M, D, n0+1] (M operand
    pairs a request, digits least significant first) -> [R, M, 2D, n0+1].
    Each call's per-request batch (M times the call's ciphertexts a pair)
    decides the rotation, as in the timed path; the rows of all requests go
    through each call together (a row's result depends on that row alone).
    TF32 is turned off, so that the control's float32 products are
    float32's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m, d = a.shape[1], a.shape[2]
    base = 1 << base_bits
    tv = tables(base_bits, p, a.device)
    calls = iter(call_batches(d, base_bits, m))

    # stage 1: re-encode each digit, a's for the high half of the pair
    enc = _call(torch.cat([a, b], dim=2), [tv["a"]] * d + [tv["b"]] * d, keys, p, next(calls), dtype)
    a2, b2 = enc[:, :, :d], enc[:, :, d:]

    # stage 2: every pair (i, j) -> lo, hi
    w = R.wrap(a2[:, :, :, None].to(torch.int64) + b2[:, :, None, :].to(torch.int64)).reshape(*a.shape[:2], d * d, -1)
    prod = _call(torch.cat([w, w], dim=2), [tv["lo"]] * (d * d) + [tv["hi"]] * (d * d), keys, p, next(calls), dtype)
    named = {}
    for i in range(d):
        for j in range(d):
            named["lo", i, j] = prod[:, :, i * d + j]
            named["hi", i, j] = prod[:, :, d * d + i * d + j]

    # stage 3: the columns
    outs = []
    for step in column_plan(d, base):
        sums = [_sum([named[t] for t in chunk]) for chunk in step.chunks]
        if step.kind == "norm":
            c = len(sums)
            res = _call(torch.stack(sums + sums, dim=2), [tv["dig_col"]] * c + [tv["car"]] * c, keys, p,
                        next(calls), dtype)
            named.update({name: res[:, :, i] for i, name in enumerate(step.outs + step.carries)})
        elif step.kind == "pair":
            res = _call(torch.stack([sums[0], sums[0]], dim=2), [tv["dig"], tv["car"]], keys, p, next(calls), dtype)
            outs.append(res[:, :, 0])
            named[step.carries[0]] = res[:, :, 1]
        else:
            outs.append(_call(sums[0][:, :, None], [tv["dig"]], keys, p, next(calls), dtype)[:, :, 0])
    return torch.stack(outs, dim=2)
