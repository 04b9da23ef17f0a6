"""The plain reference of the timed path: TFHE gate bootstrapping in plain
PyTorch, written from the published equations (rs-tfhe trgsw.rs, trlwe.rs,
gates.rs) and the configuration file's numbers alone.

It imports nothing of the program and takes nothing the program made: it
reads the benchmark's own key arrays (keygen.py) and the ciphertexts the
benchmark handed to both sides, and it works out again every derived table
(mod-switched exponents, gadget digits, circulants, the key-switching
selection). What it computes:

  bootstrap(ct) = key_switch(sample_extract(rotate(ct)))

  rotate, standard key (CMUX chain, n0 steps):
      acc = X^{b~} * testvec
      acc += Dec(X^{a~_i} * acc - acc) (x) BSK_i
  rotate, multi-bit key (n0/2 groups, the pair (a~_{2g}, a~_{2g+1})):
      acc = sum_v X^{k_v} * (Dec(acc) (x) BSK_mb[g, v]),
      k = (0, a~_{2g}, a~_{2g+1}, a~_{2g} + a~_{2g+1})
  taken for a batch of at most `mb_route_batch_cap` ciphertexts when the key
  has a multi-bit part (the route rule the configuration states), the
  standard chain otherwise;
  sample_extract: the LWE of coefficient 0 under the ring key;
  key_switch: (0, .., 0, b) - sum of the KSK rows the base-2^basebit digits
  of the mask select.

Every negacyclic product is a matmul against the circulant of the key side,
in float64 by default: each sum is an integer below 2^53 (checked), so the
result is exact and is reduced mod 2^32 afterwards. `dtype=torch.float32`
computes the same in a lower precision: the benchmark's control, which has to
come out as not correct.
"""

from __future__ import annotations

import dataclasses

import torch

TORUS_BITS = 32
_F64_EXACT = 1 << 53


def i32(value: int) -> int:
    """A word mod 2^32 as the signed value of its int32 carrier."""
    value %= 1 << TORUS_BITS
    return value - (1 << TORUS_BITS) if value >= 1 << 31 else value


def wrap(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor -> int32 tensor holding the value mod 2^32."""
    return (torch.remainder(x + (1 << 31), 1 << TORUS_BITS) - (1 << 31)).to(torch.int32)


def torus(value: float) -> int:
    """The int32 word of a torus value in [-1/2, 1/2)."""
    return i32(round((value % 1.0) * (1 << TORUS_BITS)))


MU = torus(0.125)  # a true boolean; -MU a false one


@dataclasses.dataclass(frozen=True)
class Params:
    """The numbers of a configuration file that the arithmetic uses."""

    n0: int
    n1: int
    nbit: int
    bgbit: int
    l: int
    basebit: int
    iks_t: int
    bsk_round_bits: int
    alpha_lv0: float
    alpha_lv1: float
    multibit: bool = False
    mb_route_batch_cap: int = 0

    @classmethod
    def from_config(cls, cfg: dict) -> "Params":
        names = [f.name for f in dataclasses.fields(cls)]
        return cls(**{k: cfg[k] for k in names if k in cfg})

    @property
    def half_bg(self) -> int:
        return 1 << (self.bgbit - 1)

    @property
    def ks_base(self) -> int:
        return 1 << self.basebit

    @property
    def decompose_offset(self) -> int:
        """sum_i Bg/2 * 2^(32-(i+1)*bgbit), plus half of the dropped low bits
        (the centred decomposition), as an int32 word."""
        off = sum(self.half_bg << (TORUS_BITS - (i + 1) * self.bgbit) for i in range(self.l))
        kept = self.l * self.bgbit
        if kept < TORUS_BITS:
            off += 1 << (TORUS_BITS - kept - 1)
        return i32(off)

    def takes_mb(self, batch: int) -> bool:
        """Whether a bootstrap of `batch` ciphertexts takes the multi-bit
        rotation."""
        return self.multibit and batch <= self.mb_route_batch_cap


@dataclasses.dataclass
class Keys:
    """The benchmark's key arrays, int32 on one device: lv0 [n0] and lv1 [N]
    in {0, 1}; testvec [2, N]; bsk [n0, 2L, 2, N]; ksk_rows [N*t*base, n0+1]
    (row (i, j, k) encrypts k*s1[i]/base^(j+1); the k = 0 rows are zero);
    bsk_mb [n0/2, 4, 2L, 2, N] or None."""

    lv0: torch.Tensor
    lv1: torch.Tensor
    testvec: torch.Tensor
    bsk: torch.Tensor
    ksk_rows: torch.Tensor
    bsk_mb: torch.Tensor | None = None


# ---------------------------------------------------------------------------
# Polynomials in Z_{2^32}[X]/(X^N + 1)
# ---------------------------------------------------------------------------

def logical_rshift(x: torch.Tensor, shift: int) -> torch.Tensor:
    """The uint32 shift x >> shift on the int32 carrier."""
    return (x >> shift) & ((1 << (TORUS_BITS - shift)) - 1)


def monomial_rotate(t: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """X^k * t: t int32 [..., N], k integer broadcastable to t.shape[:-1]."""
    n = t.shape[-1]
    k = torch.as_tensor(k, dtype=torch.int64, device=t.device).expand(t.shape[:-1]).unsqueeze(-1)
    idx = torch.remainder(torch.arange(n, device=t.device) - k, 2 * n)
    wrapped = idx >= n
    vals = torch.gather(t, -1, torch.where(wrapped, idx - n, idx))
    return torch.where(wrapped, 0 - vals, vals)


_CIRCULANT_INDEX: dict = {}


def _circulant_index(n: int, device) -> torch.Tensor:
    key = (n, str(device))
    if key not in _CIRCULANT_INDEX:
        m = torch.arange(n, device=device)
        _CIRCULANT_INDEX[key] = torch.remainder(m[None, :] - m[:, None], 2 * n)
    return _CIRCULANT_INDEX[key]


def circulant(t: torch.Tensor, dtype) -> torch.Tensor:
    """t int32 [J, O, N] -> [J*N, O*N] in `dtype` with
    C[j*N + m, o*N + c] = t[j, o] * X^m at coefficient c, so that
    (d.reshape(-1, J*N) @ C)[:, o*N + c] = sum_j (d_j (x) t_jo)[c]."""
    j, o, n = t.shape
    ext = torch.cat([t, 0 - t], dim=-1).to(dtype)  # t and its negated second period
    c = ext[..., _circulant_index(n, t.device)]  # [J, O, N(m), N(c)]
    return c.permute(0, 2, 1, 3).reshape(j * n, o * n)


def polymul(d: torch.Tensor, t: torch.Tensor, max_d: int, dtype=torch.float64) -> torch.Tensor:
    """out[b, o] = sum_j d[b, j] (x) t[j, o], negacyclic, mod 2^32.

    d int32 [B, J, N] with |d| <= max_d; t int32 [J, O, N]. Returns int32
    [B, O, N]."""
    j, o, n = t.shape
    if dtype == torch.float64 and j * n * max_d * (1 << 31) >= _F64_EXACT:
        raise ValueError(f"{j * n} products of |d| <= {max_d} by 32-bit words pass 2^53")
    prod = d.reshape(-1, j * n).to(dtype) @ circulant(t, dtype)
    return wrap(torch.round(prod).to(torch.int64)).reshape(-1, o, n)


def decompose(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Signed base-2^bgbit digits: int32 [B, 2, N] -> [B, 2L, N], the a
    polynomial's L digits first, each in [-Bg/2, Bg/2)."""
    tmp = x + p.decompose_offset
    digits = [((tmp >> (TORUS_BITS - (i + 1) * p.bgbit)) & ((1 << p.bgbit) - 1)) - p.half_bg
              for i in range(p.l)]
    d = torch.stack(digits, dim=-3).transpose(-3, -2)  # [B, 2, L, N]
    return d.reshape(x.shape[0], 2 * p.l, x.shape[-1])


# ---------------------------------------------------------------------------
# Bootstrapping
# ---------------------------------------------------------------------------

def modswitch(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Torus words rounded to [0, 2N)."""
    return logical_rshift(x + (1 << (TORUS_BITS - p.nbit - 2)), TORUS_BITS - p.nbit - 1)


def exponents(ct: torch.Tensor, p: Params):
    """LWE lv0 [B, n0+1] -> (b~ [B], a~ [B, n0]) with b~ = -modswitch(b)."""
    b_til = torch.remainder(2 * p.n1 - modswitch(ct[:, p.n0], p), 2 * p.n1)
    return b_til, modswitch(ct[:, : p.n0], p)


def rotate(ct: torch.Tensor, keys: Keys, p: Params, dtype=torch.float64) -> torch.Tensor:
    """The standard blind rotation: int32 [B, n0+1] -> TRLWE [B, 2, N]."""
    b_til, a_til = exponents(ct, p)
    acc = monomial_rotate(keys.testvec.expand(ct.shape[0], 2, p.n1), b_til.unsqueeze(-1))
    for i in range(p.n0):
        rot = monomial_rotate(acc, a_til[:, i : i + 1])
        acc = acc + polymul(decompose(rot - acc, p), keys.bsk[i], p.half_bg, dtype).reshape(acc.shape)
    return acc


def rotate_mb(ct: torch.Tensor, keys: Keys, p: Params, dtype=torch.float64) -> torch.Tensor:
    """The multi-bit blind rotation: int32 [B, n0+1] -> TRLWE [B, 2, N]."""
    batch, n = ct.shape[0], p.n1
    b_til, a_til = exponents(ct, p)
    acc = monomial_rotate(keys.testvec.expand(batch, 2, n), b_til.unsqueeze(-1))
    a1, a2 = a_til[:, 0::2], a_til[:, 1::2]
    ks = torch.stack([torch.zeros_like(a1), a1, a2, torch.remainder(a1 + a2, 2 * n)], dim=-1)
    for g in range(p.n0 // 2):
        pats = keys.bsk_mb[g].permute(1, 0, 2, 3).reshape(2 * p.l, 8, n)  # [2L, (v, o), N]
        prod = polymul(decompose(acc, p), pats, p.half_bg, dtype).reshape(batch, 4, 2, n)
        rot = monomial_rotate(prod, ks[:, g, :, None])
        acc = rot[:, 0] + rot[:, 1] + rot[:, 2] + rot[:, 3]
    return acc


def sample_extract(acc: torch.Tensor) -> torch.Tensor:
    """TRLWE [B, 2, N] -> LWE lv1 [B, N+1] of coefficient 0:
    mask (a_0, -a_{N-1}, ..., -a_1), body b_0."""
    a = acc[:, 0]
    mask = torch.cat([a[:, :1], 0 - a[:, 1:].flip(-1)], dim=-1)
    return torch.cat([mask, acc[:, 1, :1]], dim=-1)


def key_switch(lv1: torch.Tensor, keys: Keys, p: Params, dtype=torch.float64,
               block: int = 512) -> torch.Tensor:
    """LWE lv1 [B, N+1] -> LWE lv0 [B, n0+1]: the one-hot selection of the
    digits' KSK rows as a matmul, `block` rows at a time (exact in float64:
    at most N*t words of |w| <= 2^31 a sum)."""
    n1, t, base = p.n1, p.iks_t, p.ks_base
    if dtype == torch.float64 and n1 * t * (1 << 31) >= _F64_EXACT:
        raise ValueError("key switch sums pass 2^53")
    table = keys.ksk_rows.to(dtype)
    shifts = TORUS_BITS - p.basebit * torch.arange(1, t + 1, device=lv1.device)
    outs = []
    for start in range(0, lv1.shape[0], block):
        rows = lv1[start : start + block]
        a_bar = rows[:, :n1] + (1 << (TORUS_BITS - (1 + p.basebit * t)))
        digits = (a_bar.unsqueeze(-1) >> shifts) & (base - 1)  # [b, N, t]
        onehot = digits.unsqueeze(-1) == torch.arange(base, device=lv1.device)
        summed = torch.round(onehot.reshape(rows.shape[0], -1).to(dtype) @ table).to(torch.int64)
        summed[:, p.n0] -= rows[:, n1].to(torch.int64)
        outs.append(wrap(0 - summed))
    return torch.cat(outs)


def bootstrap(ct: torch.Tensor, keys: Keys, p: Params, group_batch: int, dtype=torch.float64) -> torch.Tensor:
    """Gate bootstrap of lv0 ciphertexts [B, n0+1] that the timed path
    bootstrapped in calls of `group_batch` ciphertexts, which decides the
    rotation."""
    rot = rotate_mb if keys.bsk_mb is not None and p.takes_mb(group_batch) else rotate
    return key_switch(sample_extract(rot(ct, keys, p, dtype)), keys, p, dtype)


# ---------------------------------------------------------------------------
# Gates (rs-tfhe gates.rs): a linear form with a constant on the body, then
# one bootstrap; plain booleans beside them
# ---------------------------------------------------------------------------

def _bias(ct: torch.Tensor, value: float) -> torch.Tensor:
    out = ct.clone()
    out[..., -1] += torus(value)
    return out


LINEAR = {
    "nand": lambda a, b: _bias(0 - (a + b), 0.125),
    "or": lambda a, b: _bias(a + b, 0.125),
    "and": lambda a, b: _bias(a + b, -0.125),
    "xor": lambda a, b: _bias(a + b * 2, 0.25),
    "xnor": lambda a, b: _bias((0 - (a + b)) * 2, -0.25),
    "nor": lambda a, b: _bias(0 - (a + b), -0.125),
    "and_ny": lambda a, b: _bias((0 - a) + b, -0.125),
    "and_yn": lambda a, b: _bias(a - b, -0.125),
    "or_ny": lambda a, b: _bias((0 - a) + b, 0.125),
    "or_yn": lambda a, b: _bias(a - b, 0.125),
}

PLAIN = {
    "nand": lambda x, y: ~(x & y),
    "or": lambda x, y: x | y,
    "and": lambda x, y: x & y,
    "xor": lambda x, y: x ^ y,
    "xnor": lambda x, y: ~(x ^ y),
    "nor": lambda x, y: ~(x | y),
    "and_ny": lambda x, y: ~x & y,
    "and_yn": lambda x, y: x & ~y,
    "or_ny": lambda x, y: ~x | y,
    "or_yn": lambda x, y: x | ~y,
}

#: bootstrap-free one-input operations
UNARY = {"not": lambda a: 0 - a, "copy": lambda a: a}
PLAIN_UNARY = {"not": lambda x: ~x, "copy": lambda x: x}


def gate(name: str, a: torch.Tensor, b: torch.Tensor, keys: Keys, p: Params,
         group_batch: int, dtype=torch.float64) -> torch.Tensor:
    """One two-input gate over lv0 ciphertexts [B, n0+1]."""
    return bootstrap(LINEAR[name](a, b), keys, p, group_batch, dtype)


def decrypt(ct: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """bool [...]: the sign of the phase b - <a, s>."""
    dot = (ct[..., :-1].to(torch.int64) * s.to(torch.int64)).sum(-1)
    return wrap(ct[..., -1].to(torch.int64) - dot) >= 0


# ---------------------------------------------------------------------------
# Circuits: a netlist levelled as the timed path schedules it
# ---------------------------------------------------------------------------

def levels(n_inputs: int, gates: list) -> list[int]:
    """Each gate's level: 0 when it reads only inputs, else one more than
    the highest level among the gates it reads. gates: [op, out, *ins]."""
    level_of = {}
    out = []
    for op, wire, *ins in gates:
        lv = max([level_of[w] + 1 for w in ins if w >= n_inputs] or [0])
        level_of[wire] = lv
        out.append(lv)
    return out


def schedule(n_inputs: int, gates: list) -> list[tuple[int, str, list[int]]]:
    """[(level, op, gate indices)]: the gates of one op at one level, which
    the timed path runs as one batched call, in level order."""
    groups: dict = {}
    for i, lv in enumerate(levels(n_inputs, gates)):
        groups.setdefault((lv, gates[i][0]), []).append(i)
    return [(lv, op, idx) for (lv, op), idx in sorted(groups.items())]


def evaluate(inputs: torch.Tensor, n_inputs: int, gates: list, keys: Keys, p: Params,
             dtype=torch.float64) -> torch.Tensor:
    """Every wire of the netlist for R requests at once: inputs int32
    [R, n_inputs, n0+1] -> [R, n_wires, n0+1]. A group's rotation is the one
    its per-request batch takes; rows of all requests go through it
    together (each row's result depends on that row alone)."""
    r = inputs.shape[0]
    n_wires = max([n_inputs - 1] + [g[1] for g in gates]) + 1
    wires = torch.zeros((r, n_wires, inputs.shape[-1]), dtype=torch.int32, device=inputs.device)
    wires[:, :n_inputs] = inputs
    for _lv, op, idx in schedule(n_inputs, gates):
        outs = [gates[i][1] for i in idx]
        args = [wires[:, [gates[i][2 + k] for i in idx]].reshape(r * len(idx), -1)
                for k in range(len(gates[idx[0]]) - 2)]
        if op in UNARY:
            res = UNARY[op](*args)
        else:
            res = gate(op, *args, keys, p, len(idx), dtype)
        wires[:, outs] = res.reshape(r, len(idx), -1)
    return wires


def evaluate_plain(bits: torch.Tensor, n_inputs: int, gates: list) -> torch.Tensor:
    """The same netlist on plain booleans: bits bool [R, n_inputs] -> every
    wire, bool [R, n_wires]."""
    n_wires = max([n_inputs - 1] + [g[1] for g in gates]) + 1
    wires = torch.zeros((bits.shape[0], n_wires), dtype=torch.bool, device=bits.device)
    wires[:, :n_inputs] = bits
    for op, out, *ins in gates:
        fn = PLAIN_UNARY.get(op) or PLAIN[op]
        wires[:, out] = fn(*(wires[:, w] for w in ins))
    return wires
