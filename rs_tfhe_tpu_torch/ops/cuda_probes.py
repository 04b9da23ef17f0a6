"""Capability probes and primitive-rate kernels: wrappers, launch counts and
plain PyTorch versions.

The kernels (`csrc/probes.cu`) replace the seven TPU probe kernels of
scripts/probe_mosaic.py and scripts/bench_kernel_prims.py:

  probe_dot                integer dot -> int32: s8 on the tensor cores
                           (mma.sync), s16 and s32 on the CUDA cores
  probe_dot_correct_s16    that dot on full-range random operands, held
                           against an int64 numpy product mod 2^32
  probe_roll               rotate each row, for 1-, 2- and 4-byte elements
  probe_bitcast_i32_to_i8  int32 words as four int8 lanes, little-endian
  probe_unpack_s16         the two sign-extended s16 halves of each word
  chain_dot                bench_dot's chain of dependent s8 dots, on the
                           tensor cores or on the CUDA cores
  chain_roll_add           bench_roll_add's chain of x += roll(x, 1 + i)

Each wrapper launches its kernel on a CUDA tensor (or raises) and adds one to
`launches[<its name>]`; on a CPU tensor it returns the plain version
(`*_plain`), which the tests hold against the JAX scripts' kernels and
`chip_smoke.py` against the kernels on the card. The scripts that print the
TPU scripts' tables are scripts/probe_hopper.py and scripts/bench_hopper_prims.py.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses

import numpy as np
import torch

from .. import _build
from ..torus import wrap_i32

#: Launches by wrapper name in this process (a wrapper adds one per launch).
launches: collections.Counter = collections.Counter()

_INT_TYPES = {torch.int8: 1, torch.int16: 2, torch.int32: 4}
_NP_TYPES = {torch.int8: np.int8, torch.int16: np.int16, torch.int32: np.int32}

#: SM-indexed slots of the chained dot's statistics buffer (csrc/probes.cu).
_STATS_SMS = 1024
#: A chain's barrier counter is 32 bits: 2 * steps * blocks arrivals.
_MAX_CHAIN_STEPS = 1 << 20


# ---------------------------------------------------------------------------
# Plain versions (any device; exact mod 2^32)
# ---------------------------------------------------------------------------

def _matmul_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer a @ b as int64 through float64, for |a| * |b| * K < 2^53."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int64)


def dot_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] . b [K, N] -> int32 [M, N] mod 2^32, for int8, int16 or int32
    operands. PyTorch has no integer matmul on CUDA, so the product goes
    through float64: directly for s8 and s16 (K * 2^30 < 2^53), and for s32
    with both sides split into 16-bit halves (low half unsigned, high half
    signed; the high x high term is a multiple of 2^32), each partial product
    below K * 2^32."""
    if a.dtype != b.dtype or a.dtype not in _INT_TYPES:
        raise TypeError(f"dot_plain takes two int8, int16 or int32 tensors, got {a.dtype}, {b.dtype}")
    k = a.shape[1]
    if k >= 1 << 20:
        raise ValueError(f"K = {k}: the float64 products are exact only below 2^20")
    if a.dtype != torch.int32:
        return wrap_i32(_matmul_exact(a, b))
    al, ah, bl, bh = a & 0xFFFF, a >> 16, b & 0xFFFF, b >> 16
    cross = _matmul_exact(ah, bl) + _matmul_exact(al, bh)
    return wrap_i32(_matmul_exact(al, bl) + ((cross & 0xFFFF) << 16))


def roll_plain(x: torch.Tensor, shift: int = 5) -> torch.Tensor:
    """out[r, (c + shift) mod cols] = x[r, c]."""
    return torch.roll(x, shift, dims=1)


def bitcast_i32_to_i8_plain(x: torch.Tensor) -> torch.Tensor:
    """int32 [R, C] -> int8 [R, 4C]: each word's bytes, least significant first."""
    lanes = [((x >> (8 * j)) & 0xFF).to(torch.int8) for j in range(4)]
    return torch.stack(lanes, dim=-1).reshape(x.shape[0], -1)


def unpack_s16_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int32 [R, C] -> (low, high) sign-extended halves, int16 [R, C] each."""
    return ((x << 16) >> 16).to(torch.int16), (x >> 16).to(torch.int16)


def chain_shape(m: int, k: int) -> tuple[bool, int]:
    """(big, fm) of bench_dot: an lhs above 2 MiB of int32 feeds back the
    column sums of 8 rows, a smaller one its every row."""
    big = m * k * 4 > (2 << 20)
    return big, 8 if big else m


def _feedback(acc: torch.Tensor, fm: int, k: int) -> torch.Tensor:
    rows, n = acc[:fm], acc.shape[1]
    if n >= k:
        return rows[:, :k] + (rows[:, -1:] & 1)
    return torch.cat([rows] * (k // n), dim=1)


def chain_dot_plain(a0: torch.Tensor, b: torch.Tensor, steps: int):
    """`steps` dependent dots: a = int8(a0 + (dep & 1)), acc = a . b, with dep
    the previous step's feedback (0 at first). Returns (acc int32 [M, N],
    fb int32 [fm, K])."""
    (m, k), n = a0.shape, b.shape[1]
    _check_chain(m, k, n, steps)
    big, fm = chain_shape(m, k)
    fb = torch.zeros((fm, k), dtype=torch.int32, device=a0.device)
    acc = torch.zeros((m, n), dtype=torch.int32, device=a0.device)
    for _ in range(steps):
        dep = fb.sum(dim=0, keepdim=True, dtype=torch.int32) if big else fb
        acc = dot_plain((a0.to(torch.int32) + (dep & 1)).to(torch.int8), b)
        fb = _feedback(acc, fm, k)
    return acc, fb


def chain_roll_add_plain(x: torch.Tensor, reps: int) -> torch.Tensor:
    """reps * 16 steps of x += roll(x, 1 + i), i < 16, int32 mod 2^32."""
    for _ in range(reps):
        for i in range(16):
            x = x + torch.roll(x, 1 + i, dims=1)
    return x


# ---------------------------------------------------------------------------
# Checks and the launch
# ---------------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, dtypes) -> None:
    """Raise unless t is a non-empty contiguous matrix of one of `dtypes` on
    the CPU or, 16-byte aligned, on a CUDA device."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of {sorted(map(str, dtypes))}")
    if t.dim() != 2 or 0 in t.shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected 2 non-empty dimensions")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: no implementation for device {t.device}")
    if t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def _check_dot(a: torch.Tensor, b: torch.Tensor) -> None:
    _check("a", a, _INT_TYPES)
    _check("b", b, (a.dtype,))
    if b.device != a.device:
        raise ValueError(f"b: on {b.device}, expected {a.device}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} x {tuple(b.shape)} do not contract")


def _check_chain(m: int, k: int, n: int, steps: int) -> None:
    if not 0 <= steps <= _MAX_CHAIN_STEPS:
        raise ValueError(f"steps = {steps} outside [0, {_MAX_CHAIN_STEPS}]")
    if n < k and k % n:
        raise ValueError(f"the feedback needs N >= K or N dividing K, got K = {k}, N = {n}")


def _launch(name: str, symbol: str, *args, device) -> None:
    """Call the library's launcher `symbol` on `device`'s current stream;
    raise on a refused launch, count a launch made under `name`."""
    lib = _build.load()
    with torch.cuda.device(device):
        err = getattr(lib, symbol)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: {lib.tfhe_cuda_error_string(err).decode()} ({err})")
    launches[name] += 1


def _dot(name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check_dot(a, b)
    if a.device.type == "cpu":
        return dot_plain(a, b)
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if a.dtype == torch.int8:
        if k % 16:
            raise ValueError(f"the s8 tensor-core dot takes K a multiple of 16, got {k}")
        bt = torch.empty((n, k), dtype=torch.int8, device=a.device)
        _launch(name, "tfhe_probe_dot_s8",
                a.data_ptr(), b.data_ptr(), bt.data_ptr(), out.data_ptr(), m, k, n, device=a.device)
    else:
        _launch(name, "tfhe_probe_dot_imad",
                a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, _INT_TYPES[a.dtype], device=a.device)
    return out


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

def dot_unit(dtype: torch.dtype) -> str:
    """Where `probe_dot` runs this operand type on the card."""
    return "tensor cores (mma.sync m16n8k32)" if dtype == torch.int8 else "CUDA cores (int32 multiply-adds)"


def probe_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] . b [K, N] -> int32 [M, N] mod 2^32 for int8, int16 or int32
    operands (`dot_unit` says on which unit)."""
    return _dot("probe_dot", a, b)


def dot_correct_operands(dtype: torch.dtype = torch.int16) -> tuple[np.ndarray, np.ndarray]:
    """The operands `probe_dot_correct_s16` multiplies: full-range
    [128, 1024] and [1024, 256] from numpy's `default_rng(0)`."""
    info = np.iinfo(_NP_TYPES[dtype])
    rng = np.random.default_rng(0)
    a = rng.integers(info.min, int(info.max) + 1, (128, 1024)).astype(info.dtype)
    b = rng.integers(info.min, int(info.max) + 1, (1024, 256)).astype(info.dtype)
    return a, b


def probe_dot_correct_s16(device, dtype: torch.dtype = torch.int16) -> torch.Tensor:
    """The dot of full-range random [128, 1024] x [1024, 256] operands
    (numpy `default_rng(0)`, as the TPU probe draws them) equals the int64
    numpy product mod 2^32, or AssertionError. For s16 by default; any of
    the three operand types."""
    a, b = dot_correct_operands(dtype)
    out = _dot("probe_dot_correct_s16", torch.from_numpy(a).to(device), torch.from_numpy(b).to(device))
    want = (a.astype(np.int64) @ b.astype(np.int64)) % (1 << 32)
    got = out.cpu().numpy().astype(np.int64) % (1 << 32)
    if not np.array_equal(want, got):
        raise AssertionError(f"{dtype} dot differs from the int64 product: max |diff| {np.abs(want - got).max()}")
    return out


def probe_roll(x: torch.Tensor, shift: int = 5) -> torch.Tensor:
    """out[r, (c + shift) mod cols] = x[r, c] for int8, int16 or int32 [R, C]."""
    _check("x", x, _INT_TYPES)
    if x.device.type == "cpu":
        return roll_plain(x, shift)
    rows, cols = x.shape
    out = torch.empty_like(x)
    _launch("probe_roll", "tfhe_probe_roll",
            x.data_ptr(), out.data_ptr(), rows, cols, shift % cols, _INT_TYPES[x.dtype], device=x.device)
    return out


def probe_bitcast_i32_to_i8(x: torch.Tensor) -> torch.Tensor:
    """int32 [R, C] -> int8 [R, 4C], each word's bytes least significant first
    (the lane order of `jax.lax.bitcast_convert_type`)."""
    _check("x", x, (torch.int32,))
    if x.device.type == "cpu":
        return bitcast_i32_to_i8_plain(x)
    out = torch.empty((x.shape[0], 4 * x.shape[1]), dtype=torch.int8, device=x.device)
    _launch("probe_bitcast_i32_to_i8", "tfhe_probe_bitcast_i32_to_i8",
            x.data_ptr(), out.data_ptr(), x.numel(), device=x.device)
    return out


def probe_unpack_s16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int32 [R, C] -> the (low, high) sign-extended s16 halves, by shifts."""
    _check("x", x, (torch.int32,))
    if x.device.type == "cpu":
        return unpack_s16_plain(x)
    lo = torch.empty(x.shape, dtype=torch.int16, device=x.device)
    hi = torch.empty_like(lo)
    _launch("probe_unpack_s16", "tfhe_probe_unpack_s16",
            x.data_ptr(), lo.data_ptr(), hi.data_ptr(), x.numel(), device=x.device)
    return lo, hi


@dataclasses.dataclass(frozen=True)
class ChainDot:
    """A chained dot's outputs. acc int32 [M, N]: the last accumulator; fb
    int32 [fm, K]: its feedback. From the kernel also `stats` (uint64 as
    int64: [0] the largest per-block sum of cycles inside the tile loop,
    [1 + s] the tiles SM s ran) and the number of blocks launched."""

    acc: torch.Tensor
    fb: torch.Tensor
    stats: torch.Tensor | None = None
    blocks: int = 0

    def tile_loop(self) -> tuple[int, int, int]:
        """(cycles in the tile loop, SMs that ran a tile, tiles of the SM that
        ran most, all steps counted); waits for the kernel."""
        if self.stats is None:
            raise ValueError("no kernel statistics: this chain ran its plain version on the CPU")
        stats = self.stats.cpu()
        return int(stats[0]), int((stats[1:] > 0).sum()), int(stats[1:].max())


def chain_dot(a0: torch.Tensor, b: torch.Tensor, steps: int, unit: str = "tensor") -> ChainDot:
    """bench_dot's chain (`chain_dot_plain`) in one launch: all blocks
    resident, a grid barrier after each lhs rebuild and each dot.
    unit: "tensor" (mma.sync s8) or "imad" (int32 multiply-adds on the same
    int8 operands)."""
    if unit not in ("tensor", "imad"):
        raise ValueError(f"unit {unit!r}: 'tensor' or 'imad'")
    _check_dot(a0, b)
    if a0.dtype != torch.int8:
        raise TypeError(f"chain_dot takes int8 operands, got {a0.dtype}")
    if a0.device.type == "cpu":
        return ChainDot(*chain_dot_plain(a0, b, steps))
    (m, k), n = a0.shape, b.shape[1]
    _check_chain(m, k, n, steps)
    big, fm = chain_shape(m, k)
    if unit == "tensor" and k % 16:
        raise ValueError(f"the s8 tensor-core dot takes K a multiple of 16, got {k}")
    dev = a0.device
    bt = torch.empty((n, k), dtype=torch.int8, device=dev)
    a_cur = torch.empty_like(a0)
    acc = torch.zeros((m, n), dtype=torch.int32, device=dev)
    fb = torch.empty((fm, k), dtype=torch.int32, device=dev)
    barrier = torch.zeros(4, dtype=torch.int32, device=dev)
    stats = torch.zeros(1 + _STATS_SMS, dtype=torch.int64, device=dev)
    blocks = ctypes.c_int(0)
    _launch("chain_dot", "tfhe_probe_chain_dot",
            a0.data_ptr(), b.data_ptr(), bt.data_ptr(), a_cur.data_ptr(), acc.data_ptr(), fb.data_ptr(),
            m, k, n, fm, int(big), steps, int(unit == "tensor"), barrier.data_ptr(), stats.data_ptr(),
            ctypes.byref(blocks), device=dev)
    return ChainDot(acc, fb, stats, blocks.value)


def chain_roll_add(x: torch.Tensor, reps: int) -> torch.Tensor:
    """bench_roll_add's chain (`chain_roll_add_plain`) in one launch, one
    block a row, the row in shared memory."""
    _check("x", x, (torch.int32,))
    if not 0 <= reps <= _MAX_CHAIN_STEPS:
        raise ValueError(f"reps = {reps} outside [0, {_MAX_CHAIN_STEPS}]")
    if x.device.type == "cpu":
        return chain_roll_add_plain(x, reps)
    rows, cols = x.shape
    out = torch.empty_like(x)
    _launch("chain_roll_add", "tfhe_probe_roll_add",
            x.data_ptr(), out.data_ptr(), rows, cols, reps, device=x.device)
    return out
