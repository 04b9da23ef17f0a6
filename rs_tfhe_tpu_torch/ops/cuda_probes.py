"""Capability probes and primitive-rate kernels: wrappers, launch counts and
plain PyTorch versions.

The kernels (`csrc/probes.cu`) replace the seven TPU probe kernels of
scripts/probe_mosaic.py and scripts/bench_kernel_prims.py:

  probe_dot                integer dot -> int32 on the tensor cores (wgmma
                           fed by TMA): s8 directly, s16 and s32 as products
                           of their byte limbs recombined by shifts
  probe_dot_correct_s16    that dot on full-range random operands, held
                           against an int64 numpy product mod 2^32
  probe_roll               rotate each row, for 1-, 2- and 4-byte elements
  probe_bitcast_i32_to_i8  int32 words as four int8 lanes, little-endian
  probe_unpack_s16         the two sign-extended s16 halves of each word,
                           a streaming split of 16-byte vectors
  chain_dot                bench_dot's chain of dependent s8 dots, on the
                           tensor cores or on the CUDA cores
  chain_roll_add           bench_roll_add's chain of x += roll(x, 1 + i): a
                           row in a warp's registers where its width is 32 E
                           for an instantiated E, else in shared memory

Each wrapper launches its kernel on a CUDA tensor (or raises) and adds one to
`launches[<its name>]`; on a CPU tensor it returns the plain version
(`*_plain`), which the tests hold against the JAX scripts' kernels and
`chip_smoke.py` against the kernels on the card. The scripts that print the
TPU scripts' tables are scripts/probe_hopper.py and scripts/bench_hopper_prims.py.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import _build
from ..torus import wrap_i32
from ..utils.profiling import counter
from .cuda_launch import launched

#: Launches by wrapper name in this process (a wrapper adds one per launch).
launches = counter("probes.launches")

_INT_TYPES = {torch.int8: 1, torch.int16: 2, torch.int32: 4}
_NP_TYPES = {torch.int8: np.int8, torch.int16: np.int16, torch.int32: np.int32}

#: SM-indexed slots of the chained dot's statistics buffer (csrc/probes.cu).
_STATS_SMS = 1024
#: A chain's barrier counter is 32 bits: 2 * steps * blocks arrivals.
_MAX_CHAIN_STEPS = 1 << 20
#: Output tile edge of the dot kernels by unit: the tensor-core tile
#: (csrc/wgmma_s8.cuh) and the CUDA-core tile (csrc/probes.cu).
DOT_TILE = {"tensor": 128, "imad": 64}
#: The tensor-core dot's K is a multiple of this: TMA copies rows of a
#: multiple of 16 bytes.
TENSOR_K = 16
#: The words a lane (E, a row of 32 E words) of the chained roll+add's
#: register instances (csrc/probes.cu); every other width takes the
#: shared-memory instance, which holds a row and its double buffer in 48 KB.
ROLL_ADD_WORDS = (1, 2, 4, 8, 16, 32, 64)
ROLL_ADD_SHARED_COLS = 6144
#: Launches of `chain_roll_add` by instance: its E (`roll_add_words`), 0 for
#: the shared-memory instance.
roll_add_launches = counter("probes.roll_add.instance")


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


#: The largest limb weight i + j of a byte-limb product that survives mod 2^32.
_LIMB_TOP = 3


def limb_pairs(size: int) -> list[tuple[int, int, int]]:
    """The byte-limb products (i, j, w) of a dot of `size`-byte operands, in
    the order the tensor-core kernel walks them: limb i of a times limb j of
    b at weight 2^(8 w), w = i + j <= 3 (the rest vanish mod 2^32), the
    largest weight first, i upwards within a weight. s16: 4 products, s32:
    10."""
    return [(i, w - i, w) for w in range(_LIMB_TOP, -1, -1) for i in range(max(0, w - size + 1), min(w, size - 1) + 1)]


def limb_planes(x: torch.Tensor) -> list[torch.Tensor]:
    """The byte limbs of an int16 or int32 tensor as int64: x = sum_i
    planes[i] * 2^(8 i) mod 2^32. For int16 the high limb is signed (x >> 8),
    the low one unsigned; for int32 all four are the unsigned bytes of the
    two's-complement word."""
    size = _INT_TYPES[x.dtype]
    w = x.to(torch.int64)
    planes = [(w >> (8 * i)) & 0xFF for i in range(size)]
    if size == 2:
        planes[1] = w >> 8
    return planes


def dot_limbs_plain(a: torch.Tensor, b: torch.Tensor, horner: bool = True) -> torch.Tensor:
    """a [M, K] . b [K, N] -> int32 [M, N] mod 2^32 for int16 or int32
    operands, by the tensor-core kernel's arithmetic: the byte limbs
    (`limb_planes`), their products (`limb_pairs`, each exact through
    float64: |limb product| * K < 2^53) and, with `horner`, Horner's
    recombination of the in-tile instance (the sum shifted left by 8 between
    weights, largest first); without it, the split instance's (each product
    shifted by its own weight, then summed). For the tests: `dot_plain` is
    the plain version."""
    if a.dtype != b.dtype or a.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"dot_limbs_plain takes two int16 or int32 tensors, got {a.dtype}, {b.dtype}")
    pa, pb = limb_planes(a), limb_planes(b)
    pairs = limb_pairs(_INT_TYPES[a.dtype])
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int64, device=a.device)
    w_prev = pairs[0][2]
    for i, j, w in pairs:
        part = _matmul_exact(pa[i], pb[j])
        if not horner:
            acc = (acc + (part << (8 * w))) & 0xFFFFFFFF
            continue
        if w != w_prev:
            acc = (acc << (8 * (w_prev - w))) & 0xFFFFFFFF
            w_prev = w
        acc = (acc + part) & 0xFFFFFFFF
    return wrap_i32(acc)


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


def roll_add_source(words: int, shift: int, j: int) -> tuple[int, int]:
    """Where register j of a lane of the register instance (E = `words`
    words a lane, lane l holding words l E + j) reads word l E + j - shift
    from: (q, r), register r of lane (l - q) mod 32. q = 0 (the lane's own
    register j - shift) for j >= shift, else ceil((shift - j) / E): the
    lane wraps mod 32, as the roll wraps within the row."""
    if j >= shift:
        return 0, j - shift
    q = -(-(shift - j) // words)
    return q, j - shift + q * words


def chain_roll_add_lanes_plain(x: torch.Tensor, reps: int) -> torch.Tensor:
    """`chain_roll_add_plain` by the register instance's index map: each row
    of 32 E words as 32 lanes of E registers, each step's sources from
    `roll_add_source`. For the tests."""
    rows, cols = x.shape
    if cols % 32:
        raise ValueError(f"the register instance takes rows of 32 E words, got {cols}")
    words = cols // 32
    lanes = torch.arange(32, device=x.device)
    v = x.reshape(rows, 32, words)
    for _ in range(reps):
        for shift in range(1, 17):
            src = [roll_add_source(words, shift, j) for j in range(words)]
            v = v + torch.stack([v[:, (lanes - q) % 32, r] for q, r in src], dim=2)
    return v.reshape(rows, cols)


# ---------------------------------------------------------------------------
# Checks and the launch
# ---------------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, dtypes, aligned: bool = True) -> bool:
    """Raise unless t is a non-empty contiguous matrix of one of `dtypes` on
    the CPU or on a CUDA device, there 16-byte aligned unless `aligned` is
    False (the roll and the bitcast take any base). True on a CUDA device."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of {sorted(map(str, dtypes))}")
    if t.dim() != 2 or not t.numel():
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected 2 non-empty dimensions")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.is_cuda:
        if aligned and t.data_ptr() % 16:
            raise ValueError(f"{name}: must be 16-byte aligned")
        return True
    if not t.is_cpu:
        raise ValueError(f"{name}: no implementation for device {t.device}")
    return False


def _check_dot(a: torch.Tensor, b: torch.Tensor) -> bool:
    """`_check` of both operands of a dot; True on a CUDA device."""
    on_cuda = _check("a", a, _INT_TYPES)
    _check("b", b, (a.dtype,))
    if b.device != a.device:
        raise ValueError(f"b: on {b.device}, expected {a.device}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} x {tuple(b.shape)} do not contract")
    return on_cuda


def limb_k(k: int) -> int:
    """The k of the s16/s32 dot's limb planes: K rounded up to TENSOR_K,
    zero-filled past K, so that any K feeds the tensor-core tile."""
    return -(-k // TENSOR_K) * TENSOR_K


def check_tensor_core_operands(*ts: torch.Tensor) -> None:
    """Raise unless each int8 matrix can feed the tensor-core tile's TMA
    copies: rows of K bytes with K a multiple of TENSOR_K, and a 16-byte
    aligned base."""
    for t in ts:
        k = t.shape[1]
        if k % TENSOR_K:
            raise ValueError(f"the s8 tensor-core dot takes K a multiple of {TENSOR_K}, got {k}")
        if t.data_ptr() % 16:
            raise ValueError("the s8 tensor-core dot's operands must be 16-byte aligned")


def _check_chain(m: int, k: int, n: int, steps: int) -> None:
    if not 0 <= steps <= _MAX_CHAIN_STEPS:
        raise ValueError(f"steps = {steps} outside [0, {_MAX_CHAIN_STEPS}]")
    if n < k and k % n:
        raise ValueError(f"the feedback needs N >= K or N dividing K, got K = {k}, N = {n}")


#: The library's functions by name, each looked up once (`_fn`).
_fns: dict = {}


def _fn(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        fn = _fns[symbol] = getattr(_build.load(), symbol)
    return fn


def _stream_handle(index: int) -> int:
    return torch.cuda.current_stream(index).cuda_stream


#: The raw handle of a device's current stream, in one call where this build
#: of torch has the accessor, else through a Stream object; and the current
#: device's index, without `torch.cuda.current_device()`'s initialisation
#: check where torch has the accessor (a CUDA tensor in hand means CUDA is
#: initialised).
_current_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or _stream_handle
_current_device = getattr(torch._C, "_cuda_getDevice", None) or torch.cuda.current_device


def _launch(name: str, symbol: str, *args, index: int) -> None:
    """Call the library's launcher `symbol` on the current stream of CUDA
    device `index` (made current for the call if it is not); raise on a
    refused launch, count a launch made under `name`. A launch is most of
    what the probes cost at their probe shapes, so this path does only what
    a launch needs."""
    fn = _fn(symbol)
    if _current_device() == index:
        err = fn(*args, _current_stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, _current_stream(index))
    launched(err, launches, name, "{} kernel launch failed", name)


def _dot(name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if not _check_dot(a, b):
        return dot_plain(a, b)
    (m, k), n = a.shape, b.shape[1]
    out = a.new_empty((m, n), dtype=torch.int32)
    if a.dtype == torch.int8:
        check_tensor_core_operands(a)
        bt = a.new_empty((n, k))
        _launch(name, "tfhe_probe_dot_s8",
                a.data_ptr(), b.data_ptr(), bt.data_ptr(), out.data_ptr(), m, k, n, index=a.get_device())
    else:
        size = _INT_TYPES[a.dtype]
        planes = a.new_empty(size * (m + n) * limb_k(k), dtype=torch.uint8)
        _launch(name, "tfhe_probe_dot_limbs", a.data_ptr(), b.data_ptr(), planes.data_ptr(), out.data_ptr(),
                m, k, n, size, index=a.get_device())
    return out


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

def dot_tiles(m: int, n: int, unit: str = "tensor") -> int:
    """Output tiles of an [M, K] . [K, N] dot on `unit`: what the chained
    dot's blocks walk, and what its per-SM tile counts count."""
    edge = DOT_TILE[unit]
    return -(-m // edge) * -(-n // edge)


def tile_loop_rate(m: int, k: int, n: int, unit: str, cycles: int, busiest: int) -> float:
    """Multiply-adds a clock of one SM inside a chain's tile loop: the tiles
    of the SM that ran most (`ChainDot.tile_loop`), each of M K N / tiles
    multiply-adds, over the cycles of the slowest block."""
    return m * k * n / dot_tiles(m, n, unit) * busiest / cycles


def dot_unit(dtype: torch.dtype) -> str:
    """Where and how `probe_dot` runs this operand type on the card."""
    if dtype == torch.int8:
        return "tensor cores (wgmma m64n128k32)"
    return f"tensor cores (wgmma m64n128k32, {len(limb_pairs(_INT_TYPES[dtype]))} byte-limb products)"


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
    """out[r, (c + shift) mod cols] = x[r, c] for int8, int16 or int32 [R, C],
    any shift, any base."""
    if not _check("x", x, _INT_TYPES, aligned=False):
        return roll_plain(x, shift)
    rows, cols = x.shape
    out = torch.empty_like(x)
    _launch("probe_roll", "tfhe_probe_roll",
            x.data_ptr(), out.data_ptr(), rows, cols, shift % cols, x.element_size(), index=x.get_device())
    return out


def probe_bitcast_i32_to_i8(x: torch.Tensor) -> torch.Tensor:
    """int32 [R, C] -> int8 [R, 4C], each word's bytes least significant first
    (the lane order of `jax.lax.bitcast_convert_type`); any base."""
    if not _check("x", x, (torch.int32,), aligned=False):
        return bitcast_i32_to_i8_plain(x)
    rows, cols = x.shape
    out = x.new_empty((rows, 4 * cols), dtype=torch.int8)
    _launch("probe_bitcast_i32_to_i8", "tfhe_probe_bitcast_i32_to_i8",
            x.data_ptr(), out.data_ptr(), rows * cols, index=x.get_device())
    return out


def probe_unpack_s16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int32 [R, C] -> the (low, high) sign-extended s16 halves. On the card
    both are views of one allocation, high starting at the first 16-byte
    boundary after low."""
    if not _check("x", x, (torch.int32,)):
        return unpack_s16_plain(x)
    (rows, cols), count = x.shape, x.numel()
    gap = -(-count // 8) * 8
    lo, hi = x.new_empty_strided((2, rows, cols), (gap, cols, 1), dtype=torch.int16).unbind(0)
    _launch("probe_unpack_s16", "tfhe_probe_unpack_s16",
            x.data_ptr(), lo.data_ptr(), hi.data_ptr(), count, index=x.get_device())
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
    unit: "tensor" (wgmma s8, 128 x 128 tiles) or "imad" (int32
    multiply-adds on the same int8 operands, 64 x 64 tiles)."""
    if unit not in ("tensor", "imad"):
        raise ValueError(f"unit {unit!r}: 'tensor' or 'imad'")
    on_cuda = _check_dot(a0, b)
    if a0.dtype != torch.int8:
        raise TypeError(f"chain_dot takes int8 operands, got {a0.dtype}")
    if not on_cuda:
        return ChainDot(*chain_dot_plain(a0, b, steps))
    (m, k), n = a0.shape, b.shape[1]
    _check_chain(m, k, n, steps)
    big, fm = chain_shape(m, k)
    if unit == "tensor":
        check_tensor_core_operands(a0)
    dev = a0.device
    bt = torch.empty((n, k), dtype=torch.int8, device=dev)
    a_cur = torch.empty_like(a0)
    # every step stores all of acc; without steps the result is zeros
    acc = (torch.empty if steps else torch.zeros)((m, n), dtype=torch.int32, device=dev)
    fb = torch.empty((fm, k), dtype=torch.int32, device=dev)
    barrier = torch.zeros(4, dtype=torch.int32, device=dev)
    stats = torch.zeros(1 + _STATS_SMS, dtype=torch.int64, device=dev)
    blocks = ctypes.c_int(0)
    _launch("chain_dot", "tfhe_probe_chain_dot",
            a0.data_ptr(), b.data_ptr(), bt.data_ptr(), a_cur.data_ptr(), acc.data_ptr(), fb.data_ptr(),
            m, k, n, fm, int(big), steps, int(unit == "tensor"), barrier.data_ptr(), stats.data_ptr(),
            ctypes.byref(blocks), index=a0.get_device())
    return ChainDot(acc, fb, stats, blocks.value)


def roll_add_words(cols: int) -> int:
    """The instance a row of `cols` words takes: E where cols = 32 E for E in
    ROLL_ADD_WORDS (the register instance, one warp a row), else 0 (the
    shared-memory instance, up to ROLL_ADD_SHARED_COLS); wider rows raise."""
    if cols % 32 == 0 and cols // 32 in ROLL_ADD_WORDS:
        return cols // 32
    if cols > ROLL_ADD_SHARED_COLS:
        raise ValueError(f"chain_roll_add takes rows of 32 E words for E in {ROLL_ADD_WORDS} "
                         f"or of at most {ROLL_ADD_SHARED_COLS} words, got {cols}")
    return 0


def chain_roll_add(x: torch.Tensor, reps: int) -> torch.Tensor:
    """bench_roll_add's chain (`chain_roll_add_plain`) in one launch, on the
    instance `roll_add_words` picks from the width (counted in
    `roll_add_launches`)."""
    on_cuda = _check("x", x, (torch.int32,))
    if not 0 <= reps <= _MAX_CHAIN_STEPS:
        raise ValueError(f"reps = {reps} outside [0, {_MAX_CHAIN_STEPS}]")
    if not on_cuda:
        return chain_roll_add_plain(x, reps)
    rows, cols = x.shape
    words = roll_add_words(cols)
    out = torch.empty_like(x)
    _launch("chain_roll_add", "tfhe_probe_roll_add",
            x.data_ptr(), out.data_ptr(), rows, cols, reps, words, index=x.get_device())
    roll_add_launches[words] += 1
    return out
