"""What the kernels' wrappers (`ops/cuda_*.py`) share: the operand checks,
the device switch, the tail of a launch, the whole rotation's operand
contract, the key's byte limbs and when the rotations multiply on the tensor
cores, the clusters a card holds and the cost that ranks the rotation
kernels' CUDA-core instances. No wrapper imports another; each imports this.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import weakref

import torch

from .. import _build
from ..params import TfheParams
from ..utils.profiling import counter


def on_device(index: int):
    """A context in which CUDA device `index` is current: nothing to do (and
    no cudaSetDevice round trip) when it already is."""
    if torch.cuda.current_device() == index:
        return contextlib.nullcontext()
    return torch.cuda.device(index)


def check_tensor(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    """Raise unless t is a contiguous int32 tensor of this shape on `device`
    (the kernels' operand contract)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.int32")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_shapes(params: TfheParams) -> None:
    """Raise unless the kernels take this ring size and gadget."""
    g, n = params.trgsw_lv1, params.n1
    if n & (n - 1) or not 64 <= n <= 4096:
        raise ValueError(f"ring size N={n}: the kernels take powers of two in [64, 4096]")
    if not 1 <= g.bgbit <= 31 or g.l * g.bgbit > 32:
        raise ValueError(f"gadget bgbit={g.bgbit}, L={g.l} outside the kernels' range")


def rotation_operands(
    name: str, b_til: torch.Tensor, a_til: torch.Tensor, testvec: torch.Tensor,
    key_name: str, key: torch.Tensor, key_shape: tuple, params: TfheParams,
) -> tuple:
    """Check a whole rotation's operands (the contract of the kernel the
    wrapper `name` launches): CUDA tensors, a ring size and gadget the
    kernels take, int32 exponents b_til [B] and a_til [B, n0], the key
    `key_name` of `key_shape`, a test vector [2, N] (shared) or [B, 2, N]
    (per ciphertext). Returns (the output int32 [B, 2, N], the test vector's
    stride in words, the CUDA device's index); the index is None at B = 0,
    where there is nothing to launch."""
    if b_til.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {b_til.device}")
    n0, n = params.n0, params.n1
    check_shapes(params)
    dev = b_til.device
    batch = b_til.shape[0]
    check_tensor("b_til", b_til, (batch,), dev)
    check_tensor("a_til", a_til, (batch, n0), dev)
    check_tensor(key_name, key, key_shape, dev)
    if testvec.dim() == 2:
        check_tensor("testvec", testvec, (2, n), dev)
        tv_stride = 0
    else:
        check_tensor("testvec", testvec, (batch, 2, n), dev)
        tv_stride = 2 * n
    out = torch.empty((batch, 2, n), dtype=torch.int32, device=dev)
    if batch == 0:
        return out, tv_stride, None
    return out, tv_stride, dev.index if dev.index is not None else torch.cuda.current_device()


def error_text(err: int) -> str:
    """The library's message for its error code `err`."""
    return _build.load().tfhe_cuda_error_string(err).decode()


def launched(err: int, counter: collections.Counter, key, failure: str, *args) -> None:
    """The tail of a launch: where the library returned a non-zero code
    `err`, raise RuntimeError with `failure` (formatted with `args`, only
    then) and the library's message; else count `key` in the wrapper's
    `counter`."""
    if err:
        raise RuntimeError(f"{failure.format(*args)}: {error_text(err)} ({err})")
    counter[key] += 1


def limb_accumulator_bound(params: TfheParams) -> int:
    """The largest magnitude one s32 limb accumulator of the tensor-core
    product can reach: 2L * N terms of |digit| <= Bg/2 times a byte <= 255."""
    g = params.trgsw_lv1
    return 2 * g.l * params.n1 * g.half_bg * 255


def takes_tensor_cores(params: TfheParams) -> bool:
    """Whether the limb product serves this set: digits of one s8 limb and
    limb sums that stay inside s32."""
    return params.trgsw_lv1.bgbit <= 8 and limb_accumulator_bound(params) < 1 << 31


#: The fold (`csrc/cluster_rotation.cuh`): a cluster instance's tile of one
#: ciphertext multiplied on the tensor cores, its digit plane folded into 16
#: rows shifted by 8 digits, against the byte limbs of the block's key window.
#: A block's 2N / cluster columns must fill a 16 x 8 tile: N >= 1024.
FOLD_MIN_RING = 1024


def takes_fold(params: TfheParams, tile: int, cluster: int) -> bool:
    """Whether the rotation kernels run their (tile, cluster) instance as the
    fold for this set: one ciphertext on a cluster, N >= FOLD_MIN_RING, and
    `takes_tensor_cores`. The fold keeps K = N digits a gadget row (the
    wrapped digits go to a second sum, `neg`, and no row is padded), so a
    limb sum has the 2L * N terms of `limb_accumulator_bound`."""
    return tile == 1 and cluster >= 2 and params.n1 >= FOLD_MIN_RING and takes_tensor_cores(params)


def fold_unit(limbs: int) -> str:
    """The unit name the rotations' launch counters give the fold with
    `limbs` key limbs."""
    return f"mma_fold_s8x{limbs}"


#: The fold's tile columns (an m16n8 tile's 16 rows of 8) and the zero digits
#: on each side of its s8 digit plane (`kFoldCols`, `kFoldPad`).
FOLD_COLS, FOLD_PAD = 128, 128


def fold_product_plain(digits: torch.Tensor, keys: torch.Tensor, s0: int, cols: int, limbs: int = 4) -> torch.Tensor:
    """One step's product for a cluster block's columns [s0, s0 + cols) by the
    fold's addressing: the s8 plane of each gadget row (FOLD_PAD zeros, the
    digits, FOLD_PAD zeros); A[f][r] = plane[FOLD_PAD + 8 f + r], the 16 rows
    shifted by 8 digits, into `pos`, and over the last 128 digits of a row
    A'[f][r] = plane[FOLD_PAD + 8 f + r - N], the wrapped digits, into `neg`;
    the key window's word q (lo = s0 + CW - 4 - 4q, CW = 128 (NT - 1) + 8,
    NT = cols / 128) holding bytes E(lo + 3), ..., E(lo) per limb, E(k) = p[k]
    for k >= 0 and -p[k + N] below; B_h[r][e] = rev[CW - 1 - 128 h - e + r];
    one s32 sum per limb over every gadget row (raises where pos or neg would
    leave s32), (pos - neg) << 8k summed mod 2^32 into column 128 h + 8 f + e.

    digits: int [J, N] with |d| <= 128; keys: int32 [J, N], row j's key
    polynomial (or combination); cols a multiple of 128, s0 + cols <= N.
    `limbs` 3 drops the key's low byte. Returns int32 [cols]. For tests:
    `ops.poly.polymul_small_by_torus` is the plain product."""
    j_rows, n = digits.shape
    if cols % FOLD_COLS or s0 % 4 or s0 + cols > n or n < FOLD_MIN_RING:
        raise ValueError(f"fold_product_plain: cols {cols} at s0={s0}, N={n}")
    nt = cols // FOLD_COLS
    cw = FOLD_COLS * (nt - 1) + 8
    plane = torch.zeros((j_rows, n + 2 * FOLD_PAD), dtype=torch.float64)
    plane[:, FOLD_PAD:FOLD_PAD + n] = digits.to(torch.float64)
    f, r = torch.arange(16)[:, None], torch.arange(n)[None, :]
    a_pos = plane[:, FOLD_PAD + 8 * f + r]
    a_neg = torch.where(r >= n - 128, plane[:, (FOLD_PAD + 8 * f + r - n).clamp(min=0)], 0.0)
    lo = s0 + cw - 4 - 4 * torch.arange((n + cw) // 4)
    x = (lo[:, None] + 3 - torch.arange(4)[None, :]).reshape(-1)  # rev[y] = E(s0 + CW - 1 - y)
    words = keys.to(torch.int64) & 0xFFFFFFFF
    e_x = torch.where(x >= 0, words[:, x % n], (-words[:, x % n]) & 0xFFFFFFFF)  # [J, N + CW]
    e, y = torch.arange(8), torch.arange(n)[:, None]
    out = torch.zeros(cols, dtype=torch.int64)
    for k in range(4 - limbs, 4):
        rev = ((e_x >> (8 * k)) & 0xFF).to(torch.float64)
        for h in range(nt):
            b = rev[:, cw - 1 - FOLD_COLS * h - e[None, :] + y]  # [J, N, 8]
            pos = torch.einsum("jfr,jre->fe", a_pos, b).to(torch.int64)
            neg = torch.einsum("jfr,jre->fe", a_neg, b).to(torch.int64)
            if max(int(pos.abs().max()), int(neg.abs().max())) >= 1 << 31:
                raise ValueError("fold limb sum leaves s32")
            out[FOLD_COLS * h:FOLD_COLS * (h + 1)] += (pos - neg).reshape(-1) << (8 * k)
    out &= 0xFFFFFFFF
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


#: Whole-key reads of `key_limbs` (each synchronises the host with the
#: device): one a key tensor, unless a caller hands over a new tensor each call.
_grid_counts = counter("bsk", ("grid_checks",))

#: Keys already checked for the 2^8 grid: id(tensor) -> (weak reference to
#: the tensor, its version counter then, on the grid?).
_grid_checked: dict = {}


def _on_grid(key: torch.Tensor) -> bool:
    _grid_counts["grid_checks"] += 1
    return not bool((key & 0xFF).any())


def key_limbs(key: torch.Tensor, params: TfheParams) -> int:
    """How many byte limbs of a rotation key (`bsk`, or `bsk_mb`, whose
    combinations keep a zero low byte) the tensor cores multiply: 3 where
    the set rounds its key to the 2^8 grid (`bsk_round_bits` = 8) AND this
    key's words really have a zero lowest byte; else 4. A limb the data has
    is never dropped.

    The check reads the whole key and synchronises, so its answer is kept per
    key tensor and version counter: a cloud key's key pays it once. A caller
    that hands over a new tensor object each call (a fresh view or copy of the
    key) pays it each call; so does a key made under `torch.inference_mode()`,
    which has no version counter to tell an edit in place by."""
    if params.bsk_round_bits < 8:
        return 4
    if key.is_inference():
        return 3 if _on_grid(key) else 4
    ident = id(key)
    entry = _grid_checked.get(ident)
    if entry is None or entry[0]() is not key or entry[1] != key._version:
        on_grid = _on_grid(key)
        entry = (weakref.ref(key, lambda _, ident=ident: _grid_checked.pop(ident, None)), key._version, on_grid)
        _grid_checked[ident] = entry
    return 3 if entry[2] else 4


#: Clusters of each size an NVIDIA H100 SXM (132 SMs) holds at one block an
#: SM, as `cluster_slots` read them there: a cluster lives inside one GPC, so
#: large clusters leave SMs idle. For planning without the card (tests).
H100_CLUSTER_SLOTS = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}


@functools.lru_cache(maxsize=None)
def cluster_slots(index: int, log_n: int, held_clusters) -> dict:
    """{cluster size: clusters CUDA device `index` holds at one block an SM}
    at ring size 2^log_n, with the SM count under 1, for the cluster sizes
    the library takes there; `held_clusters(index, log_n, cluster)` is the
    wrapper's occupancy query for its instance. A size the device cannot
    schedule at all is left out."""
    slots = {1: torch.cuda.get_device_properties(index).multi_processor_count}
    cluster = 2
    while cluster <= _build.load().tfhe_blind_rotate_max_cluster(log_n):
        held = held_clusters(index, log_n, cluster)
        if held > 0:
            slots[cluster] = held
        cluster *= 2
    return slots


#: What ranks the rotation kernels' CUDA-core instances, in units of one
#: ciphertext's multiply-adds on one SM (about 49 ms at SECURITY_128_BIT_FAST
#: on an H100), fitted to that set's times on one H100 (PERF.md names the
#: batches): a rotation over a cluster costs tile / cluster * _CLUSTER_FACTOR
#: + the exchange (barriers, decomposition and key staging, about 4 ms
#: whatever the cluster); a single block costs tile * _SINGLE_FACTOR (small
#: tiles load more shared-memory words per multiply-add). The exchange moves
#: N words a step where the product does N^2 multiply-adds, so in these
#: units it is _EXCHANGE at N = 1024 and halves with each doubling of N
#: (read at N = 2048, assumed at 4096); below 1024 it stays _EXCHANGE.
_EXCHANGE = 0.08
_CLUSTER_FACTOR = {2: 1.0, 4: 1.03, 8: 1.07, 16: 1.12}
_SINGLE_FACTOR = {1: 2.1, 2: 1.13, 4: 1.02, 8: 1.0}


def instance_cost(batch: int, tile: int, cluster: int, slots: dict, n: int = 1024) -> tuple:
    """(more than one wave?, waves x cost of one block's rotation) at ring size n."""
    if cluster == 1:
        work = tile * _SINGLE_FACTOR[tile]
    else:
        work = tile / cluster * _CLUSTER_FACTOR[cluster] + _EXCHANGE * 1024 / max(n, 1024)
    waves = -(-(-(-batch // tile)) // slots[cluster])
    return waves > 1, waves * work
