"""What the kernels' wrappers (`ops/cuda_*.py`) share: the operand checks,
the device switch, the tail of a launch, the whole rotation's operand
contract, the clusters a card holds and the cost that ranks the rotation
kernels' CUDA-core instances. No wrapper imports another; each imports this.
"""

from __future__ import annotations

import collections
import contextlib
import functools

import torch

from .. import _build
from ..params import TfheParams


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
