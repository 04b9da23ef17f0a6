"""The blind-rotation kernel's wrapper: checks, launch and launch count.

The kernel (`csrc/blind_rotate.cu`) replaces the TPU kernels
`fused_blind_rotate`, `fused_blind_rotate_wide` and `fused_blind_rotate_small`
of rs_tfhe_tpu/ops/pallas_blind_rotate.py with one Hopper kernel for their
common function; its plain PyTorch version is
`ops.blind_rotate.blind_rotate_plain`. This wrapper takes CUDA tensors only:
it launches the kernel or raises.

The kernel has three instances. On the CUDA cores (32-bit multiply-adds) a
thread-block cluster of `cluster` blocks owns a tile of `tile` ciphertexts
and splits the 2N output columns between its blocks (one ciphertext on up to
16 SMs); with cluster 1 a single block owns the tile. `rotation_instance`
picks tile and cluster from the batch and from how many clusters of each
size the card holds, in one wave where the batch allows. On the tensor cores
(N = 1024 and 2048, single-limb digits) a cluster of 2N / 256 blocks owns 16
ciphertexts, or 32 at N = 1024 with a three-limb key and L = 2, and multiplies s8 digits by the key's
byte limbs; `rotation_unit` takes it from the batch where its waves cost
less, and `key_limbs` counts the limbs from the key itself.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import weakref

import torch

from .. import _build
from ..params import TfheParams

#: Launches of the kernel in this process (the wrapper adds one per launch).
launches = 0

#: Launches by instance (ring size N, tile, cluster, unit) in this process,
#: beside `launches`: which instantiations of the kernel ran. The unit is
#: "imad" (32-bit multiply-adds on the CUDA cores) or "mma_s8x3" / "mma_s8x4"
#: (s8 limb products on the tensor cores with 3 or 4 key limbs).
launched_tiles: collections.Counter = collections.Counter()

#: Keys already checked for the 2^8 grid: id(tensor) -> (weak reference to
#: the tensor, its version counter then, on the grid?).
_grid_checked: dict = {}


def key_limbs(bsk: torch.Tensor, params: TfheParams) -> int:
    """How many byte limbs of the key the tensor-core instance multiplies: 3
    where the set rounds its key to the 2^8 grid (`bsk_round_bits` = 8) AND
    this key's words really have a zero lowest byte; else 4. A limb the data
    has is never dropped.

    The check reads the whole key and synchronises, so its answer is kept per
    key tensor and version counter: a cloud key's `bsk` pays it once. A caller
    that hands over a new tensor object each call (a fresh view or copy of the
    key) pays it each call; so does a key made under `torch.inference_mode()`,
    which has no version counter to tell an edit in place by."""
    if params.bsk_round_bits < 8:
        return 4
    if bsk.is_inference():
        return 4 if bool((bsk & 0xFF).any()) else 3
    ident = id(bsk)
    entry = _grid_checked.get(ident)
    if entry is None or entry[0]() is not bsk or entry[1] != bsk._version:
        on_grid = not bool((bsk & 0xFF).any())
        entry = (weakref.ref(bsk, lambda _, ident=ident: _grid_checked.pop(ident, None)), bsk._version, on_grid)
        _grid_checked[ident] = entry
    return 3 if entry[2] else 4


#: Clusters of each size an NVIDIA H100 SXM (132 SMs) holds at one block an
#: SM, as `cluster_slots` read them there: a cluster lives inside one GPC, so
#: large clusters leave SMs idle. For planning without the card (tests).
H100_CLUSTER_SLOTS = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}

#: What ranks the candidates, in units of one ciphertext's multiply-adds on
#: one SM (about 49 ms at SECURITY_128_BIT_FAST on an H100), fitted to that
#: set's times on one H100 (PERF.md names the batches): a rotation over a
#: cluster costs tile / cluster * _CLUSTER_FACTOR + the exchange (barriers,
#: decomposition and key staging, about 4 ms whatever the cluster); a single
#: block costs tile * _SINGLE_FACTOR (small tiles load more shared-memory
#: words per multiply-add). The exchange moves N words a step where the
#: product does N^2 multiply-adds, so in these units it is _EXCHANGE at
#: N = 1024 and halves with each doubling of N (`_exchange`; read at N = 2048,
#: assumed at 4096); below 1024 it stays _EXCHANGE.
_EXCHANGE = 0.08
_CLUSTER_FACTOR = {2: 1.0, 4: 1.03, 8: 1.07, 16: 1.12}
_SINGLE_FACTOR = {1: 2.1, 2: 1.13, 4: 1.02, 8: 1.0}

#: The tensor-core instance: a cluster of 2N / 256 blocks at N = 1024 and 2048
#: (at 4096 the digits of 16 ciphertexts exceed a block's shared memory); 16
#: ciphertexts a cluster, or 32 at N = 1024 where the key has three limbs and
#: L = 2 (more limbs exceed the registers, more gadget rows the shared
#: memory). Its cost per rotation by tile on a cluster of 8, in the same units
#: (about 19 and 31 ms at SECURITY_128_BIT_FAST); a cluster of 16 has half the
#: rows a block and costs half (`_mma_cost`).
MMA_COLS, MMA_RING_SIZES = 256, (1024, 2048)
_MMA_WORK = {16: 0.4, 32: 0.64}


def _exchange(n: int) -> float:
    return _EXCHANGE * 1024 / max(n, 1024)


def mma_tiles(params: TfheParams, limbs: int) -> tuple:
    """The tiles the tensor-core instance has for this set and key."""
    return (16, 32) if limbs == 3 and params.trgsw_lv1.l == 2 and params.n1 == 1024 else (16,)


def limb_accumulator_bound(params: TfheParams) -> int:
    """The largest magnitude one s32 limb accumulator of the tensor-core
    product can reach: 2L * N terms of |digit| <= Bg/2 times a byte <= 255."""
    g = params.trgsw_lv1
    return 2 * g.l * params.n1 * g.half_bg * 255


def takes_tensor_cores(params: TfheParams) -> bool:
    """Whether the limb product serves this set: digits of one s8 limb and
    limb sums that stay inside s32."""
    return params.trgsw_lv1.bgbit <= 8 and limb_accumulator_bound(params) < 1 << 31


def rotation_unit(
    batch: int, params: TfheParams, instance: tuple, slots: dict, limbs: int = 4, held: dict | None = None
) -> tuple:
    """(tile, cluster, on the tensor cores?) for a batch: the tensor-core
    instance (at its cheaper tile for a key of `limbs` limbs) where the set
    and ring size have it and its waves cost less than the CUDA-core
    `instance` (tile, cluster) that `rotation_instance` picked. `held` is
    {tile: clusters of the tensor-core instance the card holds at once}
    (`mma_slots`: asked with that instance's own shared memory); without it,
    for planning without the card, every tile gets `slots[cluster]`."""
    cluster = 2 * params.n1 // MMA_COLS
    if params.n1 not in MMA_RING_SIZES or not takes_tensor_cores(params):
        return (*instance, False)
    if held is None:
        held = {tile: slots.get(cluster, 0) for tile in mma_tiles(params, limbs)}
    if not any(held.values()):
        return (*instance, False)
    cost, tile = _mma_cost(batch, held, cluster)
    if cost < _instance_cost(batch, *instance, slots, params.n1)[1]:
        return (tile, cluster, True)
    return (*instance, False)


def _mma_cost(batch: int, held: dict, cluster: int) -> tuple:
    """(waves x cost of one wave, tile) of the tensor-core instance's cheaper
    tile for a batch on clusters of `cluster` blocks; `held[tile]` of them
    are on the card at once (a tile with none is no candidate)."""
    return min(
        (-(-(-(-batch // tile)) // n) * _MMA_WORK[tile] * 8 / cluster, tile) for tile, n in held.items() if n > 0
    )


def _instance_cost(batch: int, tile: int, cluster: int, slots: dict, n: int = 1024) -> tuple:
    """(more than one wave?, waves x cost of one block's rotation) at ring size n."""
    if cluster == 1:
        work = tile * _SINGLE_FACTOR[tile]
    else:
        work = tile / cluster * _CLUSTER_FACTOR[cluster] + _exchange(n)
    waves = -(-(-(-batch // tile)) // slots[cluster])
    return waves > 1, waves * work


def rotation_instance(batch: int, max_tile: int, slots: dict, n: int = 1024) -> tuple:
    """(tile, cluster) of the CUDA-core instances for a batch at ring size n. `slots[c]` is
    the number of clusters of c blocks the card holds at one block an SM
    (`slots[1]` its SM count; sizes the ring size does not take are absent). A candidate's cost is its waves,
    ceil(ceil(batch / tile) / slots), times the cost of one block's rotation;
    candidates that run in one wave win over those that do not. Clusters
    take any tile up to `max_tile`, single blocks powers of two."""
    best = None
    for cluster in slots:
        for tile in range(1, max_tile + 1):
            if cluster == 1 and tile & (tile - 1):
                continue
            key = (*_instance_cost(batch, tile, cluster, slots, n), -cluster, tile)
            if best is None or key < best[0]:
                best = (key, (tile, cluster))
    return best[1]


@functools.lru_cache(maxsize=None)
def cluster_slots(index: int, log_n: int) -> dict:
    """{cluster size: clusters CUDA device `index` holds at one block an SM}
    for the CUDA-core instances' cluster sizes at ring size 2^log_n, with the
    SM count under 1. A size the device cannot schedule at all is left out."""
    lib = _build.load()
    slots = {1: torch.cuda.get_device_properties(index).multi_processor_count}
    cluster = 2
    while cluster <= lib.tfhe_blind_rotate_max_cluster(log_n):
        held = max_active_clusters(index, log_n, 1, cluster)
        if held > 0:
            slots[cluster] = held
        cluster *= 2
    return slots


def mma_slots(index: int, params: TfheParams, limbs: int) -> dict:
    """{tile: clusters of the tensor-core instance CUDA device `index` holds
    at once} for this set and a key of `limbs` limbs, each tile asked with the
    shared memory it is launched with (its 2L digit planes included). A tile
    whose shared memory exceeds a block's counts 0."""
    log_n, cluster = params.n1.bit_length() - 1, 2 * params.n1 // MMA_COLS
    return {
        tile: max_active_clusters(index, log_n, tile, cluster, limbs, params.trgsw_lv1.l)
        for tile in mma_tiles(params, limbs)
    }


def planned_instance(index: int, batch: int, params: TfheParams, limbs: int) -> tuple:
    """(tile, cluster, limbs) the wrapper launches for a batch on CUDA device
    `index`: tile and cluster from the clusters the device holds, the unit
    from the set; `limbs` is `key_limbs` of the key, or 0 to stay on the
    CUDA cores (0 comes back wherever they are taken)."""
    log_n = params.n1.bit_length() - 1
    slots = cluster_slots(index, log_n)
    instance = rotation_instance(batch, _build.load().tfhe_blind_rotate_max_tile(log_n), slots, params.n1)
    if not limbs or params.n1 not in MMA_RING_SIZES or not takes_tensor_cores(params):
        return (*instance, 0)
    tile, cluster, tensor_cores = rotation_unit(batch, params, instance, slots, limbs, mma_slots(index, params, limbs))
    return tile, cluster, limbs if tensor_cores else 0


@functools.lru_cache(maxsize=None)
def max_active_clusters(index: int, log_n: int, tile: int, cluster: int, limbs: int = 0, l: int = 0) -> int:
    """How many clusters of this instance CUDA device `index` holds at one
    block an SM (cudaOccupancyMaxActiveClusters); `limbs` 0 for the CUDA-core
    instances; 3 or 4 for the tensor-core one, with the set's gadget length
    `l`, which sizes its shared memory. Raises for an instance the kernel
    does not have."""
    lib = _build.load()
    with torch.cuda.device(index):
        count = lib.tfhe_blind_rotate_max_active_clusters(log_n, tile, cluster, limbs, l)
    if count < 0:
        msg = lib.tfhe_cuda_error_string(-count).decode()
        raise RuntimeError(f"blind_rotate: no instance (tile={tile}, cluster={cluster}) at N=2^{log_n}: {msg}")
    return count


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


def blind_rotate_kernel(
    b_til: torch.Tensor, a_til: torch.Tensor, testvec: torch.Tensor,
    bsk: torch.Tensor, params: TfheParams, tile: int | None = None, cluster: int | None = None,
    tensor_cores: bool | None = None,
) -> torch.Tensor:
    """The whole blind rotation on the card.

    b_til: int32 [B] and a_til: int32 [B, n0], the mod-switched exponents in
    [0, 2N); testvec: int32 [2, N] (shared) or [B, 2, N] (per ciphertext);
    bsk: int32 [n0, 2L, 2, N] raw torus words. Returns int32 [B, 2, N] on the
    same device, launched on the current stream without synchronising. Tile,
    cluster and unit come from `planned_instance`; a cluster shape the device
    cannot schedule raises.

    `tile`, `cluster` and `tensor_cores` force an instance and are for tests
    and measurement scripts only; no path of the package sets them. With
    `tile` given `cluster` defaults to 1 and the CUDA cores are used;
    `tensor_cores=True` takes the tensor-core instance (at `tile` 16 or 32 if
    given) and raises for a set, ring size or key without it; False keeps the
    plan on the CUDA cores.
    """
    global launches
    if b_til.device.type != "cuda":
        raise ValueError(f"blind_rotate_kernel takes CUDA tensors, got {b_til.device}")
    g = params.trgsw_lv1
    n0, n = params.n0, params.n1
    check_shapes(params)
    dev = b_til.device
    batch = b_til.shape[0]
    check_tensor("b_til", b_til, (batch,), dev)
    check_tensor("a_til", a_til, (batch, n0), dev)
    check_tensor("bsk", bsk, (n0, 2 * g.l, 2, n), dev)
    if testvec.dim() == 2:
        check_tensor("testvec", testvec, (2, n), dev)
        tv_stride = 0
    else:
        check_tensor("testvec", testvec, (batch, 2, n), dev)
        tv_stride = 2 * n
    out = torch.empty((batch, 2, n), dtype=torch.int32, device=dev)
    if batch == 0:
        return out
    lib = _build.load()
    log_n = n.bit_length() - 1
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    limbs = 0
    if tensor_cores:
        if cluster is not None:
            raise ValueError("blind_rotate_kernel: the tensor-core instance has one cluster size")
        if n not in MMA_RING_SIZES or not takes_tensor_cores(params):
            raise ValueError(f"blind_rotate_kernel: no tensor-core instance for N={n}, bgbit={g.bgbit}")
        limbs, cluster = key_limbs(bsk, params), 2 * n // MMA_COLS
        held = mma_slots(index, params, limbs)
        if tile is None:
            if not any(held.values()):
                raise RuntimeError(f"blind_rotate: the device holds no tensor-core cluster of {cluster} blocks at N={n}")
            tile = _mma_cost(batch, held, cluster)[1]
        elif tile not in held:
            raise ValueError(f"blind_rotate_kernel: the tensor-core instance has tiles {tuple(held)} here, not {tile}")
    elif tile is None:
        if cluster is not None:
            raise ValueError("blind_rotate_kernel: a cluster needs its tile")
        if tensor_cores is None and n in MMA_RING_SIZES and takes_tensor_cores(params):
            limbs = key_limbs(bsk, params)
        tile, cluster, limbs = planned_instance(index, batch, params, limbs)
    elif cluster is None:
        cluster = 1
    if cluster > 1 and max_active_clusters(index, log_n, tile, cluster, limbs, g.l if limbs else 0) < 1:
        raise RuntimeError(
            f"blind_rotate: the device cannot schedule a cluster of {cluster} blocks at N={n}, tile={tile}"
        )
    dec_offset = (params.decomposition_offset + params.decomposition_round_bit) & 0xFFFFFFFF
    with on_device(index):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tfhe_blind_rotate(
            b_til.data_ptr(), a_til.data_ptr(), testvec.data_ptr(), tv_stride,
            bsk.data_ptr(), out.data_ptr(), batch, n0, log_n,
            g.l, g.bgbit, dec_offset, tile, cluster, limbs, stream,
        )
    if err != 0:
        msg = lib.tfhe_cuda_error_string(err).decode()
        raise RuntimeError(f"blind_rotate kernel launch failed (tile={tile}, cluster={cluster}): {msg} ({err})")
    launches += 1
    launched_tiles[(n, tile, cluster, f"mma_s8x{limbs}" if limbs else "imad")] += 1
    return out
