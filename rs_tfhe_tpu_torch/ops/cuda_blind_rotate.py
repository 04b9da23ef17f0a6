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
size the card holds, in one wave where the batch allows. A cluster's tile of
one ciphertext multiplies on the tensor cores instead where the set allows
(`cuda_launch.takes_fold`: the fold, s8 digits against the key's byte limbs,
N >= 1024), with the same exchange. On the tensor cores
(N = 1024 and 2048, single-limb digits) a cluster of 2N / 256 blocks owns 16
ciphertexts, or 32 at N = 1024 with a three-limb key and L = 2, and multiplies s8 digits by the key's
byte limbs; `rotation_unit` takes it from the batch where its waves cost
less, and `key_limbs` counts the limbs from the key itself. With 32 rows (N =
1024, three limbs) the product runs on wgmma, the key read through a
descriptor from a diagonal strip (`strip_product_plain` states the
addressing, `key_strips_plain` the strips), the strips built from the key
and kept for the last key a device (`key_strips`); the 16-row instances run
on mma.sync.
"""

from __future__ import annotations

import functools
import weakref

import torch

from .. import _build
from ..params import TfheParams
from ..utils.profiling import counter
from .cuda_launch import (FOLD_MIN_RING, cluster_slots, error_text, fold_unit, instance_cost, key_limbs, launched,
                          on_device, rotation_operands, takes_fold, takes_tensor_cores)

#: Launches by instance (ring size N, tile, cluster, unit) in this process:
#: which instantiations of the kernel ran. The unit is "imad" (32-bit
#: multiply-adds on the CUDA cores), "wgmma_s8x3" (s8 limb products on wgmma
#: with 3 key limbs), "mma_s8x3" / "mma_s8x4" (on mma.sync with 3 or 4 key
#: limbs; `tensor_core_unit` of what launched) or "mma_fold_s8x3" /
#: "mma_fold_s8x4" (the fold of a cluster instance's tile of one ciphertext:
#: `cuda_launch.fold_unit`).
launched_tiles = counter("k1.instance", total="k1.launches")
#: Their sum, kept as an int for tfhe_bench/program.py, which reads it.
launches = 0

#: Builds of the wgmma instance's strips (`key_strips`); `bsk.grid_checks`,
#: the whole-key reads of `key_limbs`, counts beside them.
_key_counts = counter("bsk", ("strip_builds",))


#: The tensor-core instance: a cluster of 2N / 256 blocks at N = 1024 and 2048
#: (at 4096 the digits of 16 ciphertexts exceed a block's shared memory); 16
#: ciphertexts a cluster, or 32 at N = 1024 where the key has three limbs and
#: L = 2 (more limbs exceed the registers, more gadget rows the shared
#: memory). Its cost per rotation by tile on a cluster of 8, in the units of
#: `cuda_launch.instance_cost` (about 19 and 31 ms at SECURITY_128_BIT_FAST);
#: a cluster of 16 has half the rows a block and costs half (`_mma_cost`).
MMA_COLS, MMA_RING_SIZES = 256, (1024, 2048)
_MMA_WORK = {16: 0.4, 32: 0.64}

#: The strips of the last key each device's wgmma instance ran with: device
#: index -> (weak reference to the key, its version then, the strips). One
#: key's strips a device, however many keys are resident.
_strips: dict = {}


@functools.lru_cache(maxsize=None)
def on_wgmma(n: int, tile: int, limbs: int) -> bool:
    """Whether the library runs the tensor-core instance of this ring size,
    tile and key limbs on wgmma (the key read from its strips) rather than on
    mma.sync: it names a strip size for those alone (`has_wgmma_instance` in
    csrc/blind_rotate.cu decides; 32 rows at N = 1024 with three limbs)."""
    return _build.load().tfhe_blind_rotate_strip_bytes(n.bit_length() - 1, 1, 1, tile, limbs) > 0


def tensor_core_unit(wgmma: bool, limbs: int) -> str:
    """The unit name `launched_tiles` gives the tensor-core instance: on
    wgmma (`on_wgmma`) or on mma.sync, with `limbs` key limbs."""
    return f"{'wgmma' if wgmma else 'mma'}_s8x{limbs}"


def _drop_strips(index: int, ref: weakref.ref) -> None:
    """A key died: its device's strips go with it, unless they are already
    another key's."""
    if _strips.get(index, (None,))[0] is ref:
        del _strips[index]


def key_strips(bsk: torch.Tensor, params: TfheParams, tile: int, limbs: int) -> torch.Tensor | None:
    """The key's operand for the wgmma instance: for every step, gadget row,
    polynomial and key limb, the diagonal strip of the polynomial (uint8,
    built on the key's device by the library's strip kernel, 23.8 times the
    key's bytes: 546 MB at SECURITY_128_BIT_FAST); `key_strips_plain` builds
    the same bytes. None for an instance that reads the key itself.

    Kept for the last key a device ran, by tensor and version counter as
    `key_limbs` keeps its answer: a call with another key frees the kept
    strips before it builds its own, so the device holds one key's strips
    whatever the number of keys, and alternating keys pay a build a switch
    (PERF.md). A key made under `torch.inference_mode()` has no version
    counter and is built anew each call."""
    if not on_wgmma(params.n1, tile, limbs):
        return None
    index = bsk.device.index
    entry = None if bsk.is_inference() else _strips.get(index)
    if entry is not None and entry[0]() is bsk and entry[1] == bsk._version:
        return entry[2]
    _strips.pop(index, None)
    lib = _build.load()
    g, log_n = params.trgsw_lv1, params.n1.bit_length() - 1
    size = lib.tfhe_blind_rotate_strip_bytes(log_n, params.n0, g.l, tile, limbs)
    strips = torch.empty(size, dtype=torch.uint8, device=bsk.device)
    with on_device(bsk.device.index):
        err = lib.tfhe_blind_rotate_strips(bsk.data_ptr(), strips.data_ptr(), params.n0, log_n, g.l, tile, limbs,
                                           torch.cuda.current_stream(bsk.device).cuda_stream)
    launched(err, _key_counts, "strip_builds", "blind_rotate: strip build failed")
    if not bsk.is_inference():
        _strips[index] = (weakref.ref(bsk, functools.partial(_drop_strips, index)), bsk._version, strips)
    return strips


def poly_strip_plain(poly: torch.Tensor, limb: int) -> torch.Tensor:
    """The diagonal strip of key limb `limb` (0: the lowest byte) of each
    polynomial of `poly` (int32 [..., N]), as the library's strip kernel
    builds it: 2N / 8 - 2 core matrices of 128 bytes whose row x (16 bytes at
    16 x) is rev[x .. x + 15], with rev[z] = byte `limb` of ext[2N - 1 - z] and
    ext = [-p, p]. Returns uint8 [..., (2N - 16) * 16]."""
    n, dev = poly.shape[-1], poly.device
    words = poly.to(torch.int64) & 0xFFFFFFFF
    rev = (torch.cat([(-words) & 0xFFFFFFFF, words], dim=-1).flip(-1) >> (8 * limb)) & 0xFF
    rows = torch.arange(2 * n - 16, device=dev)[:, None] + torch.arange(16, device=dev)
    return rev[..., rows].reshape(*poly.shape[:-1], -1).to(torch.uint8)


def key_strips_plain(bsk: torch.Tensor, limbs: int) -> torch.Tensor:
    """The bytes `key_strips` builds on the card: the strips of bsk (int32
    [n0, 2L, 2, N]) for key limbs 4 - limbs .. 3, in the order (step, gadget
    row, polynomial, limb), flat."""
    return torch.stack([poly_strip_plain(bsk, k) for k in range(4 - limbs, 4)], dim=-2).reshape(-1)


def strip_product_plain(
    digits: torch.Tensor, poly: torch.Tensor, s0: int = 0, cols: int = MMA_COLS, limbs: int = 4
) -> torch.Tensor:
    """One gadget row's product for a block's `cols` output columns [s0, s0 +
    cols) of one polynomial, by the wgmma instance's addressing: for each key
    limb, the block's strip, the run of the polynomial's strip
    (`poly_strip_plain`) from core matrix (N - cols - s0) / 8 on, whose core
    matrix delta has row r = rev[8 delta + r .. 8 delta + r + 15] for the
    block's reversed window rev[y] = byte(ext[s0 + cols - 1 + N - y]); the key
    operand A[mu, m] (column s0 + cols - 1 - mu, digit m) read as byte (mu %
    8) * 16 + m % 16 of core matrix (mu / 8, m / 16) at byte (mu / 8 + 2 (m /
    16)) * 128 of the block's strip; the digits read from their core-matrix
    plane at `digit_offset(rows, n, m)`; one s32 product per limb (raises
    where a limb sum would leave s32), shifted by its weight and summed mod
    2^32.

    digits: int [rows, N] with |d| <= 128, rows a multiple of 8; poly: int32
    [N]; s0 + cols <= N, both multiples of 8. Returns int32 [rows, cols].
    `limbs` < 4 drops the key's low bytes, as the kernel does for a key on the
    2^8 grid. For tests: `ops.poly.polymul_small_by_torus` is the plain
    product."""
    rows, n = digits.shape
    if rows % 8 or cols % 8 or s0 % 8 or n % 16 or s0 + cols > n:
        raise ValueError(f"strip_product_plain: rows {rows}, cols {cols} at s0={s0}, N={n}")
    dev = digits.device
    mu, m = torch.arange(cols, device=dev), torch.arange(n, device=dev)
    a_at = ((mu[:, None] // 8 + 2 * (m[None, :] // 16)) * 128 + (mu[:, None] % 8) * 16 + m[None, :] % 16)
    plane = torch.zeros(rows * n, dtype=torch.float64, device=dev)
    nn = torch.arange(rows, device=dev)[:, None]
    plane[digit_offset(rows, nn, m[None, :])] = digits.to(torch.float64)
    b_op = plane[digit_offset(rows, nn, m[None, :])]  # [rows, N], read back from its core matrices
    out = torch.zeros((cols, rows), dtype=torch.int64, device=dev)
    for k in range(4 - limbs, 4):
        strip = poly_strip_plain(poly, k)[(n - cols - s0) // 8 * 128:]  # the block's run
        # float64 carries these integers exactly (|S_k| < 2^53) and has a matmul on every device
        s_k = (strip[a_at].to(torch.float64) @ b_op.T).to(torch.int64)
        if int(s_k.abs().max()) >= 1 << 31:
            raise ValueError("limb accumulator leaves s32")
        out += s_k << (8 * k)
    out = out.flip(0).T & 0xFFFFFFFF  # descending columns back to ascending
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def digit_offset(rows: int, n, m):
    """Byte offset of digit m of row n in a digit plane of `rows` rows, as
    the decomposition writes it and wgmma reads it (core matrices of 8 rows x
    16 digits, row-group fastest): `nm::digit_offset` of the kernel."""
    return ((m // 16) * (rows // 8) + n // 8) * 128 + (n % 8) * 16 + m % 16


def mma_tiles(params: TfheParams, limbs: int) -> tuple:
    """The tiles the tensor-core instance has for this set and key."""
    return (16, 32) if limbs == 3 and params.trgsw_lv1.l == 2 and params.n1 == 1024 else (16,)


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
    if cost < instance_cost(batch, *instance, slots, params.n1)[1]:
        return (tile, cluster, True)
    return (*instance, False)


def _mma_cost(batch: int, held: dict, cluster: int) -> tuple:
    """(waves x cost of one wave, tile) of the tensor-core instance's cheaper
    tile for a batch on clusters of `cluster` blocks; `held[tile]` of them
    are on the card at once (a tile with none is no candidate)."""
    return min(
        (-(-(-(-batch // tile)) // n) * _MMA_WORK[tile] * 8 / cluster, tile) for tile, n in held.items() if n > 0
    )


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
            key = (*instance_cost(batch, tile, cluster, slots, n), -cluster, tile)
            if best is None or key < best[0]:
                best = (key, (tile, cluster))
    return best[1]


def held_clusters(index: int, log_n: int, cluster: int) -> int:
    """Clusters of `cluster` blocks of the CUDA-core instances CUDA device
    `index` holds at one block an SM: the query `cuda_launch.cluster_slots`
    asks for this kernel."""
    return max_active_clusters(index, log_n, 1, cluster)


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
    CUDA cores (0 comes back wherever they are taken). With limbs the tile
    is the tensor-core instance's (16 or 32), or 1 on a cluster: the fold."""
    log_n = params.n1.bit_length() - 1
    slots = cluster_slots(index, log_n, held_clusters)
    instance = rotation_instance(batch, _build.load().tfhe_blind_rotate_max_tile(log_n), slots, params.n1)
    if not limbs or not takes_tensor_cores(params):
        return (*instance, 0)
    if params.n1 in MMA_RING_SIZES:
        tile, cluster, tensor_cores = rotation_unit(
            batch, params, instance, slots, limbs, mma_slots(index, params, limbs))
        if tensor_cores:
            return tile, cluster, limbs
    return (*instance, limbs if takes_fold(params, *instance) else 0)


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
        raise RuntimeError(f"blind_rotate: no instance (tile={tile}, cluster={cluster}) at N=2^{log_n}: "
                           f"{error_text(-count)}")
    return count


def blind_rotate_kernel(
    b_til: torch.Tensor, a_til: torch.Tensor, testvec: torch.Tensor,
    bsk: torch.Tensor, params: TfheParams, tile: int | None = None, cluster: int | None = None,
    tensor_cores: bool | None = None,
) -> torch.Tensor:
    """The whole blind rotation on the card.

    b_til: int32 [B] and a_til: int32 [B, n0], the mod-switched exponents in
    [0, 2N); testvec: int32 [2, N] (shared) or [B, 2, N] (per ciphertext);
    bsk: int32 [n0, 2L, 2, N] raw torus words, 16-byte aligned where the
    fold runs. Returns int32 [B, 2, N] on the same device, launched on the
    current stream without synchronising. Tile, cluster and unit come from
    `planned_instance`; a cluster shape the device cannot schedule raises.

    `tile`, `cluster` and `tensor_cores` force an instance and are for tests
    and measurement scripts only; no path of the package sets them. With
    `tile` given `cluster` defaults to 1; a tile of one on a cluster takes the
    fold where `takes_fold` allows, the CUDA cores otherwise.
    `tensor_cores=True` takes the tensor-core instance (at `tile` 16 or 32 if
    given) and raises for a set, ring size or key without it; False keeps
    every tile on the CUDA cores, the fold's included.
    """
    global launches
    g = params.trgsw_lv1
    n0, n = params.n0, params.n1
    out, tv_stride, index = rotation_operands(
        "blind_rotate_kernel", b_til, a_til, testvec, "bsk", bsk, (n0, 2 * g.l, 2, n), params
    )
    if index is None:
        return out
    dev, batch = b_til.device, b_til.shape[0]
    lib = _build.load()
    log_n = n.bit_length() - 1
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
        if tensor_cores is None and n >= FOLD_MIN_RING and takes_tensor_cores(params):
            limbs = key_limbs(bsk, params)
        tile, cluster, limbs = planned_instance(index, batch, params, limbs)
    else:
        cluster = 1 if cluster is None else cluster
        if tensor_cores is None and takes_fold(params, tile, cluster):
            limbs = key_limbs(bsk, params)
    if cluster > 1 and max_active_clusters(index, log_n, tile, cluster, limbs, g.l if limbs else 0) < 1:
        raise RuntimeError(
            f"blind_rotate: the device cannot schedule a cluster of {cluster} blocks at N={n}, tile={tile}"
        )
    if limbs and tile == 1 and bsk.data_ptr() % 16:
        raise ValueError("bsk: the fold reads the key in 16-byte words; its data must be 16-byte aligned")
    dec_offset = (params.decomposition_offset + params.decomposition_round_bit) & 0xFFFFFFFF
    strips = key_strips(bsk, params, tile, limbs) if limbs else None
    with on_device(index):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tfhe_blind_rotate(
            b_til.data_ptr(), a_til.data_ptr(), testvec.data_ptr(), tv_stride,
            bsk.data_ptr(), strips.data_ptr() if strips is not None else None, out.data_ptr(), batch, n0, log_n,
            g.l, g.bgbit, dec_offset, tile, cluster, limbs, stream,
        )
    unit = "imad" if not limbs else fold_unit(limbs) if tile == 1 else tensor_core_unit(strips is not None, limbs)
    launched(err, launched_tiles, (n, tile, cluster, unit), "blind_rotate kernel launch failed (tile={}, cluster={})",
             tile, cluster)
    if strips is not None:  # another key's strips may take its memory once this stream has read it
        strips.record_stream(torch.cuda.current_stream(dev))
    launches += 1
    return out
