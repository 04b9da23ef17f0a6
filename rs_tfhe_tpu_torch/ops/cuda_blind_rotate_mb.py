"""The multi-bit blind-rotation kernel's wrapper: checks, plan, launch and
launch count.

The kernel (`csrc/blind_rotate_mb.cu`) replaces the TPU kernel
`fused_blind_rotate_small_mb` of rs_tfhe_tpu/ops/pallas_blind_rotate.py; its
plain PyTorch version is `ops.blind_rotate.blind_rotate_mb_plain`. This
wrapper takes CUDA tensors only: it launches the kernel or raises.

The kernel has two instances: a thread-block cluster of `cluster` blocks
that owns a tile of `tile` ciphertexts (1, 2 or 4) and splits the 2N output
columns between its blocks, and, with cluster 1, a single block per tile.
`planned_instance` picks tile and cluster from the batch and from how many
clusters of each size the card holds, in one wave where the batch allows.
`ops.blind_rotate.blind_rotate` sends a multi-bit key here under "auto" only
up to `mb_route_batch_cap` ciphertexts (one cluster each), and at any batch
under "fused_small_mb" (the single blocks once clusters no longer fill the
card in one wave).
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from ..params import TfheParams
from ..utils.profiling import counter
from .cuda_launch import cluster_slots, error_text, instance_cost, launched, on_device, rotation_operands

#: Launches by instance (ring size N, tile, cluster) in this process;
#: cluster 1 is the single-block instance.
launched_tiles = counter("k4.instance", total="k4.launches")
#: Their sum, kept as an int for tfhe_bench/program.py, which reads it.
launches = 0

#: The tiles the instances take (up to their largest at a ring size).
TILES = (1, 2, 4)


def rotation_instance(batch: int, slots: dict, n: int, max_tile: int, max_cluster_tile: int) -> tuple:
    """(tile, cluster) for a batch at ring size n. `slots[c]` is the number
    of clusters of c blocks the card holds at one block an SM (`slots[1]` its
    SM count; sizes it cannot schedule are absent); `max_tile` is the
    single-block instance's largest tile, `max_cluster_tile` the cluster
    instance's. Ranked as the whole-rotation kernel's plan ranks its
    instances (`cuda_blind_rotate.rotation_instance`): waves times the cost
    of one block's rotation (`cuda_launch.instance_cost`), one wave before
    more."""
    candidates = [
        (tile, cluster)
        for cluster in slots
        for tile in TILES
        if tile <= (max_tile if cluster == 1 else max_cluster_tile)
    ]
    return min(candidates, key=lambda tc: (*instance_cost(batch, *tc, slots, n), -tc[1], tc[0]))


@functools.lru_cache(maxsize=None)
def max_active_clusters(index: int, log_n: int, tile: int, cluster: int) -> int:
    """How many clusters of the (tile, cluster) instance CUDA device `index`
    holds at one block an SM (cudaOccupancyMaxActiveClusters, asked with the
    instance's own shared memory). Raises for an instance the kernel does not
    have."""
    with torch.cuda.device(index):
        count = _build.load().tfhe_blind_rotate_mb_max_active_clusters(log_n, tile, cluster)
    if count < 0:
        raise RuntimeError(f"blind_rotate_mb: no instance (tile={tile}, cluster={cluster}) at N=2^{log_n}: "
                           f"{error_text(-count)}")
    return count


def held_clusters(index: int, log_n: int, cluster: int) -> int:
    """Clusters of `cluster` blocks of the cluster instance CUDA device
    `index` holds at one block an SM, asked at its largest tile (the most
    shared memory); 0 at a ring size without the cluster instance. The query
    `cuda_launch.cluster_slots` asks for this kernel."""
    tile = _build.load().tfhe_blind_rotate_mb_max_cluster_tile(log_n)
    return max_active_clusters(index, log_n, tile, cluster) if tile else 0


def planned_instance(index: int, batch: int, params: TfheParams) -> tuple:
    """(tile, cluster) the wrapper launches for a batch on CUDA device
    `index`."""
    lib = _build.load()
    log_n = params.n1.bit_length() - 1
    return rotation_instance(
        batch, cluster_slots(index, log_n, held_clusters), params.n1,
        lib.tfhe_blind_rotate_mb_max_tile(log_n), lib.tfhe_blind_rotate_mb_max_cluster_tile(log_n),
    )


def blind_rotate_mb_kernel(
    b_til: torch.Tensor, a_til: torch.Tensor, testvec: torch.Tensor,
    bsk_mb: torch.Tensor, params: TfheParams, tile: int | None = None, cluster: int | None = None,
) -> torch.Tensor:
    """The whole multi-bit blind rotation on the card.

    b_til: int32 [B] and a_til: int32 [B, n0], the mod-switched exponents in
    [0, 2N); testvec: int32 [2, N] (shared) or [B, 2, N] (per ciphertext);
    bsk_mb: int32 [n0/2, 4, 2L, 2, N] raw torus words, 16-byte aligned.
    Returns int32 [B, 2, N] on the same device, launched on the current
    stream without synchronising. Tile and cluster come from
    `planned_instance`; a cluster the device cannot schedule raises.

    `tile` and `cluster` force an instance and are for tests and measurement
    scripts only; no path of the package sets them. With `tile` given
    `cluster` defaults to 1 (the single-block instance).
    """
    global launches
    g = params.trgsw_lv1
    n0, n = params.n0, params.n1
    if n0 % 2:
        raise ValueError(f"multi-bit grouping needs an even n0, got {n0}")
    out, tv_stride, index = rotation_operands(
        "blind_rotate_mb_kernel", b_til, a_til, testvec, "bsk_mb", bsk_mb, (n0 // 2, 4, 2 * g.l, 2, n), params
    )
    if bsk_mb.data_ptr() % 16:
        raise ValueError("bsk_mb: the cluster instance copies 16-byte words; its data must be 16-byte aligned")
    if index is None:
        return out
    dev, batch = b_til.device, b_til.shape[0]
    lib = _build.load()
    log_n = n.bit_length() - 1
    if tile is None:
        if cluster is not None:
            raise ValueError("blind_rotate_mb_kernel: a cluster needs its tile")
        tile, cluster = planned_instance(index, batch, params)
    elif cluster is None:
        cluster = 1
    if cluster > 1 and max_active_clusters(index, log_n, tile, cluster) < 1:
        raise RuntimeError(
            f"blind_rotate_mb: the device cannot schedule a cluster of {cluster} blocks at N={n}, tile={tile}"
        )
    dec_offset = (params.decomposition_offset + params.decomposition_round_bit) & 0xFFFFFFFF
    with on_device(index):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tfhe_blind_rotate_mb(
            b_til.data_ptr(), a_til.data_ptr(), testvec.data_ptr(), tv_stride,
            bsk_mb.data_ptr(), out.data_ptr(), batch, n0, log_n,
            g.l, g.bgbit, dec_offset, tile, cluster, stream,
        )
    launched(err, launched_tiles, (n, tile, cluster), "blind_rotate_mb kernel launch failed (tile={}, cluster={})",
             tile, cluster)
    launches += 1
    return out
