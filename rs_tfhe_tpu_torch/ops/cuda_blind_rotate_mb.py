"""The multi-bit blind-rotation kernel's wrapper: checks, launch and launch
count.

The kernel (`csrc/blind_rotate_mb.cu`) replaces the TPU kernel
`fused_blind_rotate_small_mb` of rs_tfhe_tpu/ops/pallas_blind_rotate.py; its
plain PyTorch version is `ops.blind_rotate.blind_rotate_mb_plain`. This
wrapper takes CUDA tensors only: it launches the kernel or raises. It takes
any batch size, and `ops.blind_rotate.blind_rotate` routes every batch with
a multi-bit key here.
"""

from __future__ import annotations

import collections

import torch

from .. import _build
from ..params import TfheParams
from .cuda_blind_rotate import check_shapes, check_tensor, fit_tile

#: Launches of the kernel in this process (the wrapper adds one per launch).
launches = 0

#: Launches by (ring size N, tile) in this process, beside `launches`.
launched_tiles: collections.Counter = collections.Counter()


def blind_rotate_mb_kernel(
    b_til: torch.Tensor, a_til: torch.Tensor, testvec: torch.Tensor,
    bsk_mb: torch.Tensor, params: TfheParams, tile: int | None = None,
) -> torch.Tensor:
    """The whole multi-bit blind rotation on the card.

    b_til: int32 [B] and a_til: int32 [B, n0], the mod-switched exponents in
    [0, 2N); testvec: int32 [2, N] (shared) or [B, 2, N] (per ciphertext);
    bsk_mb: int32 [n0/2, 4, 2L, 2, N] raw torus words. Returns int32
    [B, 2, N] on the same device, launched on the current stream without
    synchronising.
    """
    global launches
    if b_til.device.type != "cuda":
        raise ValueError(f"blind_rotate_mb_kernel takes CUDA tensors, got {b_til.device}")
    g = params.trgsw_lv1
    n0, n = params.n0, params.n1
    if n0 % 2:
        raise ValueError(f"multi-bit grouping needs an even n0, got {n0}")
    check_shapes(params)
    dev = b_til.device
    batch = b_til.shape[0]
    check_tensor("b_til", b_til, (batch,), dev)
    check_tensor("a_til", a_til, (batch, n0), dev)
    check_tensor("bsk_mb", bsk_mb, (n0 // 2, 4, 2 * g.l, 2, n), dev)
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
    if tile is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        tile = fit_tile(batch, lib.tfhe_blind_rotate_mb_max_tile(n.bit_length() - 1), sms)
    dec_offset = (params.decomposition_offset + params.decomposition_round_bit) & 0xFFFFFFFF
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tfhe_blind_rotate_mb(
            b_til.data_ptr(), a_til.data_ptr(), testvec.data_ptr(), tv_stride,
            bsk_mb.data_ptr(), out.data_ptr(), batch, n0, n.bit_length() - 1,
            g.l, g.bgbit, dec_offset, tile, stream,
        )
    if err != 0:
        msg = lib.tfhe_cuda_error_string(err).decode()
        raise RuntimeError(f"blind_rotate_mb kernel launch failed (tile={tile}): {msg} ({err})")
    launches += 1
    launched_tiles[(n, tile)] += 1
    return out
