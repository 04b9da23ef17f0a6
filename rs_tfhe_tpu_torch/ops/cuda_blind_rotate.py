"""The blind-rotation kernel's wrapper: checks, launch and launch count.

The kernel (`csrc/blind_rotate.cu`) replaces the TPU kernels
`fused_blind_rotate`, `fused_blind_rotate_wide` and `fused_blind_rotate_small`
of rs_tfhe_tpu/ops/pallas_blind_rotate.py with one Hopper kernel for their
common function; its plain PyTorch version is
`ops.blind_rotate.blind_rotate_plain`. This wrapper takes CUDA tensors only:
it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .. import _build
from ..params import TfheParams

#: Launches of the kernel in this process (the wrapper adds one per launch).
launches = 0

#: Largest batch tile per ring size, as `max_tile` in the kernel source: at
#: N >= 2048 the block's N/4 threads leave fewer registers for the T x 8
#: accumulators each thread holds.
_MAX_TILE = {2048: 4, 4096: 2}


def select_tile(batch: int, n: int, sm_count: int) -> int:
    """Ciphertexts per block: the largest tile (up to the ring size's cap)
    that still gives every SM a block; smaller tiles cost more shared-memory
    loads per multiply-add but keep the card full at small batches."""
    tile = _MAX_TILE.get(n, 8)
    while tile > 1 and -(-batch // tile) < sm_count:
        tile //= 2
    return tile


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.int32")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def blind_rotate_kernel(
    b_til: torch.Tensor, a_til: torch.Tensor, testvec: torch.Tensor,
    bsk: torch.Tensor, params: TfheParams, tile: int | None = None,
) -> torch.Tensor:
    """The whole blind rotation on the card.

    b_til: int32 [B] and a_til: int32 [B, n0], the mod-switched exponents in
    [0, 2N); testvec: int32 [2, N] (shared) or [B, 2, N] (per ciphertext);
    bsk: int32 [n0, 2L, 2, N] raw torus words. Returns int32 [B, 2, N] on the
    same device, launched on the current stream without synchronising.
    """
    global launches
    if b_til.device.type != "cuda":
        raise ValueError(f"blind_rotate_kernel takes CUDA tensors, got {b_til.device}")
    g = params.trgsw_lv1
    n0, n = params.n0, params.n1
    if n & (n - 1) or not 64 <= n <= 4096:
        raise ValueError(f"ring size N={n}: the kernel takes powers of two in [64, 4096]")
    if not 1 <= g.bgbit <= 31 or g.l * g.bgbit > 32:
        raise ValueError(f"gadget bgbit={g.bgbit}, L={g.l} outside the kernel's range")
    dev = b_til.device
    batch = b_til.shape[0]
    _check("b_til", b_til, (batch,), dev)
    _check("a_til", a_til, (batch, n0), dev)
    _check("bsk", bsk, (n0, 2 * g.l, 2, n), dev)
    if testvec.dim() == 2:
        _check("testvec", testvec, (2, n), dev)
        tv_stride = 0
    else:
        _check("testvec", testvec, (batch, 2, n), dev)
        tv_stride = 2 * n
    out = torch.empty((batch, 2, n), dtype=torch.int32, device=dev)
    if batch == 0:
        return out
    if tile is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        tile = select_tile(batch, n, sms)
    lib = _build.load()
    dec_offset = (params.decomposition_offset + params.decomposition_round_bit) & 0xFFFFFFFF
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tfhe_blind_rotate(
            b_til.data_ptr(), a_til.data_ptr(), testvec.data_ptr(), tv_stride,
            bsk.data_ptr(), out.data_ptr(), batch, n0, n.bit_length() - 1,
            g.l, g.bgbit, dec_offset, tile, stream,
        )
    if err != 0:
        msg = lib.tfhe_cuda_error_string(err).decode()
        raise RuntimeError(f"blind_rotate kernel launch failed (tile={tile}): {msg} ({err})")
    launches += 1
    return out
