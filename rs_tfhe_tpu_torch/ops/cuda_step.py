"""The external-product step kernel's wrapper: checks, launch and launch
count, and the step product that dispatches on the device.

The kernel (`csrc/external_product.cu`) replaces the TPU kernel
`fused_external_product` of rs_tfhe_tpu/ops/pallas_step.py; its plain
PyTorch version is `ops.poly.polymul_small_by_torus`. It serves the per-step
rotation (`config.step_impl="pallas"`, ops/blind_rotate.py). Unlike the TPU
kernel it takes any batch, ring size up to 4096 and digit width: the TPU's
eligibility (single-limb digits, N and batch multiples of 128) is a Mosaic
layout rule with no counterpart here.
"""

from __future__ import annotations

import collections

import torch

from .. import _build
from ..params import TfheParams
from .cuda_blind_rotate import check_shapes, check_tensor, fit_tile
from .poly import polymul_small_by_torus

#: Launches of the kernel in this process (the wrapper adds one per launch).
launches = 0

#: Launches by (ring size N, tile) in this process, beside `launches`.
launched_tiles: collections.Counter = collections.Counter()


def external_product_kernel(
    digits: torch.Tensor, trgsw: torch.Tensor, params: TfheParams, tile: int | None = None
) -> torch.Tensor:
    """sum_j digits[:, j] (x) trgsw[j, o] mod 2^32 on the card.

    digits: int32 [F, 2L, N] gadget digits; trgsw: int32 [2L, 2, N] raw torus
    words. Returns int32 [F, 2, N], launched on the current stream without
    synchronising.
    """
    global launches
    if digits.device.type != "cuda":
        raise ValueError(f"external_product_kernel takes CUDA tensors, got {digits.device}")
    g, n = params.trgsw_lv1, params.n1
    check_shapes(params)
    dev = digits.device
    rows = digits.shape[0]
    check_tensor("digits", digits, (rows, 2 * g.l, n), dev)
    check_tensor("trgsw", trgsw, (2 * g.l, 2, n), dev)
    out = torch.empty((rows, 2, n), dtype=torch.int32, device=dev)
    if rows == 0:
        return out
    lib = _build.load()
    if tile is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        tile = fit_tile(rows, lib.tfhe_external_product_max_tile(n.bit_length() - 1), sms)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tfhe_external_product(
            digits.data_ptr(), trgsw.data_ptr(), out.data_ptr(), rows, n.bit_length() - 1,
            g.l, tile, stream,
        )
    if err != 0:
        msg = lib.tfhe_cuda_error_string(err).decode()
        raise RuntimeError(f"external_product kernel launch failed (tile={tile}): {msg} ({err})")
    launches += 1
    launched_tiles[(n, tile)] += 1
    return out


def external_product(digits: torch.Tensor, trgsw: torch.Tensor, params: TfheParams) -> torch.Tensor:
    """One step's product, int32 [F, 2L, N] x [2L, 2, N] -> [F, 2, N]: the
    kernel on a CUDA tensor, the plain product on a CPU tensor."""
    if digits.device.type == "cuda":
        return external_product_kernel(digits.contiguous(), trgsw.contiguous(), params)
    if digits.device.type != "cpu":
        raise ValueError(f"external_product: no implementation for device {digits.device}")
    return polymul_small_by_torus(digits, trgsw, params.trgsw_lv1.half_bg)
