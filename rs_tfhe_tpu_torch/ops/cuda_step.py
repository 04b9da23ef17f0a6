"""The external-product step kernel's wrapper: checks, the choice of the
kernel's instance, launch and launch count, and the step product that
dispatches on the device.

The kernel (`csrc/external_product.cu`) replaces the TPU kernel
`fused_external_product` of rs_tfhe_tpu/ops/pallas_step.py; its plain
PyTorch version is `ops.poly.polymul_small_by_torus`. It serves the per-step
rotation (`config.step_impl="pallas"`, ops/blind_rotate.py) with all 2L
gadget rows, and each shard of the tensor-parallel rotation
(parallel/sharded.py) with its 2L/tp rows: like the TPU kernel it takes any
count J of gadget rows from 1 to 2L. Unlike the TPU kernel it takes any
batch, ring size up to 4096 and digit width: the TPU's eligibility
(single-limb digits, N and batch multiples of 128) is a Mosaic layout rule
with no counterpart here.

Two instances (`step_instance`): single-limb digits (bgbit <= 8) go to the
tensor cores as s8 digits against the four u8 limbs of the extended key
(`csrc/negacyclic_mma.cuh`), 128 rows by 64 columns a block; wider digits
(the SECURITY_UINT sets) keep whole-word multiply-adds on the CUDA cores, with
the output columns split over the grid when the rows alone would not fill the
card. `limb_product_plain` states the limb formulation in plain PyTorch.
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from ..params import TfheParams
from ..utils.profiling import counter
from .cuda_launch import check_shapes, check_tensor, launched, on_device, takes_tensor_cores
from .poly import polymul_small_by_torus

#: Launches by instance (ring size N, unit, rows a block, column split) and
#: gadget row count J, (*instance, J), in this process.
launched_tiles = counter("k5.instance", total="k5.launches")

#: Rows and output columns a block of the tensor-core instance owns.
MMA_ROWS, MMA_COLS = 128, 64
#: The CUDA-core instance splits a thread's 8 coefficients 1 or 8 ways.
IMAD_SPLIT = 8


def step_instance(params: TfheParams, rows: int, max_tile: int, sm_count: int) -> tuple:
    """The instance (N, unit, rows a block, column split) the wrapper
    launches for `rows` digit rows: "mma_s8" wherever `takes_tensor_cores`,
    else "imad" with the largest row tile up to `max_tile` that still gives
    every SM a block, the columns split `IMAD_SPLIT` ways when the rows alone
    do not."""
    n = params.n1
    if takes_tensor_cores(params):
        return (n, "mma_s8", MMA_ROWS, 2 * n // MMA_COLS)
    split = 1 if -(-rows // max_tile) >= sm_count else IMAD_SPLIT
    tile = max_tile
    while tile > 1 and -(-rows // tile) * split < sm_count:
        tile //= 2
    return (n, "imad", tile, split)


@functools.lru_cache(maxsize=None)
def _device_limits(index: int, log_n: int) -> tuple:
    """(the CUDA-core instance's largest tile, SM count) of CUDA device `index`."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return _build.load().tfhe_external_product_max_tile(log_n), sms


def limb_product_plain(
    digits: torch.Tensor, trgsw: torch.Tensor, limbs: int = 4, s32: bool = True
) -> torch.Tensor:
    """The tensor-core instance's arithmetic in plain PyTorch: extend each
    key polynomial to [-p, p], split the extended words into bytes, one
    Toeplitz product per limb in integers, shift and add mod 2^32.

    digits: int32 [F, J, N] with |d| <= 128; trgsw: int32 [J, O, N]; `limbs`
    low bytes of the key are dropped when < 4 (a key on the 2^(8(4-limbs))
    grid loses nothing). Returns int32 [F, O, N]. With `s32` a limb sum that
    leaves s32 raises, as the tensor cores' accumulator would wrap; without
    it the formulation is checked for any digit width in 64-bit integers.
    For tests and as the kernel's statement; quadratic memory, few rows.
    """
    n = digits.shape[-1]
    words = trgsw.to(torch.int64) & 0xFFFFFFFF
    ext = torch.cat([(-words) & 0xFFFFFFFF, words], dim=-1)  # [J, O, 2N]
    c = torch.arange(n, device=digits.device)
    idx = c[None, :] - c[:, None] + n  # [m, c] -> c - m + N
    d = digits
    out = torch.zeros((digits.shape[0], trgsw.shape[1], n), dtype=torch.int64, device=digits.device)
    for k in range(4 - limbs, 4):
        toeplitz = ((ext >> (8 * k)) & 0xFF)[..., idx]  # [J, O, m, c], bytes
        # float64 carries these integers exactly (|S_k| < 2^53) and has a matmul on every device
        s_k = torch.einsum("fjm,jomc->foc", d.to(torch.float64), toeplitz.to(torch.float64)).to(torch.int64)
        if s32 and int(s_k.abs().max()) >= 1 << 31:
            raise ValueError("limb accumulator leaves s32")
        out += s_k << (8 * k)
    out &= 0xFFFFFFFF
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def check_digit_range(digits: torch.Tensor, params: TfheParams) -> None:
    """Raise unless every digit lies in [-Bg/2, Bg/2), the range the gadget
    decomposition yields and `external_product_kernel` relies on. Reads all
    of `digits` and, on a CUDA tensor, synchronises: for callers whose digits
    come from elsewhere than the decomposition, and for tests; the kernel's
    wrapper does not call it."""
    half = params.trgsw_lv1.half_bg
    lo, hi = (int(v) for v in torch.aminmax(digits)) if digits.numel() else (0, 0)
    if lo < -half or hi >= half:
        raise ValueError(f"digits span [{lo}, {hi}], outside [-{half}, {half}) of bgbit={params.trgsw_lv1.bgbit}")


def external_product_kernel(
    digits: torch.Tensor, trgsw: torch.Tensor, params: TfheParams, tile: int | None = None,
    split: int = 1,
) -> torch.Tensor:
    """sum_j digits[:, j] (x) trgsw[j, o] mod 2^32 on the card.

    digits: int32 [F, J, N] gadget digits in [-Bg/2, Bg/2); trgsw: int32
    [J, 2, N] raw torus words, for any J from 1 to 2L (2L: a whole step; a
    tensor-parallel shard passes its 2L/tp rows). Returns int32 [F, 2, N],
    launched on the current stream without synchronising. The instance comes
    from `step_instance`.

    The digit range is a contract, not checked here (a check would read the
    digits and synchronise at every step of a rotation): the tensor-core
    instance keeps only a digit's low byte as s8, so a digit outside
    [-128, 127] gives a wrong product there, where the CUDA-core instance
    takes any int32. `check_digit_range` tests it for a caller that cannot
    vouch for its digits.

    `tile` (with `split`) forces the CUDA-core instance at that tile and is
    for tests and measurement scripts only; no path of the package sets it.
    """
    if digits.device.type != "cuda":
        raise ValueError(f"external_product_kernel takes CUDA tensors, got {digits.device}")
    g, n = params.trgsw_lv1, params.n1
    check_shapes(params)
    dev = digits.device
    rows = digits.shape[0]
    j_rows = trgsw.shape[0] if trgsw.dim() == 3 else -1
    if not 1 <= j_rows <= 2 * g.l:
        raise ValueError(f"trgsw: shape {tuple(trgsw.shape)}, expected [J, 2, {n}] with 1 <= J <= 2L = {2 * g.l}")
    check_tensor("digits", digits, (rows, j_rows, n), dev)
    check_tensor("trgsw", trgsw, (j_rows, 2, n), dev)
    out = torch.empty((rows, 2, n), dtype=torch.int32, device=dev)
    if rows == 0:
        return out
    lib = _build.load()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if tile is None:
        instance = step_instance(params, rows, *_device_limits(index, n.bit_length() - 1))
    else:
        instance = (n, "imad", tile, split)
    _, unit, tile, split = instance
    scratch = None
    if unit == "mma_s8":
        scratch = torch.empty((rows, j_rows * n), dtype=torch.int8, device=dev)
    with on_device(index):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tfhe_external_product(
            digits.data_ptr(), trgsw.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            rows, n.bit_length() - 1, j_rows, int(unit == "mma_s8"), tile, split, stream,
        )
    launched(err, launched_tiles, (*instance, j_rows), "external_product kernel launch failed (instance={})", instance)
    return out


def external_product(digits: torch.Tensor, trgsw: torch.Tensor, params: TfheParams) -> torch.Tensor:
    """One step's product over J gadget rows, int32 [F, J, N] x [J, 2, N] ->
    [F, 2, N] (J = 2L for a whole step): the kernel on a CUDA tensor, the
    plain product on a CPU tensor."""
    if digits.device.type == "cuda":
        return external_product_kernel(digits.contiguous(), trgsw.contiguous(), params)
    if digits.device.type != "cpu":
        raise ValueError(f"external_product: no implementation for device {digits.device}")
    return polymul_small_by_torus(digits, trgsw, params.trgsw_lv1.half_bg)
