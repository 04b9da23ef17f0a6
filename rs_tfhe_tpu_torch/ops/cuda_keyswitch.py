"""The small-batch key switch kernel's wrapper: checks, the plan of the
launch, launch and launch count.

The kernel (`csrc/key_switch.cu`) replaces no TPU kernel: the JAX package's
key switch is a plain XLA product of the one-hot digit matrix and the limb
table, and its plain version here is that product
(`ops.keyswitch.digit_select_sum` on the product route). The kernel reads only
the table rows the digits select, each distinct row once a call;
`ops.keyswitch` routes the batches up to `KS_SELECT_MAX_BATCH` on the card to
it. This wrapper takes CUDA tensors only: it launches the kernel or raises.
"""

from __future__ import annotations

import collections
import functools
import math

import torch

from .. import _build
from ..params import TORUS_BITS
from .cuda_blind_rotate import on_device

#: Launches in this process (one a call: the selection kernel and the
#: reduction over its slices).
launches = 0

#: Launches by instance, (ciphertexts a block,), beside `launches`.
launched_tiles: collections.Counter = collections.Counter()

#: Ciphertexts a block at most; a larger batch takes more blocks.
MAX_BLOCK_BATCH = 16
#: Row groups a block at most: its task table (two words a group and
#: distinct digit) stays within 32 KB of shared memory.
MAX_BLOCK_GROUPS = 256
#: Columns a limb plane at most: a block is width/4 threads, at most 512.
MAX_WIDTH = 2048


def block_batch(batch: int) -> int:
    """Ciphertexts a block for `batch`: the least power of two that holds
    the batch, at most 16."""
    return min(MAX_BLOCK_BATCH, 1 << max(0, batch - 1).bit_length())


def select_plan(batch: int, n_groups: int, sm_count: int, blocks_per_sm: int) -> tuple:
    """(ciphertexts a block, row groups a block, slices) of a launch for
    `batch` ciphertexts and `n_groups` = n_in * t row groups: the groups are
    cut into slices so that the grid holds at least a wave of
    `blocks_per_sm` blocks on each of `sm_count` SMs, and more where a slice
    would exceed `MAX_BLOCK_GROUPS`."""
    bc = block_batch(batch)
    blocks = blocks_per_sm * sm_count
    chunks = -(-batch // bc)
    per_block = max(1, min(MAX_BLOCK_GROUPS, n_groups * chunks // blocks))
    return bc, per_block, -(-n_groups // per_block)


@functools.lru_cache(maxsize=None)
def _device_plan(index: int, batch: int, n_groups: int, width: int) -> tuple:
    """`select_plan` on CUDA device `index`: its SM count, and the blocks of
    the instance one SM holds with the most shared memory a block of it
    takes (a full task table: `MAX_BLOCK_GROUPS` groups of bc tasks, two
    words each)."""
    bc = block_batch(batch)
    with on_device(index):
        resident = _build.load().tfhe_key_switch_blocks_per_sm(bc, width, 8 * bc * MAX_BLOCK_GROUPS)
    if resident < 1:
        raise RuntimeError(f"key switch kernel: no block of {bc} ciphertexts and width {width} fits a SM ({resident})")
    return select_plan(batch, n_groups, torch.cuda.get_device_properties(index).multi_processor_count, resident)


def digit_select_kernel(
    a: torch.Tensor, body: torch.Tensor | None, table_limbs: torch.Tensor, t: int, basebit: int, out_width: int
) -> torch.Tensor:
    """On the card: (0, ..., 0, body) - sum of the table rows the digits of
    `a` select, or the sum itself when `body` is None; int32 [...,
    out_width], exact mod 2^32, launched on the current stream without
    synchronising.

    a:           int32 [..., n_in] mask words; the last dimension contiguous,
                 the rows at any stride (`ct[..., :n1]` is not copied)
    body:        int32 [...] (`ct[..., n1]`) or None
    table_limbs: int8 [n_in * t * 2^basebit, 4 * W] planar limbs, as the key
                 holds them (key.ksk_limbs_from_rows)
    """
    global launches
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"digit_select_kernel takes CUDA tensors, got {dev}")
    lead, n_in = a.shape[:-1], a.shape[-1]
    rows, cols = table_limbs.shape if table_limbs.dim() == 2 else (-1, -1)
    w = cols // 4
    if a.dtype != torch.int32 or table_limbs.dtype != torch.int8 or table_limbs.device != dev:
        raise TypeError(f"expected int32 a and an int8 table on {dev}, got {a.dtype} and "
                        f"{table_limbs.dtype} on {table_limbs.device}")
    if (n_in < 1 or rows != n_in * t << basebit or cols % 16 or not 0 < out_width <= w <= MAX_WIDTH
            or not 0 < basebit * t < TORUS_BITS):
        raise ValueError(f"table {tuple(table_limbs.shape)} does not fit n_in={n_in}, t={t}, basebit={basebit}, "
                         f"out_width={out_width}: expected [{n_in * t << basebit}, 4W], W a multiple of 4, "
                         f">= out_width and <= {MAX_WIDTH}")
    if not table_limbs.is_contiguous() or table_limbs.data_ptr() % 4:
        raise ValueError("table_limbs: must be contiguous and 4-byte aligned")
    batch = math.prod(lead)
    a2 = a.reshape(batch, n_in)
    if n_in > 1 and a2.stride(1) != 1:
        a2 = a2.contiguous()
    b2 = None
    if body is not None:
        if body.dtype != torch.int32 or body.device != dev or tuple(body.shape) != tuple(lead):
            raise ValueError(f"body: {body.dtype} {tuple(body.shape)} on {body.device}, expected int32 "
                             f"{tuple(lead)} on {dev}")
        b2 = body.reshape(batch)
    out = torch.empty((batch, out_width), dtype=torch.int32, device=dev)
    if batch == 0:
        return out.reshape(*lead, out_width)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    bc, per_block, slices = _device_plan(index, batch, n_in * t, w)
    partial = torch.empty((slices, batch, w), dtype=torch.int32, device=dev)
    lib = _build.load()
    with on_device(index):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tfhe_key_switch(
            a2.data_ptr(), a2.stride(0), b2.data_ptr() if b2 is not None else None,
            b2.stride(0) if b2 is not None else 0, table_limbs.data_ptr(), partial.data_ptr(), out.data_ptr(),
            batch, n_in, t, basebit, 1 << (TORUS_BITS - 1 - basebit * t), w, out_width, bc, per_block, slices,
            stream,
        )
    if err != 0:
        msg = lib.tfhe_cuda_error_string(err).decode()
        raise RuntimeError(f"key switch kernel launch failed (plan {(bc, per_block, slices)}): {msg} ({err})")
    launches += 1
    launched_tiles[(bc,)] += 1
    return out.reshape(*lead, out_width)
