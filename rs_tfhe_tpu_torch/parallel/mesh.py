"""Device meshes, placement and the all-reduce of the multi-device paths
(rs_tfhe_tpu/parallel/mesh.py).

One process drives a grid of `torch.device`s, the counterpart of the JAX
package's single-controller `jax.sharding.Mesh`: a `[n_batch, tp]` array whose
`batch` axis shards the ciphertext batch (data parallel: blind rotations of
independent ciphertexts never communicate) and whose `model` axis shards the
evaluation-key contractions inside one bootstrap (tensor parallel: a sum over
partial products, `reduce_sum`/`all_reduce_sum`, in place of `jax.lax.psum`).

A device may appear more than once, deliberately: `[torch.device("cpu")] * 8`
is the counterpart of XLA's `--xla_force_host_platform_device_count=8`, and
`[cuda:0] * 4` is a virtual mesh on one card. The shards then run one after
another on that device and compute what they compute on distinct devices;
this is how the paths are tested on a machine with fewer devices, and it is
not a fallback: `make_mesh()` without devices takes every visible CUDA device
and raises where there is none.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

BATCH_AXIS = "batch"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A `[n_batch, tp]` grid of devices: `devices[i][s]` holds batch shard i,
    model shard s."""

    devices: tuple

    @property
    def shape(self) -> dict:
        """{BATCH_AXIS: n_batch, MODEL_AXIS: tp}, as `jax.sharding.Mesh.shape`."""
        return {BATCH_AXIS: len(self.devices), MODEL_AXIS: len(self.devices[0])}

    @property
    def flat(self) -> tuple:
        """Every device of the grid, row by row (repeats included)."""
        return tuple(d for row in self.devices for d in row)


def _device(d) -> torch.device:
    """A torch.device with its index made explicit for CUDA ("cuda" is the
    current device), so that equal devices compare equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices: Optional[int] = None, tp: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """A (batch, model) mesh over the first `n_devices` of `devices` (None:
    every visible CUDA device; raises where there is none). tp > 1 makes the
    `model` axis that size for tensor-parallel bootstrapping; n_devices must
    be divisible by tp."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not count:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices (e.g. ['cpu'] * n) "
                               "for a mesh of other devices")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [_device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if not 1 <= n_devices <= len(devices):
        raise ValueError(f"n_devices={n_devices}: {len(devices)} devices given")
    if tp < 1 or n_devices % tp != 0:
        raise ValueError(f"n_devices={n_devices} not divisible by tp={tp}")
    devices = devices[:n_devices]
    return Mesh(tuple(tuple(devices[i * tp:(i + 1) * tp]) for i in range(n_devices // tp)))


def make_multihost_mesh(tp: int = 1) -> Mesh:
    """The mesh over every visible CUDA device. The JAX package's
    multi-host mesh spans hosts after `jax.distributed.initialize()`; its
    single-process behaviour, which this is, equals make_mesh()."""
    return make_mesh(tp=tp)


def batch_spec(ndim: int) -> tuple:
    """The placement of a ciphertext batch: its leading axis over `batch`,
    every other axis whole (the JAX package's PartitionSpec, as a tuple): the
    placement `shard_batch` makes."""
    return (BATCH_AXIS, *([None] * (ndim - 1)))


def shard_batch(x: torch.Tensor, mesh: Mesh) -> list:
    """Split a batch along its leading axis into n_batch equal shards, in
    batch order, shard i on the first device of mesh row i. The batch must
    divide (pad_to_multiple)."""
    n_batch = mesh.shape[BATCH_AXIS]
    if x.shape[0] % n_batch:
        raise ValueError(f"batch {x.shape[0]} not divisible by the batch axis {n_batch} (pad_to_multiple)")
    return [part.to(row[0]) for part, row in zip(torch.tensor_split(x, n_batch), mesh.devices)]


def _moved(tree, device: torch.device):
    from ..key import CloudKey

    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, CloudKey):
        return CloudKey(*(_moved(getattr(tree, b), device) for b in ("testvec", "bsk", "ksk_limbs")), tree.params,
                        _moved(tree.bsk_mb, device), _moved(tree.gen_seed, device))
    raise TypeError(f"replicate takes a tensor or a CloudKey, got {type(tree).__name__}")


def replicate(tree, mesh: Mesh) -> dict:
    """{device: copy} for every distinct device of the mesh: a tensor or a
    CloudKey moved once per device (not at all onto the device it is on) and
    shared by the shards of a repeated device. The caller's object is never
    moved."""
    out = {}
    for d in mesh.flat:
        if d not in out:
            out[d] = _moved(tree, d)
    return out


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int = 0):
    """Pad the batch axis with zero rows up to a multiple; returns (padded, size)."""
    size = x.shape[axis]
    rem = (-size) % multiple
    if rem == 0:
        return x, size
    shape = list(x.shape)
    shape[axis] = rem
    return torch.cat([x, x.new_zeros(shape)], dim=axis), size


def reduce_sum(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The exact wrapping int32 sum of `parts` (one per shard, any devices)
    on `device`, each part copied there with `.to` (nothing to copy where the
    device is the same). Integer addition mod 2^32 is associative, so the
    order of the parts does not change a bit."""
    total = None
    for p in parts:
        p = p.to(device)
        total = p if total is None else total + p
    return total


def all_reduce_sum(parts: Sequence[torch.Tensor]) -> list:
    """The counterpart of `jax.lax.psum` over a mesh axis: `reduce_sum` once
    per distinct device of `parts`, returned aligned with `parts`, shards on
    one device sharing their sum."""
    sums = {}
    for p in parts:
        if p.device not in sums:
            sums[p.device] = reduce_sum(parts, p.device)
    return [sums[p.device] for p in parts]
