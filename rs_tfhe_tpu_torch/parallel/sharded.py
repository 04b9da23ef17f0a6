"""Multi-device bootstrapped gate evaluation: data and tensor parallel
(rs_tfhe_tpu/parallel/sharded.py, whose outputs these functions equal bit for
bit).

Two strategies on a `(batch, model)` mesh (parallel/mesh.py):

**Data parallel (the throughput path).** Independent ciphertexts never
communicate. The batch is padded with zero rows to a multiple of the batch
axis and split in batch order; each shard runs the whole single-device
bootstrap on the first device of its mesh row with the key replicated there,
and the pad rows are dropped. No collective and no host synchronisation
between shards, so shards on distinct cards overlap. As under the JAX
package's `shard_map`, each shard's rotation is routed by its LOCAL batch: with
a multi-bit key a shard of at most `ops.blind_rotate.mb_route_batch_cap`
ciphertexts takes the multi-bit rotation even where the whole batch on one
device would not, so such outputs equal the JAX package's data-parallel
outputs, not the single-device ones.

**Tensor parallel (scale within one bootstrap).** The two key contractions
inside a bootstrap are sharded over the `model` axis, each followed by
`reduce_sum` onto the first device of the mesh row:

  - external product: model shard s holds the BSK's gadget rows
    [s*2L/tp, (s+1)*2L/tp) ([n0, 2L/tp, 2, N]); every CMUX step rotates and
    decomposes the accumulator on the row's first device, hands each shard
    its digit rows, each shard computes its partial delta (the
    external-product kernel with J = 2L/tp rows on a CUDA tensor, the plain
    product on a CPU tensor), and the summed partials update the
    accumulator;
  - key switching: shard s holds the KSK's N-coefficient blocks
    [s*N/tp, (s+1)*N/tp) and sums the rows its coefficients select; the
    summed partials are subtracted from (0, ..., 0, body).

A bootstrap makes n0 + 1 reductions: n0 of [B_loc, 2, N] int32 and one of
[B_loc, n0+1]. The JAX package keeps a replica of the accumulator on every
model shard and all-reduces; the port keeps one, on the row's first device.
The sums are exact mod 2^32, so the bits are the same. The path always takes
the CMUX rotation (it ignores `bsk_mb` and `config.step_impl`, as the JAX
package's does off the TPU), needs tp to divide 2L and N, and B to divide by
the batch axis (no padding).

**Placing the key once.** Every function takes the CloudKey as it is, and
then copies it onto the mesh's devices at each call: nothing to copy where a
device is the key's own, the whole key to every other device. A caller that
evaluates many gates on a mesh of distinct devices places it once instead:
the data-parallel functions take the `{device: CloudKey}` that
`mesh.replicate(ck, mesh)` returns, and the tensor-parallel ones the
`ShardedKey` that `shard_key(ck, mesh)` returns.

Outputs are gathered, in batch order, on the first device of the mesh.
"""

from __future__ import annotations

import dataclasses

import torch

from ..bootstrap import bootstrap, bootstrap_with_testvec
from ..gates import _LINEAR_FORMS, mux
from ..key import CloudKey
from ..lut.generator import Generator
from ..ops import cuda_step
from ..ops.blind_rotate import _rotate_steps, rotation_exponents
from ..ops.extract import sample_extract
from ..ops.keyswitch import digit_select_sum
from ..params import TfheParams
from .mesh import BATCH_AXIS, MODEL_AXIS, Mesh, pad_to_multiple, reduce_sum, replicate, shard_batch

# ---------------------------------------------------------------------------
# Data parallel: one whole bootstrap per shard, no collectives
# ---------------------------------------------------------------------------


def _gather(outs: list, mesh: Mesh, size: int) -> torch.Tensor:
    """The shards' outputs in batch order on the mesh's first device, pad rows dropped."""
    first = mesh.devices[0][0]
    return torch.cat([o.to(first) for o in outs])[:size]


def _replicated(ck, mesh: Mesh) -> dict:
    """{device: CloudKey} for every device of the mesh: `ck` itself where it
    is already that (`replicate(ck, mesh)`, placed once by the caller), else
    `replicate(ck, mesh)` now."""
    if isinstance(ck, CloudKey):
        return replicate(ck, mesh)
    missing = set(mesh.flat) - ck.keys()
    if missing:
        raise ValueError(f"the placed key has no copy on {sorted(map(str, missing))} (replicate(ck, mesh))")
    return ck


def _data_parallel(fn, mesh: Mesh, cts: tuple, shared: tuple) -> torch.Tensor:
    """fn(*local ciphertext shards, *shared values on the shard's device) on
    every batch shard, the ciphertexts padded to the batch axis."""
    n_batch = mesh.shape[BATCH_AXIS]
    padded = [pad_to_multiple(ct, n_batch) for ct in cts]
    size = padded[0][1]
    shards = [shard_batch(p, mesh) for p, _ in padded]
    outs = []
    for i, row in enumerate(mesh.devices):
        dev = row[0]
        outs.append(fn(*(s[i] for s in shards), *(v[dev] for v in shared)))
    return _gather(outs, mesh, size)


def data_parallel_gate(name: str, a: torch.Tensor, b: torch.Tensor, ck, mesh: Mesh) -> torch.Tensor:
    """Evaluate one gate over a batch sharded across the mesh's batch axis.

    a, b: int32 [B, n0+1]. B is padded up to a multiple of the batch-axis
    size; the pad rows are dropped from the result. ck: a CloudKey, or
    `replicate(ck, mesh)` to place it once for many calls."""
    lin = _LINEAR_FORMS[name]
    return _data_parallel(lambda a_l, b_l, ck_l: bootstrap(lin(a_l, b_l), ck_l), mesh, (a, b),
                          (_replicated(ck, mesh),))


def data_parallel_mux(a, b, c, ck, mesh: Mesh) -> torch.Tensor:
    """MUX(a; b, c) with the batch axis sharded (each shard's MUX on its
    device; no collectives). ck as in data_parallel_gate."""
    return _data_parallel(mux, mesh, (a, b, c), (_replicated(ck, mesh),))


def data_parallel_lut_bootstrap(ct: torch.Tensor, f, message_modulus: int, ck, mesh: Mesh) -> torch.Tensor:
    """Programmable bootstrap with the batch sharded; the LUT polynomial is
    built once on the host and replicated. ck as in data_parallel_gate."""
    keys = _replicated(ck, mesh)
    lut = Generator(message_modulus, keys[mesh.devices[0][0]].params).generate_lookup_table(f)
    return _data_parallel(bootstrap_with_testvec, mesh, (ct,), (replicate(lut.poly, mesh), keys))


# ---------------------------------------------------------------------------
# Tensor parallel: key contractions sharded over `model`
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedKey:
    """A CloudKey's tensor-parallel shards on one mesh (`shard_key`).

    rows[i][s] = (device, bsk rows int32 [n0, 2L/tp, 2, N], ksk blocks int8
    [(N/tp)*t*base, 4W]) of mesh row i, model shard s; testvec: {device:
    int32 [2, N]} on the rows' first devices."""

    params: TfheParams
    mesh: Mesh
    rows: tuple
    testvec: dict


def shard_key(ck: CloudKey, mesh: Mesh) -> ShardedKey:
    """Cut the BSK's gadget rows and the KSK's N blocks over the mesh's
    `model` axis and place each shard on its device, once (a device that
    repeats in a column shares its copy). Raises unless tp divides 2L and N."""
    params = ck.params
    tp = mesh.shape[MODEL_AXIS]
    g = params.trgsw_lv1
    if (2 * g.l) % tp or params.n1 % tp:
        raise ValueError(f"tp={tp} must divide 2L={2 * g.l} and N={params.n1}")
    rows, cols = 2 * g.l // tp, params.n1 // tp
    # the KSK's rows are i-major ([N, t, base], key.gen_key_switching_key): cut the N blocks
    ksk_blocked = ck.ksk_limbs.reshape(params.n1, g.iks_t * params.ks_base, -1)
    w4 = ck.ksk_limbs.shape[-1]
    placed = {}  # (device, s) -> (bsk rows, ksk blocks)
    for d, s in {(d, s) for row in mesh.devices for s, d in enumerate(row)}:
        placed[(d, s)] = (ck.bsk[:, s * rows:(s + 1) * rows].to(d),
                          ksk_blocked[s * cols:(s + 1) * cols].reshape(-1, w4).to(d))
    shards = tuple(tuple((d, *placed[(d, s)]) for s, d in enumerate(row)) for row in mesh.devices)
    testvec = {row[0]: ck.testvec.to(row[0]) for row in mesh.devices}
    return ShardedKey(params, mesh, shards, testvec)


def _tp_bootstrap_row(ct: torch.Tensor, testvec: torch.Tensor, shards: tuple, params) -> torch.Tensor:
    """One batch shard's bootstrap over its model shards, on the row's first
    device. ct: int32 [B_loc, n0+1] and testvec int32 [2, N] there; shards:
    the row of `ShardedKey.rows`."""
    g, n0, n1 = params.trgsw_lv1, params.n0, params.n1
    tp = len(shards)
    rows, cols = 2 * g.l // tp, n1 // tp
    dev = shards[0][0]
    steps = list(zip(*(bsk_s for _, bsk_s, _ in shards)))  # step i: every shard's rows [2L/tp, 2, N]

    def product(digits, bsk_i):
        parts = [cuda_step.external_product(digits[:, s * rows:(s + 1) * rows].to(d), bsk_i[s], params)
                 for s, (d, _, _) in enumerate(shards)]
        return reduce_sum(parts, dev)

    acc = _rotate_steps(*rotation_exponents(ct, params), testvec, steps, params, product)
    lv1 = sample_extract(acc, 0)
    partials = [digit_select_sum(lv1[..., s * cols:(s + 1) * cols].to(d), ksk_s, g.iks_t, g.basebit, n0 + 1)
                for s, (d, _, ksk_s) in enumerate(shards)]
    res = -reduce_sum(partials, dev)
    res[..., n0] += lv1[..., n1]
    return res


def tensor_parallel_bootstrap(
    ct: torch.Tensor, ck, mesh: Mesh, testvec: torch.Tensor | None = None
) -> torch.Tensor:
    """Full gate bootstrap with the batch sharded over `batch` and both key
    contractions sharded over `model`. ct: int32 [B, n0+1] (B divisible by
    the batch-axis size; 2L and N divisible by the model-axis size). ck: a
    CloudKey, or `shard_key(ck, mesh)` to place its shards once for many
    calls. `testvec` (int32 [2, N]) replaces the gate test vector: the
    programmable bootstrap's hook (tensor_parallel_lut_bootstrap)."""
    key = shard_key(ck, mesh) if isinstance(ck, CloudKey) else ck
    if key.mesh != mesh:
        raise ValueError("the sharded key was made for another mesh (shard_key(ck, mesh))")
    tv = key.testvec if testvec is None else {row[0]: testvec.to(row[0]) for row in mesh.devices}
    outs = [_tp_bootstrap_row(ct_l, tv[shards[0][0]], shards, key.params)
            for ct_l, shards in zip(shard_batch(ct, mesh), key.rows)]
    return _gather(outs, mesh, ct.shape[0])


def tensor_parallel_lut_bootstrap(
    ct: torch.Tensor, f, message_modulus: int, ck, mesh: Mesh
) -> torch.Tensor:
    """Programmable bootstrap on the (batch, model) mesh: the LUT polynomial
    replaces the gate test vector; everything else shards as in
    tensor_parallel_bootstrap (ck likewise). The LUT builds once on the host."""
    lut = Generator(message_modulus, ck.params).generate_lookup_table(f)
    return tensor_parallel_bootstrap(ct, ck, mesh, testvec=lut.poly)


def tensor_parallel_gate(name: str, a: torch.Tensor, b: torch.Tensor, ck, mesh: Mesh) -> torch.Tensor:
    """Gate evaluation on the (batch, model) mesh: linear form, then the
    tensor-parallel bootstrap. a, b: int32 [B, n0+1] with B divisible by the
    batch-axis size; ck as in tensor_parallel_bootstrap."""
    return tensor_parallel_bootstrap(_LINEAR_FORMS[name](a, b), ck, mesh)
