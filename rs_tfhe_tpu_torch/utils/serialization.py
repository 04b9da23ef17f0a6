"""Key serialization: the JAX package's .npz key files, both ways.

A file written here loads in `rs_tfhe_tpu.utils.serialization` and a file
written there loads here, bit for bit (rs_tfhe_tpu/utils/serialization.py):
format version 2, the kinds `secret`, `cloud`, `cloud-seeded` and `reenc`,
the parameter set as JSON, and `allow_pickle=False` on load. On disk the
arrays are the JAX package's: torus words as uint32, and the limb tables
(`ksk_limbs`, `table_limbs`) as planar int8 planes padded to 128 lanes
(`rs_tfhe_tpu.torus.lane_pad`). The port's own layout (planes padded to 8,
key.ksk_width) is converted at save and at load.

A seeded cloud-key file holds the key's `gen_seed`, the ciphertext bodies and
the gadget-bearing mask words, about a tenth of the full file: the masks are
the public threefry streams of `gen_seed` (key.CloudKey.generate) and are
replayed at load on the load device. The port's keys draw no noise from
`gen_seed`, so the file gives away no noise word.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..key import (
    MB_FOLD,
    CloudKey,
    SecretKey,
    cloud_key_from_numpy,
    gen_testvec,
    ksk_zero_rows,
    secret_key_from_numpy,
)
from ..params import TfheParams, params_from_dict
from ..proxy_reenc import ProxyReencryptionKey
from ..tlwe import lwe_rows_limbs_from_bodies
from ..torus import (
    fold_in,
    key_tensor,
    planar_limbs,
    random_bits,
    resolve_device,
    rows_from_planar_limbs,
    split,
    to_numpy,
    to_torch,
)

#: v2: planar limb tables padded to 128 lanes (rs_tfhe_tpu/utils/serialization.py:21-23)
FORMAT_VERSION = 2
#: lanes the JAX package pads a limb plane to
JAX_LANES = 128
PRNG_IMPL = "threefry2x32"


def params_to_dict(params: TfheParams) -> dict:
    return dataclasses.asdict(params)


def _jax_limbs(limbs: torch.Tensor, width: int) -> np.ndarray:
    """A port limb table -> the JAX layout (planes padded to 128 lanes)."""
    return planar_limbs(rows_from_planar_limbs(limbs.cpu(), width), JAX_LANES).numpy()


def _port_limbs(limbs: np.ndarray, width: int, device) -> torch.Tensor:
    """A JAX limb table (any lane padding) -> the port's layout on `device`."""
    return planar_limbs(rows_from_planar_limbs(torch.from_numpy(np.array(limbs)), width)).to(device)


def _header(kind: str, params: TfheParams) -> dict:
    return {"version": FORMAT_VERSION, "kind": kind, "params": json.dumps(params_to_dict(params))}


def _check(z, kind: str) -> TfheParams:
    """Raise unless the file is version 2 of `kind`; its parameter set."""
    v = int(z["version"])
    if v != FORMAT_VERSION:
        raise ValueError(f"unsupported key format version {v}")
    if str(z["kind"]) != kind:
        raise ValueError(f"expected a {kind} key, found {z['kind']}")
    return params_from_dict(json.loads(str(z["params"])))


def save_secret_key(path, sk: SecretKey) -> None:
    np.savez_compressed(path, **_header("secret", sk.params), lv0=to_numpy(sk.lv0), lv1=to_numpy(sk.lv1))


def load_secret_key(path, device=None) -> SecretKey:
    """A secret-key file onto `device` (None: the card)."""
    with np.load(path, allow_pickle=False) as z:
        params = _check(z, "secret")
        return secret_key_from_numpy({"lv0": z["lv0"], "lv1": z["lv1"]}, params, device)


def save_cloud_key(path, ck: CloudKey, seeded: bool = False) -> None:
    """Full: the test vector, the key-switching key's limb table, the BSK and
    a multi-bit key's bsk_mb (rs_tfhe_tpu/utils/serialization.py:68-117).

    seeded=True: `gen_seed` and the bodies only, about a tenth of the size:
    the KSK's bodies (column n0 of its rows), the BSK's and the multi-bit
    key's body polynomials, and their mask coefficient 0 of the first L rows,
    which carry the gadget constants. Raises for a key without `gen_seed`
    (one loaded from a full file, or `generate_no_ksk`'s)."""
    params = ck.params
    n0, l = params.n0, params.trgsw_lv1.l
    if not seeded:
        mb = {} if ck.bsk_mb is None else {"bsk_mb": to_numpy(ck.bsk_mb)}
        np.savez_compressed(
            path, **_header("cloud", params), testvec=to_numpy(ck.testvec),
            ksk_limbs=_jax_limbs(ck.ksk_limbs, n0 + 1), bsk=to_numpy(ck.bsk), **mb,
        )
        return
    if ck.gen_seed is None:
        raise ValueError("seeded save needs ck.gen_seed (a generated key)")
    mb = {}
    if ck.bsk_mb is not None:
        mb = {"mb_bodies": to_numpy(ck.bsk_mb[:, :, :, 1, :]), "mb_mask0": to_numpy(ck.bsk_mb[:, :, :l, 0, 0])}
    np.savez_compressed(
        path, **_header("cloud-seeded", params), prng_impl=PRNG_IMPL,
        gen_seed=to_numpy(ck.gen_seed),
        ksk_bodies=to_numpy(rows_from_planar_limbs(ck.ksk_limbs, n0 + 1)[:, n0]),
        bsk_bodies=to_numpy(ck.bsk[:, :, 1, :]),
        bsk_mask0=to_numpy(ck.bsk[:, :l, 0, 0]),
        **mb,
    )


def _replay_trgsw(mask_key, bodies: torch.Tensor, mask0: torch.Tensor, params: TfheParams) -> torch.Tensor:
    """TRGSW rows [..., 2L, 2, N] from their mask key, body polynomials
    [..., 2L, N] and gadget-bearing mask words [..., L]: the masks on the
    BSK grid, mask0 planted on coefficient 0 of the first L rows."""
    a = random_bits(mask_key, bodies.shape, bodies.device)
    if params.bsk_round_bits > 0:
        a = a & ~((1 << params.bsk_round_bits) - 1)
    a[..., : params.trgsw_lv1.l, 0] = mask0
    return torch.stack([a, bodies], dim=-2)


def _replay_seeded(z, params: TfheParams, device):
    """(ksk_limbs, bsk, bsk_mb) of a seeded file, the masks replayed on
    `device` from its gen_seed (rs_tfhe_tpu/utils/serialization.py:125-169)."""
    if str(z["prng_impl"]) != PRNG_IMPL:
        raise ValueError(f"unsupported prng_impl {z['prng_impl']}")
    gen_seed = key_tensor(z["gen_seed"])
    k_ksk, k_bsk = split(gen_seed)
    ksk_limbs = lwe_rows_limbs_from_bodies(
        split(k_ksk)[0], to_torch(z["ksk_bodies"], device), params.n0,
        zero_mask=ksk_zero_rows(params, device),
    )
    bsk = _replay_trgsw(split(k_bsk)[0], to_torch(z["bsk_bodies"], device),
                        to_torch(z["bsk_mask0"], device), params)
    bsk_mb = None
    if "mb_bodies" in z.files:
        bsk_mb = _replay_trgsw(split(fold_in(gen_seed, MB_FOLD))[0], to_torch(z["mb_bodies"], device),
                               to_torch(z["mb_mask0"], device), params)
    return ksk_limbs, bsk, bsk_mb, gen_seed.to(device)


def load_cloud_key(path, device=None) -> CloudKey:
    """A full or seeded cloud-key file onto `device` (None: the card). A
    seeded file's masks are replayed there; its key keeps `gen_seed`."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        kind = str(z["kind"])
        params = _check(z, kind if kind == "cloud-seeded" else "cloud")
        if kind == "cloud":
            return cloud_key_from_numpy({k: z[k] for k in z.files}, params, device)
        ksk_limbs, bsk, bsk_mb, gen_seed = _replay_seeded(z, params, device)
        return CloudKey(gen_testvec(params, device), bsk, ksk_limbs, params, bsk_mb, gen_seed)


def save_reenc_key(path, rk: ProxyReencryptionKey) -> None:
    """A proxy re-encryption key (rs_tfhe_tpu/utils/serialization.py:221-234),
    its table in the JAX layout."""
    np.savez_compressed(
        path, **_header("reenc", rk.params),
        table_limbs=_jax_limbs(rk.table_limbs, rk.params.n0 + 1), basebit=rk.basebit, t=rk.t,
    )


def load_reenc_key(path, device=None) -> ProxyReencryptionKey:
    """A re-encryption key file onto `device` (None: the card)."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        params = _check(z, "reenc")
        return ProxyReencryptionKey(
            _port_limbs(z["table_limbs"], params.n0 + 1, device), int(z["basebit"]), int(z["t"]), params,
        )
