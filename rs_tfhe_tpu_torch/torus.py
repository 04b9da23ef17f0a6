"""Discretized-torus arithmetic helpers.

The torus T = R/Z is discretized to 32 bits. The port carries every torus
value as two's-complement `torch.int32`: addition, subtraction and
multiplication wrap modulo 2^32 exactly as uint32 arithmetic does, and the bit
pattern of an int32 IS the uint32 torus word. Two operations differ:

  - a right shift on int32 is arithmetic, so every *logical* shift of the
    reference's uint32 code is masked after the `>>` (see `logical_rshift`);
  - a sign test on the torus word (phase >= 1/2?) is a plain `< 0` on int32.

Host-side conversions stay numpy (`f64_to_torus`, `torus_to_f64`), and
`to_torch`/`to_numpy` move uint32 arrays in and out without changing a bit.
Randomness comes from an explicit `torch.Generator` on the tensor's device,
or from `OsRandom`, which draws every word from the operating system's CSPRNG
(the `generate_secure` keys).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .params import TORUS_BITS

TORUS_DTYPE = torch.int32
_TWO32 = float(1 << TORUS_BITS)


# ---------------------------------------------------------------------------
# Host-side (client) conversions — exact f64 semantics of the reference
# ---------------------------------------------------------------------------

def f64_to_torus(d) -> np.ndarray:
    """Exact equivalent of rs-tfhe utils.rs:9-12.

    `((d % 1.0) * 2^32) as i64 as u32` — Rust `%` keeps the dividend's sign and
    the i64 cast truncates toward zero.
    """
    d = np.asarray(d, dtype=np.float64)
    frac = np.fmod(d, 1.0)
    return np.trunc(frac * _TWO32).astype(np.int64).astype(np.uint32)


def torus_to_f64(t) -> np.ndarray:
    """Reference: utils.rs:14-16."""
    return np.asarray(t, dtype=np.uint32).astype(np.float64) / _TWO32


def i32(value: int) -> int:
    """A Python int taken mod 2^32, as the int32 with the same bit pattern."""
    return ((int(value) + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor -> int32 tensor holding the value mod 2^32."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def resolve_device(device=None) -> torch.device:
    """The device an entry point makes its tensors on: the one asked for,
    else the card. Never the CPU unasked: without a CUDA device and without
    an explicit `device` this raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no device given and no CUDA device available: pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def to_torch(a, device=None) -> torch.Tensor:
    """uint32 (or int32) numpy array -> int32 tensor with the same bits, on
    `device` (None: the card, see `resolve_device`)."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype not in (np.uint32, np.int32):
        raise TypeError(f"expected a uint32/int32 torus array, got {a.dtype}")
    return torch.from_numpy(a.view(np.int32).copy()).to(resolve_device(device))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 numpy array with the same bits."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected an int32 torus tensor, got {t.dtype}")
    return t.detach().cpu().numpy().view(np.uint32)


def logical_rshift(x: torch.Tensor, shift: int) -> torch.Tensor:
    """uint32 `x >> shift` on the int32 carrier: arithmetic shift, then mask
    off the copies of the sign bit."""
    if shift == 0:
        return x
    return (x >> shift) & ((1 << (TORUS_BITS - shift)) - 1)


# ---------------------------------------------------------------------------
# Noise and mask sampling (distribution-equivalent to utils.rs:22-48)
# ---------------------------------------------------------------------------

class OsRandom:
    """Randomness for secret material straight from the operating system's
    CSPRNG (`os.urandom`), accepted wherever the key and encryption functions
    take a `torch.Generator`.

    A `torch.Generator` is seeded with 64 bits, so every key drawn from one
    rests on at most 64 bits of entropy; here each random word is read from
    the kernel's generator, which is seeded from its entropy pool with far
    more than 128 bits. The words are drawn on the host and moved to `device`
    (None: the card, `resolve_device`). Nothing is reproducible: this is the
    production path, the seeded `torch.Generator` the test and replay path.
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def words(self, shape) -> torch.Tensor:
        """Uniform 32-bit words, int32 `shape`, on the host."""
        count = int(np.prod(shape, dtype=np.int64))
        raw = np.frombuffer(os.urandom(4 * count), dtype=np.int32)
        return torch.from_numpy(raw.copy()).reshape(tuple(shape))

    def normal(self, shape) -> torch.Tensor:
        """Standard normal float64 samples, `shape`, on the host: Box-Muller
        on two 53-bit uniforms in (0, 1] from 64 random bits each."""
        count = int(np.prod(shape, dtype=np.int64))
        raw = np.frombuffer(os.urandom(16 * count), dtype=np.uint64).reshape(2, count)
        u = ((raw >> np.uint64(11)).astype(np.float64) + 1.0) * 2.0 ** -53
        z = np.sqrt(-2.0 * np.log(u[0])) * np.cos(2.0 * np.pi * u[1])
        return torch.from_numpy(z).reshape(tuple(shape))


def gaussian_torus(
    generator: torch.Generator | OsRandom, alpha: float, shape, device=None
) -> torch.Tensor:
    """Torus noise round-toward-zero(N(0, alpha) * 2^32) as int32.

    Matches the reference's gaussian_f64 (utils.rs:31-38) in distribution;
    the float -> int32 cast truncates toward zero as the reference's does.
    """
    device = device or generator.device
    if isinstance(generator, OsRandom):
        x = generator.normal(shape).to(device)
    else:
        x = torch.randn(shape, generator=generator, dtype=torch.float64, device=device)
    return (x * (alpha * _TWO32)).to(torch.int32)


def uniform_torus(generator: torch.Generator | OsRandom, shape, device=None) -> torch.Tensor:
    """Uniform 32-bit mask coefficients (reference: rng.gen::<u32>())."""
    device = device or generator.device
    if isinstance(generator, OsRandom):
        return generator.words(shape).to(device)
    return torch.randint(
        -(1 << 31), 1 << 31, shape, generator=generator, dtype=torch.int32, device=device,
    )


def uniform_bits(generator: torch.Generator | OsRandom, n: int) -> torch.Tensor:
    """n uniform bits as int32 {0, 1} on the generator's device (secret keys)."""
    if isinstance(generator, OsRandom):
        return (generator.words((n,)) & 1).to(generator.device)
    return torch.randint(0, 2, (n,), generator=generator, dtype=torch.int32, device=generator.device)


# ---------------------------------------------------------------------------
# Balanced signed 8-bit limb splitting (the JAX keys' storage format)
# ---------------------------------------------------------------------------

def split_u32_limbs_planar(x: torch.Tensor) -> torch.Tensor:
    """int32 [..., W] -> int8 [..., 4, W] balanced base-256 limbs, planar.

    x = l0 + l1*2^8 + l2*2^16 + l3*2^24 (mod 2^32) with l0..l2 in [-128, 127];
    the top limb may be +128, whose int8 wrap to -128 changes the value by
    2^32 = 0 (mod 2^32). Same limbs as `rs_tfhe_tpu.torus.split_u32_limbs_planar`.
    """
    limbs = []
    cur = x
    for _ in range(3):
        r = cur & 255
        carry = (r >= 128).to(torch.int32)
        limbs.append(r - 256 * carry)
        cur = (cur >> 8) + carry  # arithmetic shift: (cur - limb) / 256
    limbs.append(cur)
    return torch.stack(limbs, dim=-2).to(torch.int8)


def recombine_planar(acc: torch.Tensor) -> torch.Tensor:
    """int32 [..., 4, W] planar limb sums -> int32 [..., W] mod 2^32:
    sum_q acc[..., q, :] * 2^(8q), wrapping."""
    acc = acc.to(torch.int32)
    out = acc[..., 0, :]
    for q in range(1, 4):
        out = out + (acc[..., q, :] << (8 * q))
    return out


def neg_torus(x: torch.Tensor) -> torch.Tensor:
    """Exact torus negation -x mod 2^32 (the reference's `MAX - x` in its
    rotation and extraction wrap paths is off by one; the JAX package and the
    port both negate exactly)."""
    return torch.zeros_like(x) - x
