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
(the `generate_secure` keys). Public mask streams, which seeded ciphertexts
and key files replay, come from threefry-2x32 under JAX's key derivation
(`key_data`, `split`, `fold_in`, `random_bits`), bit for bit.
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


def random_key(generator: torch.Generator | OsRandom) -> torch.Tensor:
    """A fresh threefry key: two uniform words from `generator`, int32 [2] on
    the host. It seeds public masks only (`threefry2x32_bits`)."""
    return uniform_torus(generator, (2,)).cpu()


def uniform_bits(generator: torch.Generator | OsRandom, n: int) -> torch.Tensor:
    """n uniform bits as int32 {0, 1} on the generator's device (secret keys)."""
    if isinstance(generator, OsRandom):
        return (generator.words((n,)) & 1).to(generator.device)
    return torch.randint(0, 2, (n,), generator=generator, dtype=torch.int32, device=generator.device)


# ---------------------------------------------------------------------------
# Threefry-2x32 and JAX's key derivation (public mask streams)
# ---------------------------------------------------------------------------

_THREEFRY_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_MASK32 = 0xFFFFFFFF


def _key_words(key) -> tuple[int, int]:
    """A threefry key given as two 32-bit words (an int32 tensor, a uint32
    numpy array or a pair of ints) -> the two words as unsigned Python ints."""
    if isinstance(key, torch.Tensor):
        key = key.tolist()
    words = [int(w) & _MASK32 for w in np.asarray(key, dtype=np.int64).reshape(-1)]
    if len(words) != 2:
        raise ValueError(f"a threefry key is two 32-bit words, got {len(words)}")
    return words[0], words[1]


def key_tensor(key) -> torch.Tensor:
    """A threefry key (two words, in any form `_key_words` takes) as the
    int32 [2] host tensor the port keeps and ships: JAX's uint32 key data,
    bit for bit."""
    return torch.tensor([i32(w) for w in _key_words(key)], dtype=torch.int32)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | logical_rshift(x, TORUS_BITS - r)


def _threefry2x32(key, x1: torch.Tensor, x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block (20 rounds; Salmon et al., Random123) of the
    counters (x1, x2), int32 tensors, under `key`: the two output words."""
    k1, k2 = _key_words(key)
    ks = (i32(k1), i32(k2), i32(k1 ^ k2 ^ 0x1BD11BDA))
    x1, x2 = x1 + ks[0], x2 + ks[1]
    for i in range(5):
        for r in _THREEFRY_ROT[i % 2]:
            x1 = x1 + x2
            x2 = _rotl(x2, r) ^ x1
        x1 = x1 + ks[(i + 1) % 3]
        x2 = x2 + i32(ks[(i + 2) % 3] + i + 1)
    return x1, x2


def _counters(start: int, count: int, device) -> torch.Tensor:
    """Low counter words start .. start+count-1 as int32; raises past 2^32
    (the high word stays 0, as in JAX for streams below 2^32 words)."""
    if start < 0 or start + count > 1 << TORUS_BITS:
        raise ValueError(
            f"counters [{start}, {start + count}) leave the 32-bit threefry counter range"
        )
    return wrap_i32(torch.arange(start, start + count, dtype=torch.int64, device=device))


def threefry2x32_bits(key, start: int, count: int, device=None) -> torch.Tensor:
    """Random words for the flat counters [start, start+count): int32
    [count] on `device` (None: the card, `resolve_device`).

    Bit for bit `jax.random.bits(k, shape, uint32).ravel()[start:start+count]`
    under JAX's default partitionable threefry, whose counter for element i is
    (0, i) and whose word is o1 ^ o2 of the block
    (rs_tfhe_tpu/torus.py:77-119), and the native client's `threefry_bits`.
    `key`: two words, as `_key_words` takes them.
    """
    x2 = _counters(start, count, resolve_device(device))
    o1, o2 = _threefry2x32(key, torch.zeros_like(x2), x2)
    return o1 ^ o2


def threefry2x32_bits_raw(k1: int, k2: int, start: int, count: int, device=None) -> torch.Tensor:
    """`threefry2x32_bits` from the key's two words, as a seeded ciphertext
    ships them (rs_tfhe_tpu/torus.py:103-119)."""
    return threefry2x32_bits((k1, k2), start, count, device)


def key_data(seed: int) -> torch.Tensor:
    """`jax.random.key_data(jax.random.key(seed))` as int32 [2] on the host.

    JAX takes a Python int seed as int64 and, in its default 32-bit mode,
    keeps its low 32 bits: the key is (0, seed mod 2^32), for negative seeds
    too (`rs_tfhe_tpu.key.secure_prng_key` draws signed 64-bit seeds)."""
    if not -(1 << 63) <= int(seed) < 1 << 63:
        raise ValueError(f"seed {seed} does not fit in 64 bits")
    return torch.tensor([0, i32(int(seed) & _MASK32)], dtype=torch.int32)


def split(key, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)` as int32 [num, 2] on the host. Under
    partitionable threefry new key i is both output words of the block at
    counter (0, i), not their XOR."""
    o1, o2 = _threefry2x32(key, torch.zeros(num, dtype=torch.int32), _counters(0, num, "cpu"))
    return torch.stack([o1, o2], dim=-1)


def fold_in(key, data: int) -> torch.Tensor:
    """`jax.random.fold_in(key, data)` as int32 [2] on the host: both words of
    the block at counter (0, data mod 2^32)."""
    x2 = torch.tensor([i32(int(data) & _MASK32)], dtype=torch.int32)
    o1, o2 = _threefry2x32(key, torch.zeros_like(x2), x2)
    return torch.cat([o1, o2])


def random_bits(key, shape, device=None) -> torch.Tensor:
    """`jax.random.bits(key, shape, uint32)` as int32 `shape` on `device`
    (None: the card): the flat-counter stream, o1 ^ o2."""
    count = int(np.prod(shape, dtype=np.int64))
    return threefry2x32_bits(key, 0, count, device).reshape(tuple(shape))


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


def split_u32_limbs(x: torch.Tensor) -> torch.Tensor:
    """int32 [...] -> int8 [..., 4] balanced base-256 limbs, interleaved: the
    limbs of `split_u32_limbs_planar` on a new minor axis, bit-equal to
    `rs_tfhe_tpu.torus.split_u32_limbs`."""
    return split_u32_limbs_planar(x.unsqueeze(-1)).squeeze(-1)


def recombine_planar(acc: torch.Tensor) -> torch.Tensor:
    """int32 [..., 4, W] planar limb sums -> int32 [..., W] mod 2^32:
    sum_q acc[..., q, :] * 2^(8q), wrapping."""
    acc = acc.to(torch.int32)
    out = acc[..., 0, :]
    for q in range(1, 4):
        out = out + (acc[..., q, :] << (8 * q))
    return out


def limb_width(width: int, lanes: int = 8) -> int:
    """Columns per limb plane of a planar table of rows `width` wide: width
    rounded up to `lanes` (8, the port's int8 product; 128, the JAX
    package's TPU lanes, `rs_tfhe_tpu.torus.lane_pad`)."""
    return -(-width // lanes) * lanes


def planar_limbs(rows: torch.Tensor, lanes: int = 8) -> torch.Tensor:
    """Torus rows int32 [R, W] -> planar limb table int8 [R, 4*P], P =
    limb_width(W, lanes): column q*P + c holds limb q of coefficient c, and
    the padding columns are zero."""
    r, w = rows.shape
    padded = torch.nn.functional.pad(rows, (0, limb_width(w, lanes) - w))
    return split_u32_limbs_planar(padded).reshape(r, -1)


def rows_from_planar_limbs(limbs: torch.Tensor, width: int) -> torch.Tensor:
    """Planar limb table int8 [R, 4*P] (either layout) -> torus rows int32
    [R, width]: the planes recombined mod 2^32, the padding dropped."""
    r, cols = limbs.shape
    if limbs.dtype != torch.int8 or cols % 4 or cols // 4 < width:
        raise ValueError(f"expected an int8 planar table of at least 4*{width} columns, "
                         f"got {limbs.dtype} {tuple(limbs.shape)}")
    return recombine_planar(limbs.reshape(r, 4, cols // 4))[:, :width]


def neg_torus(x: torch.Tensor) -> torch.Tensor:
    """Exact torus negation -x mod 2^32 (the reference's `MAX - x` in its
    rotation and extraction wrap paths is off by one; the JAX package and the
    port both negate exactly)."""
    return torch.zeros_like(x) - x
