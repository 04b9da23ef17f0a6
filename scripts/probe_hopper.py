"""Probe what an NVIDIA Hopper card takes, capability by capability: the
counterpart of scripts/probe_mosaic.py for the PyTorch port.

One PASS/FAIL line per capability, each run through the hand-written kernels
of rs_tfhe_tpu_torch/csrc/probes.cu and held against its plain PyTorch
version on full-range random inputs (a FAIL names the first difference):

  - integer dots -> int32 at [128,1024]x[1024,256]: s8 on the tensor cores
    (mma.sync m16n8k32); s16 and s32 on the CUDA cores, since Hopper's
    tensor cores have no 16- or 32-bit integer type;
  - that each dot wraps mod 2^32 (against an int64 numpy product);
  - rolls of int8, int16 and int32 rows (an indexed shared-memory read);
  - the int32 -> 4 x int8 bitcast and the two-s16 unpack.

Usage: python scripts/probe_hopper.py            (needs a CUDA device)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from rs_tfhe_tpu_torch.ops import cuda_probes as CP  # noqa: E402

_RANGE = {torch.int8: (-128, 128), torch.int16: (-(1 << 15), 1 << 15), torch.int32: (-(1 << 31), 1 << 31)}
_NAME = {torch.int8: "s8", torch.int16: "s16", torch.int32: "s32"}


def run(name, fn) -> bool:
    try:
        fn()
        torch.cuda.synchronize()
        print(f"PASS  {name}")
        return True
    except Exception as e:  # a probe reports a failure and goes on to the next
        msg = str(e).split("\n")[0][:200]
        print(f"FAIL  {name}: {type(e).__name__}: {msg}")
        return False


def _same(out, ref, what):
    for o, r in zip(out if isinstance(out, tuple) else (out,), ref if isinstance(ref, tuple) else (ref,)):
        if not torch.equal(o, r):
            where = (o != r).nonzero()[0].tolist()
            raise AssertionError(f"{what}: kernel != plain version, first at {where}")
    return out


def probes(device, seed: int = 0):
    """[(name, function)]: each function launches one probe kernel and
    raises unless it equals its plain version."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(shape, dtype):
        return torch.randint(*_RANGE[dtype], shape, generator=g, dtype=dtype, device=device)

    def dot(dtype):
        a, b = rnd((128, 1024), dtype), rnd((1024, 256), dtype)
        return _same(CP.probe_dot(a, b), CP.dot_plain(a, b), "dot")

    def roll(dtype):
        x = rnd((8, 256), dtype)
        return _same(CP.probe_roll(x, 5), CP.roll_plain(x, 5), "roll")

    def bitcast():
        x = rnd((8, 256), torch.int32)
        return _same(CP.probe_bitcast_i32_to_i8(x), CP.bitcast_i32_to_i8_plain(x), "bitcast")

    def unpack():
        x = rnd((8, 256), torch.int32)
        return _same(CP.probe_unpack_s16(x), CP.unpack_s16_plain(x), "unpack")

    out = []
    for dtype, n in _NAME.items():
        out.append((f"dot {n}x{n}->s32 [128,1024]x[1024,256] on the {CP.dot_unit(dtype)}",
                    lambda dtype=dtype: dot(dtype)))
    for dtype, n in _NAME.items():
        out.append((f"dot {n} CORRECTNESS (wrap mod 2^32)",
                    lambda dtype=dtype: CP.probe_dot_correct_s16(device, dtype)))
    for dtype in _NAME:
        out.append((f"roll {str(dtype).removeprefix('torch.')}", lambda dtype=dtype: roll(dtype)))
    out.append(("bitcast i32->i8 in-kernel", bitcast))
    out.append(("unpack 2x s16 from i32 via shifts", unpack))
    return out


def main(device=None) -> bool:
    """Run every probe; True if all passed."""
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("probe_hopper: no CUDA device available")
        device = torch.device("cuda")
    print("device:", torch.cuda.get_device_name(device))
    print("note: Hopper's tensor cores take no s16 or s32 integer operands; those dots run on the CUDA cores")
    return all([run(name, fn) for name, fn in probes(device)])


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
