"""The system under test for the product kind (`kinds/radix_mul.py`): the
benchmark's third module that imports the program (`rs_tfhe_tpu_torch`),
beside program.py, whose `Program` holds the cloud key it drives, and
program_lut.py, whose counter snapshot (`counters`, `moved`) it reads.

  radix_mul_entry(prog, base_bits) -> run(a, b): the full product of the
      digit-vector batches a, b int32 [M, D, n0+1] through the typed API
      (`fhe.FheUintRadix`'s `*`, models.arithmetic.mul_radix) on `prog.ck`:
      [M, 2D, n0+1].

Handed the control (control.ReferenceProgram), the entry is the plain
reference (reference_mul.py) in the control's precision, on the control's
keys.
"""

from __future__ import annotations

from . import reference_mul as RM


def radix_mul_entry(prog, base_bits: int):
    if getattr(prog, "ck", None) is None:
        keys, p, dtype = prog.keys, prog.p, prog.dtype
        return lambda a, b: RM.mul_radix(a[None], b[None], keys, p, base_bits, dtype)[0]
    from rs_tfhe_tpu_torch.fhe import FheUintRadix

    ck = prog.ck
    return lambda a, b: (FheUintRadix(a, base_bits, ck) * FheUintRadix(b, base_bits, ck)).digits
