"""The system under test for the LUT kinds (`kinds/lut_layers.py`,
`kinds/radix_ops.py`): the benchmark's second module that imports the
program (`rs_tfhe_tpu_torch`), beside program.py, whose `Program` holds the
cloud key it drives.

Each entry returns the function that the timed window calls:

  lut_entry(prog, modulus) -> run(ct, f): one programmable bootstrap of the
      batch `ct` through `bootstrap.LutBootstrap().bootstrap_func` (one
      strategy an entry, so its table cache serves the window; `f` a
      module-level function, the cache's key);
  radix_add_entry(prog, base_bits) -> run(a, b): one radix add of the digit
      vectors `a`, `b` through the typed API (`fhe.FheUintRadix`'s `+`, with
      the API's default `multi_value=False`).

Handed the control (control.ReferenceProgram), each entry is the plain
reference in the control's precision (reference_lut.py), on the control's
keys. `counters(prog)` is the program's counter snapshot
(`utils.profiling.counters()`), empty for the control; `moved` the
difference of two.
"""

from __future__ import annotations

from . import reference_lut as RL


def _is_program(prog) -> bool:
    return getattr(prog, "ck", None) is not None


def lut_entry(prog, modulus: int):
    if not _is_program(prog):
        keys, p, dtype = prog.keys, prog.p, prog.dtype
        return lambda ct, f: RL.lut_bootstrap(ct, RL.testvec_of(f, modulus, p, ct.device), keys, p,
                                              ct.shape[0], dtype)
    from rs_tfhe_tpu_torch import bootstrap

    strategy, ck = bootstrap.LutBootstrap(), prog.ck
    return lambda ct, f: strategy.bootstrap_func(ct, f, modulus, ck)


def radix_add_entry(prog, base_bits: int):
    if not _is_program(prog):
        keys, p, dtype = prog.keys, prog.p, prog.dtype
        return lambda a, b: RL.add_radix(a[None], b[None], keys, p, base_bits, dtype)[0]
    from rs_tfhe_tpu_torch.fhe import FheUintRadix

    ck = prog.ck
    return lambda a, b: (FheUintRadix(a, base_bits, ck) + FheUintRadix(b, base_bits, ck)).digits


def counters(prog) -> dict:
    if not _is_program(prog):
        return {}
    from rs_tfhe_tpu_torch.utils import profiling

    return profiling.counters()


def moved(before: dict, after: dict) -> dict:
    """The counters that moved between two snapshots, and by how much."""
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
