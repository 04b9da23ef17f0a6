"""Enumerate all parameter sets with the PyTorch port (the counterpart of
examples/security_levels.py; reference: examples/security_levels.rs).

Every set is a runtime config: pass any of them to SecretKey.generate and
the whole pipeline, the kernels' ring size and gadget included, follows it.
Nothing here touches a device.

    python examples/torch/security_levels.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import rs_tfhe_tpu_torch as tfhe  # noqa: E402


def main(argv=None):
    print(f"{'name':<18} {'n0':>5} {'N':>5} {'L':>2} {'bgbit':>5} {'basebit':>7} {'iks_t':>5}  description")
    for name, p in tfhe.ALL_SECURITY_SETS.items():
        g = p.trgsw_lv1
        print(
            f"{name:<18} {p.n0:>5} {p.n1:>5} {g.l:>2} {g.bgbit:>5} {g.basebit:>7} "
            f"{g.iks_t:>5}  {p.description}"
        )
        print(f"{'':18} -> {tfhe.security_info(p)}")


if __name__ == "__main__":
    main()
