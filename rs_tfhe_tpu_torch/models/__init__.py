"""Homomorphic circuit and arithmetic models built on the gate and LUT
layers, with the exports of rs_tfhe_tpu/models/__init__.py."""

from .arithmetic import (  # noqa: F401
    add_radix,
    apply_lut_radix,
    decrypt_radix,
    encrypt_radix,
    mul_radix,
    sub_radix,
)
from .circuits import (  # noqa: F401
    add_kogge_stone,
    add_ripple_carry,
    divmod_bits,
    equals,
    greater_than,
    mul_csa,
    sub,
)
from .sort import (  # noqa: F401
    sort_bits,
    sort_radix,
    top_k_bits,
)
from .netlist import (  # noqa: F401
    Circuit,
    Gate,
    Plan,
    compile_circuit,
    evaluate,
    plan,
    ripple_carry_adder,
)
