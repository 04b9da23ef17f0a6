"""Encrypted-circuit model zoo built on the gate layer, as
rs_tfhe_tpu/models/__init__.py (the boolean-circuit half: `circuits` and
`netlist`)."""

from .circuits import (  # noqa: F401
    add_kogge_stone,
    add_ripple_carry,
    divmod_bits,
    equals,
    greater_than,
    mul_csa,
    sub,
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
