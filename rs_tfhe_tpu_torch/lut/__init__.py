"""Programmable (LUT) bootstrapping components (reference src/lut/;
rs_tfhe_tpu/lut/)."""

from .encoder import Encoder  # noqa: F401
from .generator import Generator, div_round  # noqa: F401
from .lookup_table import LookupTable  # noqa: F401
from .multi_value import (  # noqa: F401
    MultiValueLuts,
    factor_test_vectors,
    multi_value_bootstrap,
)
