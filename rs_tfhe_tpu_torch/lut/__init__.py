"""Programmable (LUT) bootstrapping components (reference src/lut/;
rs_tfhe_tpu/lut/). Multi-value bootstrapping (rs_tfhe_tpu/lut/multi_value.py)
is not ported yet."""

from .encoder import Encoder  # noqa: F401
from .generator import Generator, div_round  # noqa: F401
from .lookup_table import LookupTable  # noqa: F401
