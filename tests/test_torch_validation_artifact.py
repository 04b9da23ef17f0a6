"""PyTorch port: the committed production-set golden vectors of
scripts/torch/tpu_validation.py, tests/vectors/golden_production_torch.npz,
written by its full run on the card (--write-golden).

The file must hold every array the JAX script records, under the JAX
script's names (read from scripts/tpu_validation.py by AST), as int32
ciphertexts of the port's shapes: the strict set's gates, MUX, PBS, radix
add and Kogge-Stone [B, 701] (B = 64, 2, 64, 8, 3, 16), UINT4 [16, 821],
NIBBLE [256, 2, 1161] and [32, 8, 1161]; where JAX's own golden file has a
name, the same shape. It fails if the file is missing: chip_smoke.py phase
20 verifies every entry on the card."""

import ast
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "vectors" / "golden_production_torch.npz"
JAX_GOLDEN = ROOT / "tests" / "vectors" / "golden_production.npz"
SHAPES = {
    "nand_128": (64, 701), "nand_mb_128": (2, 701), "mux_128": (64, 701), "pbs_square_128": (8, 701),
    "radix_add_128": (3, 701), "kogge_stone_128": (16, 701), "pbs_uint4": (16, 821),
    "nibble_add": (256, 2, 1161), "mul_radix_nibble": (32, 8, 1161),
}


def _jax_names() -> set:
    tree = ast.parse((ROOT / "scripts" / "tpu_validation.py").read_text())
    return {node.args[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id == "record"}


def test_golden_file_holds_every_stage():
    assert GOLDEN.exists(), f"{GOLDEN} is missing: run scripts/torch/tpu_validation.py --write-golden on the card"
    names = _jax_names()
    assert names == set(SHAPES) and "nand_mb_128" in names
    with np.load(GOLDEN) as z, np.load(JAX_GOLDEN) as j:
        assert sorted(z.files) == sorted(SHAPES)
        for name, shape in SHAPES.items():
            arr = z[name]
            assert arr.dtype == np.int32 and arr.shape == shape, (name, arr.dtype, arr.shape)
            if name in j.files:
                assert j[name].shape == shape
            # ciphertexts: masks are full-range words, never a constant fill
            assert len(np.unique(arr[..., :-1])) > arr[..., :-1].size // 2
