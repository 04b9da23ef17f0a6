"""The control of the check that decides `correct`: the plain reference put
in the program's place and computed in float32, the precision below the
float64 in which the reference is exact. Its outputs must come out as not
correct. The benchmark's own runs never run it.

    python3 -m tfhe_bench.control --workload <cell> --seeds 1,2,3 --seconds 2

runs the cell's set-up and a short window at the cell's own load for each
seed, with the control in the program's place, and prints one JSON line a
seed with the compared numbers.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import reference as R
from . import run


class ReferenceProgram:
    """The reference in `dtype`, behind the interface of program.Program."""

    def __init__(self, cfg: dict, keys: R.Keys, p: R.Params, device, dtype=torch.float32):
        self.keys, self.p, self.dtype = keys, p, dtype

    def batch_gate(self, name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return R.gate(name, a, b, self.keys, self.p, a.shape[0], self.dtype)

    def compile_circuit(self, n_inputs: int, gate_list: list):
        return lambda inputs: R.evaluate(inputs[None], n_inputs, gate_list, self.keys, self.p, self.dtype)[0]

    @staticmethod
    def launches() -> dict:
        return {}


def control_program(cfg: dict, keys: R.Keys, p: R.Params, device):
    """The control: float32 with TF32 off, so its products are float32's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return ReferenceProgram(cfg, keys, p, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    manifest = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in manifest["workloads"] if w["name"] == args.workload)
    config = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    cfg = json.loads((run.ROOT / config["file"]).read_text())
    spec = json.loads((run.BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    for seed in (int(s) for s in args.seeds.split(",")):
        result, lines = run.run_cell(cfg, spec, seed, args.seconds, False, torch.device("cuda:0"), [],
                                     make_program=control_program)
        print(json.dumps({"seed": seed, "correct": result["correct"], "attempted": result["attempted"],
                          "checks": result["checks"], "compared": lines[0]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
