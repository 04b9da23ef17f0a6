"""Traffic kind `radix_mul`: one client sending batches of encrypted integer
products back to back.

A request is one product through the typed radix API (`*`) of a batch of
`batch` operand pairs, unsigned integers below 2^`bits` drawn from the seed,
each held as `digits` base-2^`base_bits` digits (least significant first,
message modulus 2^(base_bits+1): a digit and its carry bit); the result is
the full product, 2 * `digits` digits. A pool of `pool` batches is drawn
and encrypted in set-up, each batch's first pair the largest operands (the
column stage's worst case), kept on the host and taken in turn. A request
copies its batch to the device, runs the product and reads the product's
digits back; its latency runs from the copy until the digits are on the
host. A unit of work is a request; its groups are the product's LUT calls
(reference_mul.call_batches: 2D and 2D^2 ciphertexts a pair, then the
column stage's).

The check compares every request the window served: its digits against the
reference (reference_mul.py) on its operands (`words_differ`), and each
product digit's decoded message against the digit of x * y (`bits_wrong`:
the digits that decode wrongly).

The loop is radix_ops': after the window, standard error has the program's
counters moved in the window (`counters_window`) and its requests, then
whether the LUT calls and ciphertexts counted equal the requests' groups
(`groups_held`; absent for the control, which counts nothing).
"""

from __future__ import annotations

import json
import sys
import time

import torch

from .. import keygen, program_lut, program_mul
from .. import reference as R
from .. import reference_lut as RL
from .. import reference_mul as RM
from ..traffic import TRAFFIC_STREAM, Window
from . import radix_ops


class Loop(radix_ops.Loop):
    """radix_ops' closed loop (its `request` and `window`) over a pool of
    product batches."""

    def __init__(self, spec: dict, prog, keys: R.Keys, p: R.Params, seed: int, device):
        self.spec, self.prog, self.keys, self.p, self.device = spec, prog, keys, p, device
        self.digits, self.base_bits = spec["digits"], spec["base_bits"]
        g = keygen.generator(seed ^ TRAFFIC_STREAM, device)
        top = 1 << spec["bits"]
        self.values = torch.randint(0, top, (spec["pool"], 2, spec["batch"]), generator=g, dtype=torch.int64,
                                    device=device)
        self.values[:, :, 0] = top - 1
        msgs = RL.digits_of(self.values, self.digits, self.base_bits)  # [pool, 2, batch, D]
        pool = RL.encrypt(g, keys.lv0, msgs, 2 << self.base_bits, p.alpha_lv0).cpu()
        self.pool = pool.pin_memory() if torch.device(device).type == "cuda" else pool
        self.run = program_mul.radix_mul_entry(prog, self.base_bits)
        self.calls = RM.call_batches(self.digits, self.base_bits, spec["batch"])
        self.served: list = []  # (pool index, product digits on the host)

    def warm(self) -> None:
        """One request: it builds the product's tables and places them on
        the device."""
        self.request(0)
        self.served.clear()

    def window(self, seconds: float, profiler=None, traced_units: int = 0) -> Window:
        before = program_lut.counters(self.prog)
        window = super().window(seconds, profiler, traced_units)
        moved = program_lut.moved(before, program_lut.counters(self.prog))
        if moved:
            n = len(window.units)
            held = (moved.get("pbs.calls"), moved.get("pbs.ciphertexts")) == (len(self.calls) * n, sum(self.calls) * n)
            print(f"groups_held {json.dumps(held)}", file=sys.stderr, flush=True)
        return window

    def check(self, dtype=torch.float64) -> dict:
        """Every request served in the window against the reference on its
        operands, all in one reference pass; its decoded digits against the
        plain product's."""
        used = sorted({i for i, _ in self.served})
        pos = {i: k for k, i in enumerate(used)}
        ops = self.pool[used].to(self.device)  # [U, 2, batch, D, n0+1]
        t0 = time.perf_counter()
        ref = RM.mul_radix(ops[:, 0], ops[:, 1], self.keys, self.p, self.base_bits, dtype).cpu()
        print(f"reference_s {time.perf_counter() - t0:.3f} for {len(used)} requests", file=sys.stderr, flush=True)
        vals = self.values[torch.tensor(used, device=self.device)]
        want = RL.digits_of(vals[:, 0] * vals[:, 1], 2 * self.digits, self.base_bits).cpu()
        lv0 = self.keys.lv0.cpu()
        words = wrong = failed = 0
        for i, out in self.served:
            diff = int((out != ref[pos[i]]).sum())
            bad = int((RL.decode(out, lv0, 2 << self.base_bits) != want[pos[i]]).sum())
            words, wrong, failed = words + diff, wrong + bad, failed + bool(diff or bad)
        return {"compared": {"requests": len(self.served), "distinct": len(used),
                             "words": len(self.served) * ref[0].numel()},
                "words_differ": words, "bits_wrong": wrong, "failed": failed}
