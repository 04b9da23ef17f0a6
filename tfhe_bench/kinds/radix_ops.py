"""Traffic kind `radix_ops`: one client sending encrypted integer adds back
to back.

A request is one radix add of two unsigned integers drawn from the seed
below 2^`bits`, each held as `digits` base-8 digits (BASE_BITS; least
significant first, message modulus 16: a digit and its carry bit),
encrypted in set-up into a host-side pool of `pool` operand pairs and taken
in turn. It copies its operands to the device, runs the operation and
reads the result's digits back; its latency runs from the copy until the
digits are on the host. A unit of work is a request; an add of D digits
makes D rotation calls, D-1 of 2 ciphertexts (each digit's sum and carry,
per-ciphertext test vectors) and one of 1 (the last digit's sum).

The check compares every request the window served: its digits against the
reference (reference_lut.py) on its operands (`words_differ`), and each
digit's decoded message against the digit of (a + b) mod 8^digits
(`bits_wrong`: the digits that decode wrongly).

After the window, standard error has the program's counters moved in the
window (`counters_window`) and its requests.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from .. import keygen, program_lut
from .. import reference as R
from .. import reference_lut as RL
from ..traffic import TRAFFIC_STREAM, Unit, Window, sync

#: bits a digit: the typed API's default base
BASE_BITS = 3


class Loop:
    def __init__(self, spec: dict, prog, keys: R.Keys, p: R.Params, seed: int, device):
        self.spec, self.prog, self.keys, self.p, self.device = spec, prog, keys, p, device
        self.digits = spec["digits"]
        g = keygen.generator(seed ^ TRAFFIC_STREAM, device)
        self.values = torch.randint(0, 1 << spec["bits"], (spec["pool"], 2), generator=g, dtype=torch.int64,
                                    device=device)
        msgs = RL.digits_of(self.values, self.digits, BASE_BITS)  # [pool, 2, D]
        pool = RL.encrypt(g, keys.lv0, msgs, 2 << BASE_BITS, p.alpha_lv0).cpu()
        self.pool = pool.pin_memory() if torch.device(device).type == "cuda" else pool
        self.run = program_lut.radix_add_entry(prog, BASE_BITS)
        self.calls = [2] * (self.digits - 1) + [1]
        self.served: list = []  # (pool index, result digits on the host)

    def request(self, i: int) -> Unit:
        t0 = time.perf_counter()
        x = self.pool[i % len(self.pool)].to(self.device)
        te = time.perf_counter()
        out = self.run(x[0], x[1])
        t1 = time.perf_counter()
        out = out.cpu()
        done = time.perf_counter()
        self.served.append((i % len(self.pool), out))
        return Unit(groups=self.calls, latency_s=done - t0, enqueue_s=t1 - te)

    def warm(self) -> None:
        """Two requests: the first builds the operation's tables and places
        them on the device."""
        for i in range(2):
            self.request(i)
        self.served.clear()

    def window(self, seconds: float, profiler=None, traced_units: int = 0) -> Window:
        units = []
        before = program_lut.counters(self.prog)
        if profiler is not None:
            profiler.start()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or len(units) < traced_units:
            units.append(self.request(len(units)))
            if profiler is not None and len(units) <= traced_units:
                units[-1].traced = True
                if len(units) == traced_units:
                    sync(self.device)
                    profiler.stop()
        window = Window(units=units, seconds=time.perf_counter() - t0)
        print("counters_window " + json.dumps({"requests": len(units),
                                               **program_lut.moved(before, program_lut.counters(self.prog))}),
              file=sys.stderr, flush=True)
        return window

    def check(self, dtype=torch.float64) -> dict:
        """Every request served in the window against the reference on its
        operands; its decoded digits against the plain sum's."""
        used = sorted({i for i, _ in self.served})
        pos = {i: k for k, i in enumerate(used)}
        ops = self.pool[used].to(self.device)  # [R, 2, D, n0+1]
        ref = RL.add_radix(ops[:, 0], ops[:, 1], self.keys, self.p, BASE_BITS, dtype).cpu()
        vals = self.values[torch.tensor(used, device=self.device)]
        total = (vals[:, 0] + vals[:, 1]) % (1 << (BASE_BITS * self.digits))
        want = RL.digits_of(total, self.digits, BASE_BITS).cpu()
        lv0 = self.keys.lv0.cpu()
        words = wrong = failed = 0
        for i, out in self.served:
            diff = int((out != ref[pos[i]]).sum())
            bad = int((RL.decode(out, lv0, 2 << BASE_BITS) != want[pos[i]]).sum())
            words, wrong, failed = words + diff, wrong + bad, failed + bool(diff or bad)
        return {"compared": {"requests": len(self.served), "distinct": len(used)},
                "words_differ": words, "bits_wrong": wrong, "failed": failed}
