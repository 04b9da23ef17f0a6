"""Traffic kind `lut_layers`: chained layers of programmable bootstraps.

Layer k bootstraps `batch` radix blocks (messages mod MODULUS) through the
function functions[k % len(functions)] (FUNCTIONS below: each maps a slot
to a digit, [0, MODULUS/2)); its input is layer k-1's output (a batch
encrypted in set-up, messages drawn from the seed over all MODULUS slots,
for layer 0). At most `queue_depth` layers are queued ahead of the card. A
unit of work is a layer, one rotation call of `batch`.

The check compares three layers, every row of each, as `gate_layers` does:
the first, one drawn from the seed over the window's layers, and the last.
A later layer's input is the program's output of the layer before, taken
as it was read back. Each output against the reference (reference_lut.py)
on the same input (`words_differ`), and each output's decoded message
against the function of its input's decoded message (`bits_wrong`: the
messages that decode wrongly).

After the window, standard error has the program's counters moved in the
window (`counters_window`) and its layers.
"""

from __future__ import annotations

import collections
import json
import random
import sys
import time

import torch

from .. import keygen, program_lut
from .. import reference as R
from .. import reference_lut as RL
from ..traffic import TRAFFIC_STREAM, Unit, Window, marker, sync

#: the draw of the compared layer, apart from the traffic's own stream
_DRAW_STREAM = 0x6472
#: the message modulus of a radix block: a base-8 digit and its carry bit
MODULUS = 16


def _inc(x):
    return (x + 1) % 8


def _affine3(x):
    return (3 * x + 1) % 8


def _square(x):
    return x * x % 8


def _reflect(x):
    return 7 - x % 8


#: the per-digit functions a traffic file may name: module-level, so that
#: the program's table cache keys on the same object in every layer
FUNCTIONS = {"inc": _inc, "affine3": _affine3, "square": _square, "reflect": _reflect}


class Loop:
    def __init__(self, spec: dict, prog, keys: R.Keys, p: R.Params, seed: int, device):
        self.spec, self.prog, self.keys, self.p, self.device = spec, prog, keys, p, device
        self.batch = spec["batch"]
        self.functions = [FUNCTIONS[name] for name in spec["functions"]]
        g = keygen.generator(seed ^ TRAFFIC_STREAM, device)
        msgs = torch.randint(0, MODULUS, (self.batch,), generator=g, device=device)
        self.x0 = RL.encrypt(g, keys.lv0, msgs, MODULUS, p.alpha_lv0)
        self.run = program_lut.lut_entry(prog, MODULUS)
        self.draw = random.Random(seed ^ _DRAW_STREAM)
        self.kept: dict = {}  # role -> (layer, its input, its output)
        self.layers = 0

    def warm(self) -> None:
        """Each function of the mix once at the window's batch (its table
        built and cached)."""
        for f in self.functions:
            out = self.run(self.x0, f)
        int(out[-1, -1])

    def window(self, seconds: float, profiler=None, traced_units: int = 0) -> Window:
        depth = self.spec["queue_depth"]
        pending: collections.deque = collections.deque()
        units, cur = [], self.x0
        kept = self.kept
        before = program_lut.counters(self.prog)
        if profiler is not None:
            profiler.start()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or len(units) < traced_units:
            k = len(units)
            te = time.perf_counter()
            prev, cur = cur, self.run(cur, self.functions[k % len(self.functions)])
            units.append(Unit(groups=[self.batch], enqueue_s=time.perf_counter() - te,
                              traced=profiler is not None and k < traced_units))
            if k == 0:
                kept["first"] = (k, prev, cur)
            if self.draw.randrange(k + 1) == 0:
                kept["drawn"] = (k, prev, cur)
            pending.append(marker(self.device))
            if profiler is not None and len(units) == traced_units:
                sync(self.device)
                profiler.stop()
                pending.clear()
            while len(pending) > depth:
                ev = pending.popleft()
                if ev is not None:
                    ev.synchronize()
        int(cur[-1, -1])  # the last layer's result read on the host
        seconds = time.perf_counter() - t0
        kept["last"] = (len(units) - 1, prev, cur)
        self.layers = len(units)
        print("counters_window " + json.dumps({"layers": self.layers,
                                               **program_lut.moved(before, program_lut.counters(self.prog))}),
              file=sys.stderr, flush=True)
        return Window(units=units, seconds=seconds)

    def check(self, dtype=torch.float64) -> dict:
        """The kept layers, every row, against the reference on the same
        inputs; their decoded messages against the function of the decoded
        inputs."""
        layers = {k: (a, out) for k, a, out in self.kept.values()}
        words = wrong = failed = 0
        for k in sorted(layers):
            a, out = layers[k]
            f = self.functions[k % len(self.functions)]
            tv = RL.testvec_of(f, MODULUS, self.p, a.device)
            ref = RL.lut_bootstrap(a, tv, self.keys, self.p, self.batch, dtype)
            diff = int((ref != out).sum())
            want = RL.decode(a, self.keys.lv0, MODULUS).cpu().apply_(f)
            bad = int((RL.decode(out, self.keys.lv0, MODULUS).cpu() != want).sum())
            words, wrong, failed = words + diff, wrong + bad, failed + bool(diff or bad)
        return {"compared": {"layers": sorted(layers), "of": self.layers, "rows": len(layers) * self.batch},
                "words_differ": words, "bits_wrong": wrong, "failed": failed}
