"""Traffic kind `gate_layers`: chained batched gate layers.

Layer k runs gate gates[k % len(gates)] over `batch` ciphertexts; its first
operand is layer k-1's output (a batch encrypted in set-up for layer 0), its
second a fixed batch encrypted in set-up. At most `queue_depth` layers are
queued ahead of the card. A unit of work is a layer.

The check compares three layers, every row of each: the first, whose input
is the benchmark's own encryption; one drawn from the seed, uniformly over
all the window's layers (a reservoir of one, drawn as each layer is
queued); and the last. A later layer's input is the program's output of the
layer before, which the check takes as it was read back. Only those layers'
inputs and outputs are kept, so what the run holds on the card does not
grow with the window.
"""

from __future__ import annotations

import collections
import random
import time

import torch

from .. import keygen
from .. import reference as R
from ..traffic import TRAFFIC_STREAM, Unit, Window, marker, sync

#: the draw of the compared layer, apart from the traffic's own stream
_DRAW_STREAM = 0x6472


class Loop:
    def __init__(self, spec: dict, prog, keys: R.Keys, p: R.Params, seed: int, device):
        self.spec, self.prog, self.keys, self.p, self.device = spec, prog, keys, p, device
        self.batch, self.gates = spec["batch"], spec["gates"]
        g = keygen.generator(seed ^ TRAFFIC_STREAM, device)
        bits = torch.randint(0, 2, (2, self.batch), generator=g, device=device).bool()
        self.x0 = keygen.encrypt_bits(g, keys.lv0, bits[0], p.alpha_lv0)
        self.fixed = keygen.encrypt_bits(g, keys.lv0, bits[1], p.alpha_lv0)
        self.draw = random.Random(seed ^ _DRAW_STREAM)
        self.kept: dict = {}  # role -> (layer, its input, its output)
        self.layers = 0

    def warm(self) -> None:
        """Each gate of the mix once at the window's batch."""
        for name in self.gates:
            out = self.prog.batch_gate(name, self.x0, self.fixed)
        int(out[-1, -1])

    def window(self, seconds: float, profiler=None, traced_units: int = 0) -> Window:
        depth = self.spec["queue_depth"]
        pending: collections.deque = collections.deque()
        units, cur = [], self.x0
        kept = self.kept
        if profiler is not None:
            profiler.start()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or len(units) < traced_units:
            k = len(units)
            te = time.perf_counter()
            prev, cur = cur, self.prog.batch_gate(self.gates[k % len(self.gates)], cur, self.fixed)
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
        return Window(units=units, seconds=seconds)

    def check(self, dtype=torch.float64) -> dict:
        """The kept layers, every row, against the reference on the same
        inputs; their decryptions against the plain gate on the decrypted
        inputs."""
        layers = {k: (a, out) for k, a, out in self.kept.values()}
        fixed = R.decrypt(self.fixed, self.keys.lv0)
        words = bits = failed = 0
        for k in sorted(layers):
            a, out = layers[k]
            name = self.gates[k % len(self.gates)]
            ref = R.gate(name, a, self.fixed, self.keys, self.p, self.batch, dtype)
            diff = int((ref != out).sum())
            want = R.PLAIN[name](R.decrypt(a, self.keys.lv0), fixed)
            wrong = int((R.decrypt(out, self.keys.lv0) != want).sum())
            words, bits, failed = words + diff, bits + wrong, failed + bool(diff or wrong)
        return {"compared": {"layers": sorted(layers), "of": self.layers, "rows": len(layers) * self.batch},
                "words_differ": words, "bits_wrong": bits, "failed": failed}
