"""Traffic kind `circuit`: one client sending requests back to back.

A request is one evaluation of the netlist `gates` ([op, out wire, *in
wires]; inputs are wires [0, n_inputs)) on `n_inputs` encrypted bits, drawn
from the seed into a host-side pool of `pool` requests in set-up and taken
in turn. It copies its inputs to the device, runs the compiled circuit and
reads the `outputs` wires back; its latency runs from the copy until the
outputs are on the host. A unit of work is a request. The check compares
every request the window served.
"""

from __future__ import annotations

import time

import torch

from .. import keygen
from .. import reference as R
from ..traffic import TRAFFIC_STREAM, Unit, Window, sync


class Loop:
    def __init__(self, spec: dict, prog, keys: R.Keys, p: R.Params, seed: int, device):
        self.spec, self.prog, self.keys, self.p, self.device = spec, prog, keys, p, device
        self.n_inputs, self.gates, self.outputs = spec["n_inputs"], spec["gates"], spec["outputs"]
        g = keygen.generator(seed ^ TRAFFIC_STREAM, device)
        self.bits = torch.randint(0, 2, (spec["pool"], self.n_inputs), generator=g, device=device).bool()
        pool = keygen.encrypt_bits(g, keys.lv0, self.bits, p.alpha_lv0).cpu()
        self.pool = pool.pin_memory() if torch.device(device).type == "cuda" else pool
        self.run = prog.compile_circuit(self.n_inputs, self.gates)
        self.calls = [len(idx) for _lv, op, idx in R.schedule(self.n_inputs, self.gates)
                      if op not in R.UNARY]
        self.served: list = []  # (pool index, outputs on the host)

    def request(self, i: int) -> Unit:
        t0 = time.perf_counter()
        x = self.pool[i % len(self.pool)].to(self.device)
        te = time.perf_counter()
        wires = self.run(x)
        t1 = time.perf_counter()
        out = wires[self.outputs].cpu()
        done = time.perf_counter()
        self.served.append((i % len(self.pool), out))
        return Unit(groups=self.calls, latency_s=done - t0, enqueue_s=t1 - te)

    def warm(self) -> None:
        """Two requests: the first places the plan's indices on the device."""
        for i in range(2):
            self.request(i)
        self.served.clear()

    def window(self, seconds: float, profiler=None, traced_units: int = 0) -> Window:
        units = []
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
        return Window(units=units, seconds=time.perf_counter() - t0)

    def check(self, dtype=torch.float64) -> dict:
        """Every request served in the window against the reference on its
        inputs; its outputs' decryptions against the plain netlist."""
        used = sorted({i for i, _ in self.served})
        pos = {i: k for k, i in enumerate(used)}
        idx = torch.tensor(used, device=self.device)
        ref = R.evaluate(self.pool[used].to(self.device), self.n_inputs, self.gates, self.keys, self.p, dtype)
        ref = ref[:, self.outputs].cpu()
        want = R.evaluate_plain(self.bits[idx], self.n_inputs, self.gates)[:, self.outputs].cpu()
        lv0 = self.keys.lv0.cpu()
        words = bits = failed = 0
        for i, out in self.served:
            diff = int((out != ref[pos[i]]).sum())
            wrong = int((R.decrypt(out, lv0) != want[pos[i]]).sum())
            words, bits, failed = words + diff, bits + wrong, failed + bool(diff or wrong)
        return {"compared": {"requests": len(self.served), "distinct": len(used)},
                "words_differ": words, "bits_wrong": bits, "failed": failed}
