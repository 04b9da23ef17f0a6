"""Arbitrary boolean-circuit evaluation with batched scheduling.

A netlist (list of gates over numbered wires) is compiled into a level-
ordered, gate-type-grouped execution plan, as rs_tfhe_tpu/models/netlist.py
does. Each plan group then runs as ONE batched bootstrap on the device: the
reference evaluates its 80-gate adder with 80 sequential bootstraps
(examples/add_two_numbers.rs:60-97); here the same netlist runs in ~2*W plan
groups whose gathers and scatters are static index maps.

Two schedulers with identical semantics: `plan_python`, and `plan_native`,
the C++ planner (csrc/circuit_scheduler.cpp through the port's own ctypes
bindings, `rs_tfhe_tpu_torch.native`). `plan` takes the native one where its
library builds and loads, as the JAX package's `plan` does.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import gates as G
from ..key import CloudKey
from ..utils.profiling import span

#: Moves of a compiled plan's index tensors to a device in this process: one
#: a compiled circuit and device (`evaluate` makes them on every call and is
#: not counted).
index_placements = 0

#: op name -> (code, arity). Codes must match csrc/circuit_scheduler.cpp.
OPS = {
    "nand": (0, 2), "and": (1, 2), "or": (2, 2), "nor": (3, 2),
    "xor": (4, 2), "xnor": (5, 2), "and_ny": (6, 2), "and_yn": (7, 2),
    "or_ny": (8, 2), "or_yn": (9, 2), "not": (10, 1), "mux": (11, 3),
    "copy": (12, 1),
}
_CODE_TO_NAME = {v[0]: k for k, v in OPS.items()}


@dataclasses.dataclass(frozen=True)
class Gate:
    op: str
    a: int
    out: int
    b: Optional[int] = None
    c: Optional[int] = None  # mux: a=select, b=then, c=else


@dataclasses.dataclass
class Circuit:
    """n_inputs input wires [0, n_inputs); each gate writes a fresh wire."""

    n_inputs: int
    gates: list[Gate] = dataclasses.field(default_factory=list)

    @property
    def n_wires(self) -> int:
        m = self.n_inputs - 1
        for g in self.gates:
            m = max(m, g.out)
        return m + 1

    def add(self, op: str, a: int, b: int | None = None, c: int | None = None,
            out: int | None = None) -> int:
        """Append a gate; returns its output wire (fresh by default)."""
        if out is None:
            out = self.n_wires
        self.gates.append(Gate(op=op, a=a, b=b, c=c, out=out))
        return out

    def _arrays(self):
        n = len(self.gates)
        op = np.zeros(n, np.int32)
        a = np.zeros(n, np.int32)
        b = np.zeros(n, np.int32)
        c = np.zeros(n, np.int32)
        outw = np.zeros(n, np.int32)
        for i, g in enumerate(self.gates):
            code, arity = OPS[g.op]
            op[i], a[i], outw[i] = code, g.a, g.out
            b[i] = -1 if g.b is None else g.b
            c[i] = -1 if g.c is None else g.c
            if arity >= 2 and g.b is None or arity == 3 and g.c is None:
                raise ValueError(f"gate {i} ({g.op}): missing operand")
        return op, a, b, c, outw


@dataclasses.dataclass(frozen=True)
class Plan:
    """order: gate indices sorted by (level, op); groups: [(start, end, op
    name, level)] — each group is one batched device call."""

    levels: np.ndarray  # [n_gates]
    order: np.ndarray  # [n_gates]
    groups: list[tuple[int, int, str, int]]
    n_levels: int


def plan_python(circuit: Circuit) -> Plan:
    """Pure-Python scheduler, semantics-identical to the native one."""
    op, a, b, c, outw = circuit._arrays()
    n_gates, n_wires, n_inputs = len(op), circuit.n_wires, circuit.n_inputs

    producer = {}
    for g in range(n_gates):
        w = int(outw[g])
        if w < n_inputs or w in producer:
            raise ValueError(f"invalid output wire {w} (gate {g})")
        producer[w] = g

    def inputs_of(g):
        code = int(op[g])
        ins = [int(a[g])]
        if code <= 9 or code == 11:
            ins.append(int(b[g]))
        if code == 11:
            ins.append(int(c[g]))
        return ins

    indeg = np.zeros(n_gates, np.int32)
    consumers: dict[int, list[int]] = {}
    for g in range(n_gates):
        for w in inputs_of(g):
            if w < 0 or w >= n_wires:
                raise ValueError(f"wire {w} out of range (gate {g})")
            if w >= n_inputs:
                if w not in producer:
                    raise ValueError(f"wire {w} never written (gate {g})")
                indeg[g] += 1
                consumers.setdefault(w, []).append(g)

    levels = np.zeros(n_gates, np.int32)
    ready = [g for g in range(n_gates) if indeg[g] == 0]
    done = 0
    while ready:
        nxt = []
        for g in ready:
            done += 1
            for cg in consumers.get(int(outw[g]), []):
                levels[cg] = max(levels[cg], levels[g] + 1)
                indeg[cg] -= 1
                if indeg[cg] == 0:
                    nxt.append(cg)
        ready = nxt
    if done != n_gates:
        raise ValueError("dependency cycle in circuit")

    order = sorted(range(n_gates), key=lambda g: (int(levels[g]), int(op[g])))
    groups = []
    for i, g in enumerate(order):
        key = (int(levels[g]), int(op[g]))
        if not groups or (groups[-1][3], OPS[groups[-1][2]][0]) != key:
            if groups:
                groups[-1] = (groups[-1][0], i, groups[-1][2], groups[-1][3])
            groups.append((i, -1, _CODE_TO_NAME[int(op[g])], int(levels[g])))
    if groups:
        groups[-1] = (groups[-1][0], n_gates, groups[-1][2], groups[-1][3])
    n_levels = int(levels.max()) + 1 if n_gates else 0
    return Plan(levels=levels, order=np.asarray(order, np.int32),
                groups=groups, n_levels=n_levels)


def plan_native(circuit: Circuit) -> Plan:
    """Schedule through the C++ planner (csrc/circuit_scheduler.cpp;
    rs_tfhe_tpu/models/netlist.py:168-204)."""
    from .. import native

    lib = native.load()
    op, a, b, c, outw = circuit._arrays()
    n = len(op)
    levels = np.zeros(n, np.int32)
    order = np.zeros(n, np.int32)
    max_groups = 13 * (n + 1)
    gs, go, gl = (np.zeros(max_groups, np.int32) for _ in range(3))
    i32p = ctypes.POINTER(ctypes.c_int32)

    def p(x):
        return x.ctypes.data_as(i32p)

    ng = lib.circuit_plan(p(op), p(a), p(b), p(c), p(outw), n, circuit.n_wires, circuit.n_inputs,
                          p(levels), p(order), p(gs), p(go), p(gl), max_groups)
    if ng < 0:
        raise ValueError(f"circuit_plan failed: code {ng}")
    groups = [(int(gs[i]), int(gs[i + 1]) if i + 1 < ng else n, _CODE_TO_NAME[int(go[i])], int(gl[i]))
              for i in range(ng)]
    n_levels = int(levels.max()) + 1 if n else 0
    return Plan(levels=levels, order=order, groups=groups, n_levels=n_levels)


def plan(circuit: Circuit) -> Plan:
    """The circuit's execution plan: `plan_native` where the native library
    is available, else `plan_python` (rs_tfhe_tpu/models/netlist.py:206-209)."""
    from .. import native

    return (plan_native if native.available() else plan_python)(circuit)


def _run_group(wires: torch.Tensor, opname: str, ai, bi, ci, outi, ck: CloudKey) -> None:
    """One plan group: gather the operand rows, one batched gate, scatter
    the results into `wires` in place. The indices are int64 tensors on
    `wires`' device; NOT/COPY are bootstrap-free."""
    with span("tfhe.netlist.group"):
        av = wires[ai]
        if opname == "not":
            res = G.not_(av)
        elif opname == "copy":
            res = G.copy(av)
        elif opname == "mux":
            res = G.mux(av, wires[bi], wires[ci], ck)
        else:
            res = G.batch_gate(opname, av, wires[bi], ck)
        wires[outi] = res


def _group_indices(circuit: Circuit, the_plan: Plan, device) -> list:
    """[(op name, a, b, c, out)] per plan group, the wire indices as int64
    tensors on `device`."""
    _op, *operands = circuit._arrays()
    groups = []
    for start, end, opname, _level in the_plan.groups:
        idx = the_plan.order[start:end]
        groups.append((opname, *(torch.as_tensor(x[idx], dtype=torch.int64, device=device) for x in operands)))
    return groups


def _new_wires(circuit: Circuit, inputs: torch.Tensor) -> torch.Tensor:
    wires = torch.zeros((circuit.n_wires, inputs.shape[-1]), dtype=torch.int32, device=inputs.device)
    wires[: circuit.n_inputs] = inputs
    return wires


def evaluate(
    circuit: Circuit, inputs: torch.Tensor, ck: CloudKey,
    the_plan: Plan | None = None,
) -> torch.Tensor:
    """Run the circuit over encrypted inputs.

    inputs: int32 [n_inputs, n0+1] (one LWE ciphertext per input wire).
    Returns int32 [n_wires, n0+1], every wire's ciphertext (slice the
    outputs you need). Each plan group is one batched gate over statically
    gathered rows. The plan and its index tensors are made on every call;
    `compile_circuit` makes them once.
    """
    with span("tfhe.netlist.run"):
        pl_ = the_plan if the_plan is not None else plan(circuit)
        wires = _new_wires(circuit, inputs)
        for group in _group_indices(circuit, pl_, inputs.device):
            _run_group(wires, *group, ck)
        return wires


def compile_circuit(circuit: Circuit, the_plan: Plan | None = None):
    """Fix the circuit's execution plan once; returns `run(inputs, ck)`.

    The counterpart of the JAX package's whole-plan jit
    (rs_tfhe_tpu/models/netlist.py:243-291): the plan is made here, its
    gather and scatter indices are moved to the key's device once (on the
    first run there) as int64 tensors, and `run` then issues every group's
    kernels back to back on the current stream, with no host
    synchronisation and no host-to-device copy in between.
    """
    pl_ = the_plan if the_plan is not None else plan(circuit)
    per_device: dict = {}

    def run(inputs: torch.Tensor, ck: CloudKey) -> torch.Tensor:
        global index_placements
        device = ck.testvec.device
        if inputs.device != device:
            raise ValueError(f"inputs on {inputs.device}, key on {device}")
        with span("tfhe.netlist.run"):
            groups = per_device.get(device)
            if groups is None:
                index_placements += 1
                groups = per_device[device] = _group_indices(circuit, pl_, device)
            wires = _new_wires(circuit, inputs)
            for group in groups:
                _run_group(wires, *group, ck)
            return wires

    return run


def ripple_carry_adder(width: int) -> tuple[Circuit, list[int], list[int], list[int]]:
    """The reference's adder netlist (examples/add_two_numbers.rs:60-97):
    full adders from xor/and/or, carry-chained. Returns
    (circuit, a_wires, b_wires, sum_wires); sequential depth ~3*W, but the
    scheduler still batches the independent first-level xor/and pairs."""
    ckt = Circuit(n_inputs=2 * width)
    a_w = list(range(width))
    b_w = list(range(width, 2 * width))
    sums = []
    carry = None
    for i in range(width):
        axb = ckt.add("xor", a_w[i], b_w[i])
        aab = ckt.add("and", a_w[i], b_w[i])
        if carry is None:
            sums.append(ckt.add("copy", axb))
            carry = aab
        else:
            sums.append(ckt.add("xor", axb, carry))
            t = ckt.add("and", axb, carry)
            carry = ckt.add("or", aab, t)
    return ckt, a_w, b_w, sums
