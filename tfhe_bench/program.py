"""The system under test, as the benchmark drives it: the only module of
the benchmark that imports the program (`rs_tfhe_tpu_torch`).

It hands the benchmark's key arrays to the program on the device (the
program derives its own key-switching limb table from the benchmark's rows),
checks that the program's parameter set holds the configuration file's
numbers, exposes the two entries the timed window drives (`batch_gate` and
the `run` of a compiled circuit), and reads the rotation kernels' launch
counters.
"""

from __future__ import annotations

import torch

from . import reference as R

#: the program's route rule, the one the configurations state (a multi-bit
#: key's batches of at most `mb_route_batch_cap` take the multi-bit
#: rotation): set here so that `RS_TFHE_STEP_IMPL` in the environment cannot
#: change the ciphertexts the reference is held to
ROUTE = "auto"

#: configuration key -> the program's parameter field
_FIELDS = {
    "n0": lambda p: p.tlwe_lv0.n,
    "n1": lambda p: p.trlwe_lv1.n,
    "alpha_lv0": lambda p: p.tlwe_lv0.alpha,
    "alpha_lv1": lambda p: p.tlwe_lv1.alpha,
    "nbit": lambda p: p.trgsw_lv1.nbit,
    "bgbit": lambda p: p.trgsw_lv1.bgbit,
    "l": lambda p: p.trgsw_lv1.l,
    "basebit": lambda p: p.trgsw_lv1.basebit,
    "iks_t": lambda p: p.trgsw_lv1.iks_t,
    "bsk_round_bits": lambda p: p.bsk_round_bits,
}


class Program:
    """The port, set up for one configuration on one device."""

    def __init__(self, cfg: dict, keys: R.Keys, device):
        import rs_tfhe_tpu_torch.params as tp
        from rs_tfhe_tpu_torch import config as tconfig
        from rs_tfhe_tpu_torch import key as tkey

        params = getattr(tp, cfg["params"])
        wrong = {k: (f(params), cfg[k]) for k, f in _FIELDS.items() if f(params) != cfg[k]}
        if wrong:
            raise ValueError(f"{cfg['params']} differs from {cfg['name']}.json (program, file): {wrong}")
        tconfig.config.step_impl = ROUTE
        self.params = params
        # copies: the reference reads the benchmark's arrays, never the
        # program's buffers
        own = lambda t: None if t is None else t.to(device, copy=True)  # noqa: E731
        self.ck = tkey.CloudKey(own(keys.testvec), own(keys.bsk),
                                tkey.ksk_limbs_from_rows(own(keys.ksk_rows), params), params, own(keys.bsk_mb))

    def batch_gate(self, name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        from rs_tfhe_tpu_torch import gates

        return gates.batch_gate(name, a, b, self.ck)

    def compile_circuit(self, n_inputs: int, gate_list: list):
        """`run(inputs)` of the netlist [op, out, *ins] through
        `models.netlist.compile_circuit`."""
        from rs_tfhe_tpu_torch.models import netlist

        ckt = netlist.Circuit(n_inputs=n_inputs)
        for op, out, *ins in gate_list:
            ckt.add(op, *ins, out=out)
        run = netlist.compile_circuit(ckt)
        ck = self.ck
        return lambda inputs: run(inputs, ck)

    @staticmethod
    def launches() -> dict:
        """The rotation kernels' launch counters, now."""
        from rs_tfhe_tpu_torch.ops import cuda_blind_rotate, cuda_blind_rotate_mb

        return {
            "K1": cuda_blind_rotate.launches,
            "K4": cuda_blind_rotate_mb.launches,
            "K1_instances": {"/".join(map(str, k)): v for k, v in cuda_blind_rotate.launched_tiles.items()},
            "K4_instances": {"/".join(map(str, k)): v for k, v in cuda_blind_rotate_mb.launched_tiles.items()},
        }
