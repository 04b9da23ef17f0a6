"""Arbitrary-netlist evaluation with the native circuit scheduler, with the
PyTorch port (the counterpart of examples/circuit_scheduler.py).

The reference evaluates its 16-bit adder one bootstrap at a time
(examples/add_two_numbers.rs:60-97). Here the same ripple-carry netlist is
planned by the C++ scheduler (csrc/circuit_scheduler.cpp) into level-
ordered, gate-type-grouped batches — each group is ONE batched bootstrap —
and executed over encrypted inputs.

    python examples/torch/circuit_scheduler.py --width 8 --x 173 --y 90
"""

import torch
from _torch_common import generator, make_keys, parse_args, timed

from rs_tfhe_tpu_torch import native
from rs_tfhe_tpu_torch.bit_utils import encrypt_uint
from rs_tfhe_tpu_torch.models import netlist as NL
from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_bool


def main(argv=None):
    args = parse_args(__doc__, argv, width=8, x=173, y=90)
    w = args.width
    sk, ck = make_keys(args.param_set, args.device)

    ckt, a_w, b_w, sum_w = NL.ripple_carry_adder(w)
    plan = NL.plan(ckt)
    backend = "C++ scheduler" if native.available() else "python fallback"
    print(f"{len(ckt.gates)} gates -> {plan.n_levels} levels, "
          f"{len(plan.groups)} batched calls ({backend})")

    mod = 1 << w
    enc_a = encrypt_uint(generator(args.device, 1), sk.lv0, args.x % mod, w,
                         args.param_set.tlwe_lv0.alpha)
    enc_b = encrypt_uint(generator(args.device, 2), sk.lv0, args.y % mod, w,
                         args.param_set.tlwe_lv0.alpha)
    inputs = torch.cat([enc_a, enc_b], dim=0)

    wires = timed("scheduled evaluation", NL.evaluate, ckt, inputs, ck, plan)
    bits = lwe_decrypt_bool(wires[sum_w], sk.lv0).cpu().numpy()
    got = sum(int(b) << i for i, b in enumerate(bits))
    print(f"{args.x % mod} + {args.y % mod} = {got} "
          f"(expect {(args.x + args.y) % mod})")
    assert got == (args.x + args.y) % mod

    # the plan fixed once: every group's gather and scatter indices on the
    # device, the groups issued back to back with no host synchronisation
    run = NL.compile_circuit(ckt, plan)
    _ = run(inputs, ck)  # warm-up
    wires = timed("whole-plan run (compile_circuit)", run, inputs, ck)
    bits = lwe_decrypt_bool(wires[sum_w], sk.lv0).cpu().numpy()
    got = sum(int(b) << i for i, b in enumerate(bits))
    assert got == (args.x + args.y) % mod
    print("OK")


if __name__ == "__main__":
    main()
