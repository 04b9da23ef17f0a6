"""Full-stack validation of the PyTorch port on the card at SECURITY_128_BIT:
the counterpart of scripts/tpu_validation.py, stage by stage, at its sizes,
seeds and check texts.

Runs every major capability end to end at production parameters and
asserts 100% correctness: all 10 gate truth tables on B = 64, a multi-bit
NAND at B = 2 and its output noise against the model, MUX and NOT,
programmable bootstrapping (square mod 8), a radix add, a 16-bit
Kogge-Stone add and the same add through the netlist scheduler, asymmetric
proxy re-encryption, a reloaded cloud key, a UINT4 PBS with 3-limb digits;
then (not under --small) RADIX base-8 and NIBBLE base-16 adds over 256
trials, the NIBBLE noise margin and the NIBBLE 8x8 ciphertext multiply.
The first failed check raises SystemExit naming it (a non-zero exit).

    python scripts/torch/tpu_validation.py                  # the full run, on the card
    python scripts/torch/tpu_validation.py --small          # the N <= 1024 stages, then the golden check of those
    python scripts/torch/tpu_validation.py --write-golden   # (re)capture tests/vectors/golden_production_torch.npz
    python scripts/torch/tpu_validation.py --small --cpu    # on the CPU: minutes a stage at the production sets

Where the port differs from the JAX script:

- The Mosaic tripwire (scripts/tpu_validation.py:106-125) asserts that the
  TPU compiler still rejects s16 dots. Its counterpart launches P1's s16
  unit (csrc/probes.cu, through ops/cuda_probes.probe_dot) at the probe's
  shape, int16 [128,1024] x [1024,256], on JAX's all-ones operands and on
  full-range ones, and requires it to equal `dot_plain`: the lever Mosaic
  withheld is available on this card. It is skipped under --cpu, as the JAX
  check is off a TPU.
- The multi-bit noise stage (TPU-only in JAX) runs on the card through
  scripts/torch/measure_mb_noise.measure_set (K = 128 NANDs at B = 2), with
  JAX's bound 0.5 <= measured/model <= 1.15 and no gate error; under --cpu
  it is skipped, as JAX skips it off a TPU.
- JAX's jax.clear_caches() after each check, a workaround for XLA:CPU, has
  no counterpart.
- Golden vectors: the port's own file, tests/vectors/golden_production_torch.npz,
  under JAX's array names plus nand_mb_128 (int32 ciphertexts). JAX's
  golden_production.npz holds outputs under keys drawn by jax.random, which
  the port cannot draw, so the port never reads it. The secret keys, the
  cloud keys' noise, the plaintexts and the ciphertexts of every golden
  stage come from CPU torch.Generators seeded where JAX seeds
  jax.random.key, and keys and ciphertexts move to the card after, as a
  client's would; the masks come from `gen_seed` through threefry, the same
  words on either device. So one seed gives the same bits with and without
  --cpu. The host draws take about a minute of the full run (NVIDIA H100
  80GB HBM3 machine, 8 cores: strict 6.4 s, UINT4 about 11 s, NIBBLE
  36.4 s). The stages that record no golden array draw their keys where
  the run is (the RADIX set's keys, the proxy re-encryption key: a CPU draw
  of those would add host time and pin nothing).
- Parameter sets live in one table, SETS (main: SECURITY_128_BIT; uint4,
  radix, nibble), so that a test can run the stages at tiny sets.

`Validation(device).run()` runs it in a process (chip_smoke.py phase 20):
it keeps the check names passed, the recorded arrays, each stage's wall
seconds, and for the gate, MUX and PBS stages a replay (name, call, output)
that recomputes the output from the same inputs, which the card repeats
under step_impl="xla".
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from soak import ROOT, card, generator, params_name  # noqa: E402  (scripts/torch/soak.py)

import rs_tfhe_tpu_torch as tfhe  # noqa: E402
from rs_tfhe_tpu_torch import gates  # noqa: E402
from rs_tfhe_tpu_torch import proxy_reenc as pre  # noqa: E402
from rs_tfhe_tpu_torch.bit_utils import decrypt_uint, encrypt_uint  # noqa: E402
from rs_tfhe_tpu_torch.bootstrap import LutBootstrap  # noqa: E402
from rs_tfhe_tpu_torch.key import CloudKey, SecretKey  # noqa: E402
from rs_tfhe_tpu_torch.models import arithmetic, circuits, netlist  # noqa: E402
from rs_tfhe_tpu_torch.tlwe import lwe_decrypt_bool, lwe_decrypt_message, lwe_encrypt_bool, lwe_encrypt_message  # noqa: E402
from rs_tfhe_tpu_torch.torus import f64_to_torus, resolve_device  # noqa: E402
from rs_tfhe_tpu_torch.utils.noise import lut_margin, measure_phase_noise  # noqa: E402
from rs_tfhe_tpu_torch.utils.serialization import load_cloud_key, save_cloud_key  # noqa: E402

GOLDEN = os.path.join(ROOT, "tests", "vectors", "golden_production_torch.npz")
#: The parameter sets by role (scripts/tpu_validation.py: p, p4, pr, pn)
SETS = {
    "main": tfhe.SECURITY_128_BIT,
    "uint4": tfhe.SECURITY_UINT4,
    "radix": tfhe.SECURITY_128_BIT_RADIX,
    "nibble": tfhe.SECURITY_128_BIT_NIBBLE,
}


def host(seed: int) -> torch.Generator:
    """A CPU generator seeded where the JAX script seeds jax.random.key."""
    return torch.Generator().manual_seed(seed)


def on(device, sk: SecretKey) -> SecretKey:
    """A copy of sk on `device` (Module.to would move sk itself)."""
    return SecretKey(sk.lv0.to(device), sk.lv1.to(device), sk.params)


def decrypt_bits(ct: torch.Tensor, s: torch.Tensor) -> np.ndarray:
    return lwe_decrypt_bool(ct, s).cpu().numpy()


class Validation:
    """One run of the validation on `device` (see the module docstring)."""

    def __init__(self, device, small: bool = False, write_golden: bool = False, golden: str = GOLDEN):
        self.device = torch.device(device)
        self.small, self.write_golden, self.golden = small, write_golden, golden
        self.sets = dict(SETS)
        self.passed: list[str] = []
        self.artifacts: dict[str, np.ndarray] = {}
        self.stage_s: dict[str, float] = {}
        self.replays: list = []

    # -- the JAX script's helpers --------------------------------------------

    def record(self, name: str, ct: torch.Tensor) -> None:
        self.artifacts[name] = ct.cpu().numpy()

    def replay(self, name: str, fn, out: torch.Tensor) -> None:
        """Keep a call that recomputes `out` from the stage's inputs."""
        self.replays.append((name, fn, out))

    def check(self, name: str, ok: bool) -> None:
        status = "PASS" if ok else "FAIL"
        print(f"  [{status}] {name}", flush=True)
        if not ok:
            raise SystemExit(f"validation failed at: {name}")
        self.passed.append(name)

    def golden_finalize(self) -> None:
        if self.write_golden:
            np.savez_compressed(self.golden, **self.artifacts)
            print(f"wrote {self.golden}: {sorted(self.artifacts)}")
            return
        if not os.path.exists(self.golden):
            print(f"note: {self.golden} absent — run with --write-golden to pin")
            return
        stored = np.load(self.golden)
        # --small runs only the N <= 1024 stages: compare just the stages that
        # ran; the full run still demands every stored vector
        names = [n for n in stored.files if n in self.artifacts] if self.small else stored.files
        for name in names:
            self.check(f"golden[{name}]",
                       name in self.artifacts and np.array_equal(stored[name], self.artifacts[name]))

    def check_mosaic_tripwire(self) -> None:
        """The counterpart of the JAX script's tripwire: P1's s16 unit at the
        probe's shape on this card, equal to the plain version."""
        if self.device.type != "cuda":
            return
        from rs_tfhe_tpu_torch.ops import cuda_probes

        rng = np.random.default_rng(0)
        info = np.iinfo(np.int16)
        pairs = [(np.ones((128, 1024), np.int16), np.ones((1024, 256), np.int16)),
                 (rng.integers(info.min, info.max + 1, (128, 1024), dtype=np.int16),
                  rng.integers(info.min, info.max + 1, (1024, 256), dtype=np.int16))]
        before = cuda_probes.launches["probe_dot"]
        ok = True
        for a, b in pairs:
            a, b = torch.from_numpy(a).to(self.device), torch.from_numpy(b).to(self.device)
            ok &= torch.equal(cuda_probes.probe_dot(a, b), cuda_probes.dot_plain(a, b))
        self.check(
            "P1's s16 dot [128,1024]x[1024,256] runs on this card's tensor cores and equals dot_plain "
            "(the s16 lever Mosaic withheld is available here; see scripts/probe_hopper.py)",
            ok and cuda_probes.launches["probe_dot"] == before + len(pairs),
        )

    # -- keys and timing -----------------------------------------------------

    def host_keys(self, p, sk_seed: int, ck_seed: int, multibit: bool = False):
        """(secret key on the host, on the device, cloud key on the device):
        every word drawn on the host, the cloud key moved after."""
        sk = SecretKey.generate(p, host(sk_seed))
        return sk, on(self.device, sk), CloudKey.generate(sk, host(ck_seed), multibit=multibit).to(self.device)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        """Wall seconds of the block, to the card's synchronise."""
        self.sync()
        t0 = time.perf_counter()
        yield
        self.sync()
        self.stage_s[name] = time.perf_counter() - t0

    # -- the stages (scripts/tpu_validation.py:128-350) ------------------------

    def run(self) -> int:
        p = self.sets["main"]
        dev = self.device
        print(f"device: {card(dev)[0]}  params: {p.description}")
        self.check_mosaic_tripwire()
        t0 = time.perf_counter()
        with self.stage("keygen"):
            # JAX draws the standard and the multi-bit key from key(7) alike; the port's keygen
            # draws the noise KSK, BSK, then the multi-bit key, so both come from one draw
            sk_host, sk, ck_mb = self.host_keys(p, 42, 7, multibit=True)
            ck = CloudKey(ck_mb.testvec, ck_mb.bsk, ck_mb.ksk_limbs, p, None, ck_mb.gen_seed)
        alpha = p.tlwe_lv0.alpha
        print(f"keygen: {time.perf_counter() - t0:.1f}s")

        # -- all gate truth tables over the 4 input combinations, batch of 64 --
        rng = np.random.default_rng(0)
        a_bits = rng.integers(0, 2, 64).astype(bool)
        b_bits = rng.integers(0, 2, 64).astype(bool)
        g3 = host(3)  # JAX's ka, kb, kc = split(key(3), 3): a, b, then c below
        a = lwe_encrypt_bool(g3, sk_host.lv0, a_bits, alpha).to(dev)
        b = lwe_encrypt_bool(g3, sk_host.lv0, b_bits, alpha).to(dev)
        truth = {
            "nand": lambda x, y: ~(x & y), "and": lambda x, y: x & y,
            "or": lambda x, y: x | y, "nor": lambda x, y: ~(x | y),
            "xor": lambda x, y: x ^ y, "xnor": lambda x, y: ~(x ^ y),
            "and_ny": lambda x, y: ~x & y, "and_yn": lambda x, y: x & ~y,
            "or_ny": lambda x, y: ~x | y, "or_yn": lambda x, y: x | ~y,
        }
        with self.stage("gates"):
            for name, fn in truth.items():
                out = gates.batch_gate(name, a, b, ck)
                if name == "nand":
                    self.record("nand_128", out)
                self.replay(f"gate {name}", lambda name=name: gates.batch_gate(name, a, b, ck), out)
                dec = decrypt_bits(out, sk.lv0)
                self.check(f"gate {name}", (dec == fn(a_bits, b_bits)).all())

        # -- multi-bit latency path: B <= 2 auto-routes through the multi-bit
        # rotation when the key carries multi-bit material -------------------
        with self.stage("multibit"):
            out_mb = gates.batch_gate("nand", a[:2], b[:2], ck_mb)
            self.record("nand_mb_128", out_mb)
            dec = decrypt_bits(out_mb, sk.lv0)
            self.check("gate nand (multibit key, B=2)", (dec == ~(a_bits[:2] & b_bits[:2])).all())

        # multi-bit bootstrap output noise against the estimate(mb_group=2)
        # model; on the card only (K = 128 bootstraps at B = 2)
        if dev.type == "cuda":
            import measure_mb_noise

            with self.stage("mb_noise"):
                row, _ = measure_mb_noise.measure_set(params_name(p), 128, True, sk, ck_mb)
            self.check("mb phase noise within model (0.5 <= measured/model <= 1.15)",
                       0.5 <= row["ratio"] <= 1.15 and row["gate_errors"] == 0)
        del ck_mb

        c_bits = rng.integers(0, 2, 64).astype(bool)
        c = lwe_encrypt_bool(g3, sk_host.lv0, c_bits, alpha).to(dev)
        with self.stage("mux_not"):
            out = gates.mux(a, b, c, ck)
            self.record("mux_128", out)
            self.replay("mux", lambda: gates.mux(a, b, c, ck), out)
            dec = decrypt_bits(out, sk.lv0)
            self.check("mux", (dec == np.where(a_bits, b_bits, c_bits)).all())
            dec = decrypt_bits(gates.not_(a), sk.lv0)
            self.check("not", (dec == ~a_bits).all())

        # -- programmable bootstrap: square mod 8 over all messages -----------
        m = 8
        lut = LutBootstrap()

        def square(x):
            return (x * x) % m

        with self.stage("lut"):
            ct = lwe_encrypt_message(host(5), sk_host.lv0, np.arange(m), m, alpha).to(dev)
            sq = lut.bootstrap_func(ct, square, m, ck)
            self.record("pbs_square_128", sq)
            self.replay("lut square mod 8", lambda: lut.bootstrap_func(ct, square, m, ck), sq)
            self.check("lut square mod 8",
                       list(lwe_decrypt_message(sq, sk.lv0, m)) == [(x * x) % m for x in range(m)])

        # -- radix arithmetic: 9-bit add in 5 PBS -----------------------------
        with self.stage("radix_add"):
            ra = arithmetic.encrypt_radix(host(6), sk_host.lv0, 137, 3, p, 3).to(dev)
            rb = arithmetic.encrypt_radix(host(7), sk_host.lv0, 205, 3, p, 3).to(dev)
            rsum = arithmetic.add_radix(ra, rb, ck, 3)
            self.record("radix_add_128", rsum)
            self.check("radix 9-bit add (5 PBS)",
                       int(arithmetic.decrypt_radix(rsum, sk.lv0, 3)) == (137 + 205) % 512)

        # -- 16-bit Kogge-Stone addition --------------------------------------
        x, y = 40590, 27063
        ea = encrypt_uint(host(8), sk_host.lv0, x, 16, alpha).to(dev)
        eb = encrypt_uint(host(9), sk_host.lv0, y, 16, alpha).to(dev)
        with self.stage("kogge_stone"):
            es = circuits.add_kogge_stone(ea, eb, ck)
            self.record("kogge_stone_128", es)
            self.check("kogge-stone 16-bit add", decrypt_uint(es, sk.lv0) == (x + y) % 65536)

        # -- the netlist scheduler at production params: the level-grouped
        # plan drives the same 16-bit add through batched per-group calls ----
        with self.stage("netlist"):
            ckt, _, _, sums = netlist.ripple_carry_adder(16)
            the_plan = netlist.plan(ckt)
            wires = netlist.evaluate(ckt, torch.cat([ea, eb], dim=0), ck, the_plan)
            got = decrypt_uint(wires[torch.as_tensor(sums, device=dev)], sk.lv0)
            self.check("netlist-scheduled 16-bit ripple-carry add "
                       f"({len(the_plan.groups)} plan groups, {len(ckt.gates)} gates)",
                       int(got) == (x + y) % 65536)

        # -- proxy re-encryption (asymmetric) ---------------------------------
        with self.stage("proxy"):
            bob = SecretKey.generate(p, host(10))
            bob_pk = pre.PublicKeyLv0.generate(host(11), bob.lv0, p).to(dev)
            rk = pre.new_asymmetric(generator(dev, 12), sk.lv0, bob_pk, p)
            re_ct = pre.reencrypt(a, rk)
            dec = decrypt_bits(re_ct, bob.lv0.to(dev))
            self.check("asymmetric proxy re-encryption", (dec == a_bits).all())

        # -- key serialization round trip --------------------------------------
        with self.stage("reload"):
            with tempfile.TemporaryDirectory() as d:
                path = os.path.join(d, "ck.npz")
                save_cloud_key(path, ck)
                ck2 = load_cloud_key(path, dev)
            out = gates.nand(a, b, ck2)
            dec = decrypt_bits(out, sk.lv0)
            self.check("reloaded cloud key", (dec == ~(a_bits & b_bits)).all())

        # -- Uint4 parameter set: multi-limb digit path at full scale ---------
        p4 = self.sets["uint4"]
        m16 = 16

        def three_x_plus_1(x):
            return (x * 3 + 1) % m16

        with self.stage("uint4"):
            sk4_host, sk4, ck4 = self.host_keys(p4, 20, 21)
            ct4 = lwe_encrypt_message(host(22), sk4_host.lv0, np.arange(m16), m16, p4.tlwe_lv0.alpha).to(dev)
            out4 = lut.bootstrap_func(ct4, three_x_plus_1, m16, ck4)
            self.record("pbs_uint4", out4)
            self.replay("UINT4 PBS, 3-limb digits (3x+1 mod 16)",
                        lambda: lut.bootstrap_func(ct4, three_x_plus_1, m16, ck4), out4)
            self.check("UINT4 PBS, 3-limb digits (3x+1 mod 16)",
                       list(lwe_decrypt_message(out4, sk4.lv0, m16))
                       == [(x * 3 + 1) % m16 for x in range(m16)])

        if self.small:
            # the N <= 1024 subset: the golden vectors of the stages that ran
            with self.stage("golden"):
                self.golden_finalize()
            print(f"\nALL {len(self.passed)} CHECKS PASSED (--small subset, "
                  f"{time.perf_counter() - t0:.0f}s total)")
            return len(self.passed)

        # -- SECURITY_128_BIT_RADIX: fast radix arithmetic ----------------------
        # base 8 at a 7.3-sigma certified margin (lut_margin with the 1/(4m)
        # decision distance); the certified base-16 set is NIBBLE, below
        pr = self.sets["radix"]
        trials = 256
        with self.stage("radix_set"):
            skr = SecretKey.generate(pr, generator(dev, 30))
            t1 = time.perf_counter()
            ckr = CloudKey.generate(skr, generator(dev, 31))
            self.sync()
            print(f"RADIX keygen: {time.perf_counter() - t1:.1f}s")
            xs = rng.integers(0, 512, trials)
            ys = rng.integers(0, 512, trials)
            ra = arithmetic.encrypt_radix(generator(dev, 32), skr.lv0, xs, 3, pr, base_bits=3)
            rb = arithmetic.encrypt_radix(generator(dev, 33), skr.lv0, ys, 3, pr, base_bits=3)
            rsum = arithmetic.add_radix(ra, rb, ckr, base_bits=3)  # 5 PBS per add
            dec = arithmetic.decrypt_radix(rsum, skr.lv0, base_bits=3)
            self.check(
                "RADIX base-8 9-bit add, 7.3-sigma certified (256 trials, 1280 PBS)",
                (dec == (xs + ys) % 512).all(),
            )
            del ckr

        # -- SECURITY_128_BIT_NIBBLE: the certified base-16 headline ----------
        # the reference's "8-bit add in 3 PBS" at ~6.5 sigma (p ~ 8e-11 per
        # PBS, model): any failure is a real bug
        pn = self.sets["nibble"]
        with self.stage("nibble_add"):
            skn_host = SecretKey.generate(pn, host(36))
            skn = on(dev, skn_host)
            t1 = time.perf_counter()
            ckn = CloudKey.generate(skn_host, host(37)).to(dev)
            print(f"NIBBLE keygen: {time.perf_counter() - t1:.1f}s")
            xs = rng.integers(0, 256, trials)
            ys = rng.integers(0, 256, trials)
            na = arithmetic.encrypt_radix(host(38), skn_host.lv0, xs, 2, pn, base_bits=4).to(dev)
            nb = arithmetic.encrypt_radix(host(39), skn_host.lv0, ys, 2, pn, base_bits=4).to(dev)
            nsum = arithmetic.add_radix(na, nb, ckn, base_bits=4)  # 3 PBS per add
            self.record("nibble_add", nsum)
            dec = arithmetic.decrypt_radix(nsum, skn.lv0, base_bits=4)
            self.check(
                "NIBBLE 8-bit add in 3 PBS, 6.5-sigma certified (256 trials, 768 PBS)",
                (dec == (xs + ys) % 256).all(),
            )

        # measured post-PBS noise must agree with the engineered margin
        with self.stage("nibble_margin"):
            enc_scale = 1.0 / (2.0 * 32)
            digs = np.stack([(dec >> 0) & 15, (dec >> 4) & 15], axis=-1)  # [trials, 2]
            expected_mu = np.uint32([int(f64_to_torus(int(v) * enc_scale)) for v in digs.reshape(-1)])
            noise = measure_phase_noise(nsum.reshape(-1, pn.n0 + 1), skn.lv0, expected_mu)
            sig_design, _ = lut_margin(pn, 32)
            sigma_meas = float(noise.std())
            # next-PBS input: 3 summands of this output noise + the modswitch floor
            var_ms = (pn.n0 + 1) * (1.0 / (2.0 * pn.n1)) ** 2 / 12.0
            sig_in = (1.0 / 128.0) / float(np.sqrt(3 * sigma_meas**2 + var_ms))
            print(f"  NIBBLE measured PBS-output noise std {sigma_meas:.2e} "
                  f"=> {sig_in:.1f} sigma of base-16 margin (model {sig_design:.1f})")
            self.check("NIBBLE base-16 margin >= 6 sigma (measured-output model)", sig_in >= 6.0)

        # ciphertext x ciphertext multiplication (beyond the reference) at the
        # certified set: all three stages >= 6.5 sigma (lut_margin(pn, 32, 8))
        with self.stage("nibble_mul"):
            xs8 = rng.integers(0, 256, 32)
            ys8 = rng.integers(0, 256, 32)
            ma = arithmetic.encrypt_radix(host(40), skn_host.lv0, xs8, 4, pn, base_bits=2).to(dev)
            mb = arithmetic.encrypt_radix(host(41), skn_host.lv0, ys8, 4, pn, base_bits=2).to(dev)
            mprod = arithmetic.mul_radix(ma, mb, ckn, base_bits=2)
            self.record("mul_radix_nibble", mprod)
            mdec = arithmetic.decrypt_radix(mprod, skn.lv0, base_bits=2)
            self.check(
                "NIBBLE 8-bit x 8-bit ciphertext multiply (32 trials, 56 PBS each)",
                (mdec == xs8 * ys8).all(),
            )

        with self.stage("golden"):
            self.golden_finalize()

        print(f"\nALL {len(self.passed)} CHECKS PASSED "
              f"({time.perf_counter() - t0:.0f}s total)")
        return len(self.passed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--small", action="store_true", help="the N <= 1024 stages, then the golden check of those")
    ap.add_argument("--write-golden", action="store_true", help=f"(re)capture {os.path.relpath(GOLDEN, ROOT)}")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    name, limit = card(device)
    print(f"card: {name}, power limit {limit}")
    v = Validation(device, small=args.small, write_golden=args.write_golden, golden=GOLDEN)
    v.run()
    print("stage seconds: " + ", ".join(f"{k} {s:.2f}" for k, s in v.stage_s.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
