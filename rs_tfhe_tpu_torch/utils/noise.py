"""Noise-budget estimation and decryption-failure prediction.

A port of rs_tfhe_tpu/utils/noise.py on the port's parameter sets: the same
TFHE variance calculus, float for float (the formulas and their order of
operations are kept as they are, so `estimate`, `lut_margin` and
`mb_lut_route_ok` return the same floats as the JAX package's):

- fresh-ciphertext, gate-linear-form, blind-rotation and key-switching
  noise variances (fractions of the torus, alpha^2 units), for the standard
  and the multi-bit (mb_group=2) rotation;
- per-gate failure probability under the Gaussian model,
  p_fail = erfc(margin / (sqrt(2) * sigma)), margin 1/16 for the +/-1/8
  boolean encoding;
- the programmable-bootstrap margin and the noise policy of the multi-bit
  LUT route;
- an empirical phase-noise measurement helper for validating the model.

Host-side math (Python floats and numpy); nothing here touches a device
except `measure_phase_noise`, which reads the phases back.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..params import TORUS_BITS, TfheParams


@dataclasses.dataclass(frozen=True)
class NoiseEstimate:
    """Standard deviations are fractions of the torus (1.0 = full circle)."""

    fresh_lv0_std: float
    bootstrap_out_std: float  # after blind rotate + extract + key switch
    gate_input_std: float  # linear form of two bootstrapped ciphertexts
    gate_fail_prob: float  # per-ciphertext probability of a wrong gate output
    mux_fail_prob: float = 0.0  # per-ciphertext MUX failure (2-PBS composition)
    # Split of bootstrap_out_std, for multi-value PBS budgeting
    # (rs_tfhe_tpu/lut/multi_value.py scales ONLY the accumulator term):
    blind_rotate_std: float = 0.0  # accumulator noise before key switch
    keyswitch_std: float = 0.0  # lv1 -> lv0 key-switch noise

    def bits_of_margin(self) -> float:
        """How many sigmas fit in the gate decision margin."""
        return (1.0 / 16.0) / self.gate_input_std if self.gate_input_std else math.inf


def _erfc(x: float) -> float:
    return math.erfc(x)


def estimate(params: TfheParams, mb_group: int = 1) -> NoiseEstimate:
    """Analytic noise budget for gate bootstrapping at these parameters.

    Models the CENTERED gadget decomposition this implementation uses
    (params.decomposition_round_bit): the reconstruction error per
    coefficient is uniform in +/-eps with eps = 2^-(l*bgbit+1), variance
    eps^2/3, and carries NO bias — so there is no deterministic
    bias-times-secret ramp (the reference's truncating decomposition has
    one). Digits are ~uniform in [-Bg/2, Bg/2), so
    their mean square is Bg^2/12 rather than the worst-case (Bg/2)^2.
    tests/test_torch_multibit.py checks a tiny-set measurement against it.
    """
    g = params.trgsw_lv1
    n0, n1 = params.n0, params.n1
    bg = float(g.bg)
    l = g.l

    var_fresh0 = params.tlwe_lv0.alpha ** 2
    var_bsk = params.bsk_alpha ** 2
    var_ksk = params.ksk_alpha ** 2

    # Blind rotation: n0 CMUX steps; each external product adds
    #   2 * l * N * E[digit^2] * var_bsk   (BSK noise times the digits)
    # + E[s_i] * (1 + N/2) * eps^2 / 3     (centered gadget rounding: the
    #   a-poly error convolves with the ~N/2-weight binary secret, the
    #   b-poly error passes through; both only when the key bit s_i = 1)
    eps2_c = 2.0 ** (-2.0 * (l * g.bgbit + 1))
    var_digit = bg * bg / 12.0
    # BSK rounding (params.bsk_round_bits): each coefficient
    # carries extra uniform error in +/- 2^-(32-rb+1), variance
    # 2^-2(32-rb)/12, entering exactly like BSK noise (times the digits).
    var_bsk_round = (
        2.0 ** (-2.0 * (32 - params.bsk_round_bits)) / 12.0
        if params.bsk_round_bits > 0
        else 0.0
    )
    var_per_cmux = (
        2.0 * l * n1 * var_digit * (var_bsk + var_bsk_round)
        + 0.5 * (1.0 + n1 / 2.0) * eps2_c / 3.0
    )
    var_br = n0 * var_per_cmux
    if mb_group == 2:
        # Multi-bit (pair-grouped) rotation, key.gen_bootstrapping_key_mb:
        # n0/2 external products, each against a sum of FOUR independently
        # encrypted pattern TRGSWs (monomial rotations preserve variance)
        # => 4x the BSK term per step; the centered-decomposition term
        # loses its E[s_i] = 0.5 factor (the message X^(a.s) is a norm-1
        # monomial on every step, not a {0,1} bit).
        var_per_group = (
            4.0 * 2.0 * l * n1 * var_digit * (var_bsk + var_bsk_round)
            + (1.0 + n1 / 2.0) * eps2_c / 3.0
        )
        var_br = (n0 / 2.0) * var_per_group
    elif mb_group != 1:
        raise ValueError("mb_group must be 1 or 2")

    # Key switching lv1 -> lv0: N * t * var_ksk + N * 2^-2(t*basebit+1) rounding
    t = g.iks_t
    var_ks = n1 * t * var_ksk + n1 * 2.0 ** (-2.0 * (t * g.basebit + 1))

    var_out = var_br + var_ks
    var_gate_in = 2.0 * var_out  # linear form a +/- b of two bootstrapped cts

    # margin to the decision boundary for the +/-1/8 encoding after the
    # gate's linear form (NAND: -(a+b) +/- 1/8 sits 1/8 from the sign
    # boundary; inputs contribute 2x variance), plus the modswitch rounding
    # of blind rotation (uniform in +/- 1/(4N) per coefficient):
    var_modswitch = (n0 + 1) * (1.0 / (2.0 * n1)) ** 2 / 12.0
    sigma = math.sqrt(var_gate_in + var_modswitch)
    margin = 1.0 / 16.0
    p_fail = _erfc(margin / (math.sqrt(2.0) * sigma))

    # MUX (gates.mux, 3 rotations): u1/u2 are keyswitch-free bootstrap
    # outputs (lv1 width, var_br each, no var_ks); the final full bootstrap
    # sees u1 + u2 + 1/8 with lv1-width modswitch rounding. Inputs a, b, c
    # are bootstrapped cts, whose noise enters the two inner linear forms.
    var_mux_stage1 = 2.0 * var_out + var_modswitch  # a+b-1/8 rotation margin
    var_mux_final = (
        2.0 * var_br + (n1 + 1) * (1.0 / (2.0 * n1)) ** 2 / 12.0
    )
    sig1 = math.sqrt(var_mux_stage1)
    sig2 = math.sqrt(var_mux_final)
    # 3 decision events: two inner rotations + the final one; union bound
    p_mux = 2.0 * _erfc(margin / (math.sqrt(2.0) * sig1)) + _erfc(
        margin / (math.sqrt(2.0) * sig2)
    )

    return NoiseEstimate(
        fresh_lv0_std=math.sqrt(var_fresh0),
        bootstrap_out_std=math.sqrt(var_out),
        gate_input_std=sigma,
        gate_fail_prob=p_fail,
        mux_fail_prob=min(p_mux, 1.0),
        blind_rotate_std=math.sqrt(var_br),
        keyswitch_std=math.sqrt(var_ks),
    )


def lut_margin(
    params: TfheParams, message_modulus: int, n_summands: int = 3,
    mv_norm: float = 1.0, mb_group: int = 1,
) -> tuple[float, float]:
    """(sigmas, p_fail) for a programmable bootstrap whose input is a sum
    of `n_summands` previously-bootstrapped ciphertexts under the
    m/(2*modulus) message encoding — the radix-arithmetic decision margin
    (radix addition: digit + digit + carry = 3 summands).

    mv_norm: when the summands come from a multi-value bootstrap
    (rs_tfhe_tpu/lut/multi_value.py), the factoring polynomial's ||w||_2 —
    it scales the ACCUMULATOR noise only (blind_rotate_std), not the key-switch or
    mod-switch terms. At the certified radix sets the accumulator term is
    20-100x below those floors, so even mv_norm ~ 22 (the worst factored
    LUT) moves the margin by < 2% — the analysis that makes multi-value
    bootstrapping effectively free here.

    mb_group: 2 when the rotation runs through the multi-bit (pair-grouped)
    chain (ops/blind_rotate.blind_rotate_mb_plain and its kernel,
    CloudKey.generate(multibit=True)) — it scales the blind-rotation
    variance per estimate(mb_group=2) so every certified LUT claim can be
    re-derived under mb routing. The small-batch auto-route only engages on
    LUT paths where `mb_lut_route_ok` holds, i.e. where this margin is
    within 1% of the standard one.

    margin = 1/(4*modulus): messages sit 1/(2*modulus) apart, so the
    decision boundary is HALF a step from each plateau center. (An early
    round-2 version of this function used 1/(2*modulus) — off by 2x; the
    mistake was caught by a reproducible single-digit failure in a 256-
    trial hardware run at exactly the tail probability the corrected
    formula predicts. Trust the halved margin.)

    Variance = n * var_out + modswitch rounding. The modswitch term,
    (n0+1)/(2N)^2/12, is the floor: certifying base-16 (modulus 32) at
    >= 6 sigma requires an N=4096 ring with a low-noise lv0
    (SECURITY_128_BIT_NIBBLE, ~6.5 sigma); SECURITY_128_BIT_RADIX
    (N=2048) gives ~7.5 sigma at base-8 but only ~3.7 sigma at base-16.
    """
    est = estimate(params, mb_group=mb_group)
    n0, n1 = params.n0, params.n1
    var_modswitch = (n0 + 1) * (1.0 / (2.0 * n1)) ** 2 / 12.0
    var_out = (mv_norm * est.blind_rotate_std) ** 2 + est.keyswitch_std**2
    sigma = math.sqrt(n_summands * var_out + var_modswitch)
    margin = 1.0 / (4.0 * message_modulus)
    sigmas = margin / sigma
    return sigmas, _erfc(sigmas / math.sqrt(2.0))


def mb_lut_route_ok(params: TfheParams) -> bool:
    """May programmable bootstraps auto-route through the multi-bit chain?

    True when the pair-grouped rotation's extra variance is negligible
    against the full bootstrap-output budget: var_out(mb) <= 1.02 x
    var_out(std), which bounds EVERY `lut_margin` shift (any modulus, any
    n_summands, any mv_norm) below 1% — so certified LUT claims survive mb
    routing unchanged. Where it fails (e.g. SECURITY_128_BIT_FAST, whose
    rotation noise dominates its budget), `bootstrap_with_testvec` refuses
    the mb route and small-batch LUT calls stay on the standard rotation;
    boolean gates keep their own mb margins (estimate(mb_group=2))."""
    v_std = estimate(params).bootstrap_out_std ** 2
    v_mb = estimate(params, mb_group=2).bootstrap_out_std ** 2
    return v_mb <= 1.02 * v_std


def measure_phase_noise(ct, secret, mu_expected) -> np.ndarray:
    """Empirical torus-fraction noise of LWE ciphertexts.

    ct: int32 [..., n+1] tensor; secret: the matching binary key (int32
    tensor); mu_expected: the expected plaintext(s) as uint32 words. Returns
    signed noise as fractions of the torus (numpy float64) — feed its std
    into sanity checks against `estimate`.
    """
    from ..tlwe import lwe_phase
    from ..torus import to_numpy

    phase = to_numpy(lwe_phase(ct, secret))
    diff = (phase - np.asarray(mu_expected, dtype=np.uint32)).astype(np.uint32)
    signed = diff.astype(np.int64)
    signed = np.where(signed >= 1 << (TORUS_BITS - 1), signed - (1 << TORUS_BITS), signed)
    return signed.astype(np.float64) / float(1 << TORUS_BITS)
