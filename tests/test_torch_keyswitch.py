"""PyTorch port: the key switch's route by batch (`ops.keyswitch.ks_route`),
its counters, and the plan of the small-batch kernel's launch
(`ops.cuda_keyswitch.select_plan`), on the CPU at TEST_TINY. The kernel
itself is held against the product on the card (test_torch_kernel_gpu.py)."""

import pytest

torch = pytest.importorskip("torch")

import rs_tfhe_tpu_torch as pt  # noqa: E402
from rs_tfhe_tpu_torch import key, params  # noqa: E402
from rs_tfhe_tpu_torch.ops import cuda_keyswitch as CKS  # noqa: E402
from rs_tfhe_tpu_torch.ops import keyswitch as KS  # noqa: E402
from rs_tfhe_tpu_torch.torus import limb_width  # noqa: E402
from rs_tfhe_tpu_torch.utils import profiling  # noqa: E402

P = pt.TEST_TINY
CAP = KS.KS_SELECT_MAX_BATCH
#: H100's SM count, and one card that has fewer
SMS = (132, 16)


@pytest.fixture(scope="module")
def ck():
    g = torch.Generator().manual_seed(2121)
    return key.CloudKey.generate(key.SecretKey.generate(P, g), g)


def _moved(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in profiling.counters().items() if v != before.get(k, 0)}


@pytest.mark.parametrize("batch", [1, 3, CAP, CAP + 1])
def test_cpu_tensors_take_the_product_at_every_batch(ck, batch):
    """A CPU tensor's key switch takes the product at any batch, the
    selection kernel's cap included, and counts once under it."""
    ct = torch.randint(-(1 << 31), 1 << 31, (batch, P.n1 + 1), generator=torch.Generator().manual_seed(batch),
                       dtype=torch.int32)
    assert KS.ks_route(ct[..., :P.n1]) == "product"
    before = profiling.counters()
    out = KS.identity_key_switch(ct, ck.ksk_limbs, P)
    assert out.shape == (batch, P.n0 + 1) and out.dtype == torch.int32
    assert _moved(before) == {"keyswitch.route.product.calls": 1, "keyswitch.route.product.ciphertexts": batch}


def test_route_counts_the_ciphertexts_of_every_leading_dimension(ck):
    ct = torch.randint(-(1 << 31), 1 << 31, (2, 3, P.n1 + 1), generator=torch.Generator().manual_seed(5),
                       dtype=torch.int32)
    before = profiling.counters()
    out = KS.identity_key_switch(ct, ck.ksk_limbs, P)
    assert torch.equal(out[1, 2], KS.identity_key_switch(ct[1, 2], ck.ksk_limbs, P))
    moved = _moved(before)
    assert moved["keyswitch.route.product.calls"] == 2
    assert moved["keyswitch.route.product.ciphertexts"] == 6 + 1


def test_counters_hold_the_key_switch_counters():
    got = profiling.counters()
    assert {"ks.launches", "keyswitch.route.select.calls", "keyswitch.route.select.ciphertexts",
            "keyswitch.route.product.calls", "keyswitch.route.product.ciphertexts"} <= set(got)
    assert KS.ROUTES == ("select", "product")


def _sets():
    return [p for p in params.ALL_SECURITY_SETS.values()] + [P]


@pytest.mark.parametrize("batch", [1, 2, 3, 16, 17, 33, 64, 65, 128, 256, 512])
@pytest.mark.parametrize("sms,resident", [(132, 1), (132, 3), (132, 7), (16, 2)])
def test_select_plan_fits_the_kernel(batch, sms, resident):
    """For every set's key-switching table, a re-key table of basebit 6 and
    t 3, and a column shard: a block of at most 16 ciphertexts (a power of
    two, the least that holds the batch below 16), slices that cover every
    row group with none empty, the task table within 32 KB, and at least a
    whole wave of blocks where the groups allow."""
    shapes = {(p.n1, p.trgsw_lv1.iks_t, p.trgsw_lv1.basebit, p.n0 + 1) for p in _sets()}
    shapes |= {(700, 3, 6, 701), (512, 9, 2, 701)}
    for n_in, t, basebit, out_width in sorted(shapes):
        assert limb_width(out_width) <= CKS.MAX_WIDTH
        groups = n_in * t
        bc, per_block, slices = CKS.select_plan(batch, groups, sms, resident)
        assert bc == CKS.block_batch(batch) == min(16, 1 << (batch - 1).bit_length())
        assert (slices - 1) * per_block < groups <= slices * per_block
        assert 1 <= per_block <= CKS.MAX_BLOCK_GROUPS
        assert 8 * min(bc, 1 << basebit) * per_block <= 8 * CKS.MAX_BLOCK_BATCH * CKS.MAX_BLOCK_GROUPS == 32 * 1024
        chunks = -(-batch // bc)
        if groups >= resident * sms:
            assert chunks * slices >= resident * sms


def test_kernel_wrapper_takes_cuda_tensors_only(ck):
    ct = torch.zeros((1, P.n1 + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        CKS.digit_select_kernel(ct[..., :P.n1], ct[..., P.n1], ck.ksk_limbs, P.trgsw_lv1.iks_t,
                                P.trgsw_lv1.basebit, P.n0 + 1)
