"""PyTorch port: the hand-written blind-rotation kernel on the card, held bit
for bit against its plain PyTorch version.

Every test here needs a CUDA device (marker `gpu`) and skips without one:
the kernel has no CPU mode. This file imports neither JAX nor the JAX
package, so it also runs on a machine without them:

    python -m pytest tests/test_torch_kernel_gpu.py --noconftest -o addopts="" -q
"""

import pytest

torch = pytest.importorskip("torch")

from rs_tfhe_tpu_torch import params as P  # noqa: E402
from rs_tfhe_tpu_torch.ops import blind_rotate as BR  # noqa: E402
from rs_tfhe_tpu_torch.ops import cuda_blind_rotate as CBR  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the blind-rotation kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(dev, p, batch, per_ct_tv, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(shape, lo=-(1 << 31), hi=1 << 31):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32, device=dev)

    n = p.n1
    bsk = rnd((p.n0, 2 * p.trgsw_lv1.l, 2, n))
    tv = rnd((batch, 2, n) if per_ct_tv else (2, n))
    return rnd((batch,), 0, 2 * n), rnd((batch, p.n0), 0, 2 * n), tv, bsk


@pytest.mark.parametrize("per_ct_tv", [False, True], ids=["shared_tv", "per_ct_tv"])
@pytest.mark.parametrize("tile", [1, 2, 4, 8])
def test_kernel_matches_plain_every_tile(dev, tile, per_ct_tv):
    """TEST_TINY, a batch that no tile divides (the ragged last block)."""
    args = _inputs(dev, P.TEST_TINY, 11, per_ct_tv, seed=tile)
    out = CBR.blind_rotate_kernel(*args, P.TEST_TINY, tile=tile)
    torch.cuda.synchronize()
    assert torch.equal(out, BR.blind_rotate_plain(*args, P.TEST_TINY))


@pytest.mark.parametrize(
    "name,batch", [("SECURITY_128_BIT_FAST", 8), ("SECURITY_128_BIT", 4), ("SECURITY_128_BIT_RADIX", 2)]
)
def test_kernel_matches_plain_full_width(dev, name, batch):
    p = getattr(P, name)
    args = _inputs(dev, p, batch, False, seed=batch)
    out = CBR.blind_rotate_kernel(*args, p)
    torch.cuda.synchronize()
    assert torch.equal(out, BR.blind_rotate_plain(*args, p))


def test_dispatch_launches_kernel_and_counts(dev):
    p = P.TEST_TINY
    b_til, a_til, tv, bsk = _inputs(dev, p, 3, False, seed=7)
    ct = torch.randint(-(1 << 31), 1 << 31, (3, p.n0 + 1), dtype=torch.int32, device=dev)
    before = CBR.launches
    out = BR.blind_rotate(ct, tv, bsk, p)
    assert CBR.launches == before + 1
    b_til, a_til = BR.rotation_exponents(ct, p)
    assert torch.equal(out, BR.blind_rotate_plain(b_til, a_til, tv, bsk, p))


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    p = P.TEST_TINY
    b_til, a_til, tv, bsk = _inputs(dev, p, 4, False, seed=8)
    with pytest.raises(TypeError):
        CBR.blind_rotate_kernel(b_til, a_til.to(torch.int64), tv, bsk, p)
    with pytest.raises(ValueError, match="shape"):
        CBR.blind_rotate_kernel(b_til, a_til[:, :-1].contiguous(), tv, bsk, p)
    with pytest.raises(ValueError, match="contiguous"):
        CBR.blind_rotate_kernel(b_til, a_til.t().contiguous().t(), tv, bsk, p)
    with pytest.raises(ValueError, match="on cpu"):
        CBR.blind_rotate_kernel(b_til, a_til, tv.cpu(), bsk, p)
