"""PyTorch port: the hand-written kernels on the card, held bit for bit
against their plain PyTorch versions: the blind rotation
(csrc/blind_rotate.cu), the multi-bit blind rotation
(csrc/blind_rotate_mb.cu), the external-product step
(csrc/external_product.cu), the probe and primitive-rate kernels
(csrc/probes.cu) and the small-batch key switch (csrc/key_switch.cu,
against the one-hot product).

Every test here needs a CUDA device (marker `gpu`) and skips without one:
the kernels have no CPU mode. This file imports neither JAX nor the JAX
package, so it also runs on a machine without them:

    python -m pytest tests/test_torch_kernel_gpu.py --noconftest -o addopts="" -q
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from rs_tfhe_tpu_torch import _build  # noqa: E402
from rs_tfhe_tpu_torch import config as PC  # noqa: E402
from rs_tfhe_tpu_torch import params as P  # noqa: E402
from rs_tfhe_tpu_torch.ops import blind_rotate as BR  # noqa: E402
from rs_tfhe_tpu_torch.ops import cuda_blind_rotate as CBR  # noqa: E402
from rs_tfhe_tpu_torch.ops import cuda_blind_rotate_mb as CMB  # noqa: E402
from rs_tfhe_tpu_torch.ops import cuda_probes as CP  # noqa: E402
from rs_tfhe_tpu_torch.ops import cuda_keyswitch as CKS  # noqa: E402
from rs_tfhe_tpu_torch.ops import cuda_launch as CL  # noqa: E402
from rs_tfhe_tpu_torch.ops import cuda_step as CS  # noqa: E402
from rs_tfhe_tpu_torch.ops import keyswitch as KS  # noqa: E402
from rs_tfhe_tpu_torch.ops.poly import polymul_small_by_torus  # noqa: E402
from rs_tfhe_tpu_torch.torus import limb_width, planar_limbs  # noqa: E402
from rs_tfhe_tpu_torch.utils import profiling  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _count(name: str) -> int:
    """The package's counter `name` now (`profiling.counters()`; 0 where it
    has not counted yet)."""
    return profiling.counters().get(name, 0)


def _moved(before: dict) -> dict:
    """The counters that moved since the snapshot `before`, by how much."""
    now = profiling.counters()
    return {k: v - before.get(k, 0) for k, v in now.items() if v != before.get(k, 0)}


def _launched(before: dict, prefix: str) -> dict:
    """The instances of the kernel counted under `prefix` (`k1.instance`,
    ...) launched since the snapshot `before`, keyed as the wrapper keys
    them (the name's '/'-separated parts, numbers as ints), by how often."""
    head = prefix + "."
    return {tuple(int(x) if x.isdigit() else x for x in k[len(head):].split("/")): n
            for k, n in _moved(before).items() if k.startswith(head)}


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


_CLUSTER_INSTANCES = [(t, c) for c in (2, 4, 8) for t in range(1, 9)]


@pytest.mark.parametrize("per_ct_tv", [False, True], ids=["shared_tv", "per_ct_tv"])
@pytest.mark.parametrize("tile,cluster", _CLUSTER_INSTANCES, ids=lambda v: str(v))
def test_cluster_kernel_matches_plain_every_instance(dev, tile, cluster, per_ct_tv):
    """TEST_TINY (N=64: clusters of 2, 4 and 8), every tile, a ragged batch:
    rows past the batch, and a second wave of clusters at the small tiles."""
    batch = 2 * tile + 3
    args = _inputs(dev, P.TEST_TINY, batch, per_ct_tv, seed=100 + 10 * cluster + tile)
    before = profiling.counters()
    out = CBR.blind_rotate_kernel(*args, P.TEST_TINY, tile=tile, cluster=cluster)
    torch.cuda.synchronize()
    assert _launched(before, "k1.instance") == {(P.TEST_TINY.n1, tile, cluster, "imad"): 1}
    assert torch.equal(out, BR.blind_rotate_plain(*args, P.TEST_TINY))


@pytest.mark.parametrize(
    "name,batch,tile,cluster",
    [("SECURITY_128_BIT_FAST", 3, 1, 16), ("SECURITY_128_BIT_FAST", 5, 3, 16), ("SECURITY_128_BIT_FAST", 9, 8, 16),
     ("SECURITY_128_BIT", 7, 5, 8), ("SECURITY_128_BIT_FAST", 11, 7, 4), ("SECURITY_128_BIT_FAST", 6, 4, 2),
     ("SECURITY_UINT4", 4, 2, 16), ("SECURITY_128_BIT_RADIX", 5, 4, 16), ("SECURITY_128_BIT_RADIX", 3, 2, 8),
     ("SECURITY_128_BIT_NIBBLE", 2, 2, 16)],
)
def test_cluster_kernel_matches_plain_full_width(dev, name, batch, tile, cluster):
    """Clusters of 16 exist only from N=1024 up: the real ring sizes, with
    per-ciphertext test vectors and a batch the tile does not divide."""
    p = getattr(P, name)
    args = _inputs(dev, p, batch, True, seed=batch + cluster)
    out = CBR.blind_rotate_kernel(*args, p, tile=tile, cluster=cluster)
    torch.cuda.synchronize()
    assert torch.equal(out, BR.blind_rotate_plain(*args, p))


def _short(p, n0):
    """The set with a short LWE dimension: the same ring, gadget and kernel
    instances, a rotation of n0 steps."""
    return dataclasses.replace(p, tlwe_lv0=dataclasses.replace(p.tlwe_lv0, n=n0))


@pytest.mark.parametrize(
    "name,batch", [("SECURITY_128_BIT_FAST", 1), ("SECURITY_128_BIT_FAST", 20), ("SECURITY_128_BIT_FAST", 70),
                   ("SECURITY_UINT4", 70), ("TEST_TINY", 300)]
)
def test_kernel_launches_the_planned_instance(dev, name, batch):
    """With no tile given the wrapper launches what `planned_instance` picks
    from the clusters this card holds: the CUDA cores at small batches and
    for wide digits, the tensor cores from a few dozen single-limb
    ciphertexts up."""
    p = getattr(P, name)
    p = _short(p, 6) if p.n1 == 1024 else p
    log_n = p.n1.bit_length() - 1
    slots = CL.cluster_slots(dev.index or 0, log_n, CBR.held_clusters)
    assert slots[1] == torch.cuda.get_device_properties(dev).multi_processor_count
    assert all(slots[c] * c <= slots[1] for c in slots)
    args = _inputs(dev, p, batch, False, seed=batch)
    has_mma = p.n1 in CBR.MMA_RING_SIZES and CL.takes_tensor_cores(p)
    limbs = CBR.key_limbs(args[3], p) if has_mma else 0
    assert limbs == (4 if has_mma else 0)  # a random key is not on the 2^8 grid
    tile, cluster, limbs = CBR.planned_instance(dev.index or 0, batch, p, limbs)
    tensor_cores = limbs > 0
    assert tensor_cores == (name == "SECURITY_128_BIT_FAST" and batch == 70)
    before = profiling.counters()
    out = CBR.blind_rotate_kernel(*args, p)
    torch.cuda.synchronize()
    unit = CBR.tensor_core_unit(CBR.on_wgmma(p.n1, tile, 4), 4) if tensor_cores else "imad"
    assert _launched(before, "k1.instance") == {(p.n1, tile, cluster, unit): 1}
    assert torch.equal(out, BR.blind_rotate_plain(*args, p))


@pytest.mark.parametrize("per_ct_tv", [False, True], ids=["shared_tv", "per_ct_tv"])
@pytest.mark.parametrize("on_grid", [False, True], ids=["four_limbs", "three_limbs"])
@pytest.mark.parametrize(
    "name,batch", [("SECURITY_128_BIT_FAST", 5), ("SECURITY_128_BIT_FAST", 37), ("SECURITY_128_BIT", 16),
                   ("SECURITY_80_BIT", 300), ("SECURITY_128_BIT_FAST", 500), ("SECURITY_128_BIT_RADIX", 150)]
)
def test_tensor_core_kernel_matches_plain(dev, name, batch, on_grid, per_ct_tv):
    """The s8 limb product inside the rotation (N = 1024 on a cluster of 8, N
    = 2048 on a cluster of 16): full-range key words, rows past the batch,
    more clusters than the card holds at once. Only SECURITY_128_BIT_FAST rounds its key to the 2^8 grid:
    a key on it takes 3 limbs there (and, L being 2, may take 32 ciphertexts a
    cluster: every tile the set has is held), every other case 4."""
    p = _short(getattr(P, name), 5)
    b_til, a_til, tv, bsk = _inputs(dev, p, batch, per_ct_tv, seed=batch)
    bsk = bsk & ~0xFF if on_grid else bsk
    limbs = 3 if on_grid and p.bsk_round_bits == 8 else 4
    assert CBR.key_limbs(bsk, p) == limbs
    tiles = CBR.mma_tiles(p, limbs)
    assert tiles == ((16, 32) if limbs == 3 else (16,))
    cluster = 2 * p.n1 // CBR.MMA_COLS
    ref = BR.blind_rotate_plain(b_til, a_til, tv, bsk, p)
    for tile in tiles:
        before = profiling.counters()
        out = CBR.blind_rotate_kernel(b_til, a_til, tv, bsk, p, tile=tile, tensor_cores=True)
        torch.cuda.synchronize()
        assert _launched(before, "k1.instance") == {
            (p.n1, tile, cluster, CBR.tensor_core_unit(CBR.on_wgmma(p.n1, tile, limbs), limbs)): 1}
        assert torch.equal(out, ref)
    before = profiling.counters()
    out = CBR.blind_rotate_kernel(b_til, a_til, tv, bsk, p, tensor_cores=True)
    ((_, picked, _, _),) = _launched(before, "k1.instance").keys()
    assert picked in tiles and torch.equal(out, ref)
    if limbs == 4:
        with pytest.raises(ValueError, match="has tiles"):
            CBR.blind_rotate_kernel(b_til, a_til, tv, bsk, p, tile=32, tensor_cores=True)


def _planted(dev, p, batch, seed, per_ct_tv):
    """Full-length rotation inputs with 0x80000000 and 0xFFFFFFFF planted in
    the key and the test vectors (so in the accumulators from the start)."""
    b_til, a_til, tv, bsk = _inputs(dev, p, batch, per_ct_tv, seed)
    for t in (bsk, tv):
        t.view(-1)[::97], t.view(-1)[5::101] = -(1 << 31), -1
    return b_til, a_til, tv, bsk


@pytest.mark.parametrize(
    "name,batch,on_grid,tile,unit",
    [("SECURITY_128_BIT_FAST", 32, True, 32, "wgmma_s8x3"), ("SECURITY_128_BIT_FAST", 47, True, 32, "wgmma_s8x3"),
     ("SECURITY_128_BIT_FAST", 481, True, 32, "wgmma_s8x3"), ("SECURITY_128_BIT", 16, False, 16, "mma_s8x4"),
     ("SECURITY_128_BIT", 75, False, 16, "mma_s8x4"), ("SECURITY_128_BIT_RADIX", 16, False, 16, "mma_s8x4"),
     ("SECURITY_128_BIT_RADIX", 40, False, 16, "mma_s8x4")],
)
def test_tensor_core_instance_bit_equal_at_each_shape(dev, name, batch, on_grid, tile, unit):
    """The tensor-core instance at every shape it serves, whole rotations:
    FAST's 32-row tiles on wgmma with a three-limb key (a ragged last tile at
    47 and 481), strict's 16-row tiles on mma.sync with four limbs, RADIX (N =
    2048) on mma.sync with per-ciphertext test vectors; extremes planted in
    the key and the test vectors. Each case names the unit it ran."""
    p = getattr(P, name)
    b_til, a_til, tv, bsk = _planted(dev, p, batch, batch, per_ct_tv=p.n1 == 2048)
    bsk = bsk & ~0xFF if on_grid else bsk
    before = profiling.counters()
    out = CBR.blind_rotate_kernel(b_til, a_til, tv, bsk, p, tile=tile, tensor_cores=True)
    torch.cuda.synchronize()
    assert _launched(before, "k1.instance") == {(p.n1, tile, 2 * p.n1 // CBR.MMA_COLS, unit): 1}
    assert torch.equal(out, BR.blind_rotate_plain(b_til, a_til, tv, bsk, p))


def test_wgmma_strips_built_once_per_key_and_after_an_edit(dev):
    """The wgmma instance's key operand is built once for a key tensor, of the
    size the library names (for the one shape it names a size for), and again
    after the key changes in place; it holds `key_strips_plain`'s bytes, and
    the rotation stays bit-equal to the plain one either way."""
    p = _short(P.SECURITY_128_BIT_FAST, 5)
    b_til, a_til, tv, bsk = _planted(dev, p, 40, seed=11, per_ct_tv=False)
    bsk &= ~0xFF
    lib, g = _build.load(), p.trgsw_lv1
    assert [(n, t, k) for n in CBR.MMA_RING_SIZES for t in (16, 32) for k in (3, 4) if CBR.on_wgmma(n, t, k)] == [
        (1024, 32, 3)]
    before = _count("bsk.strip_builds")
    for _ in range(2):
        out = CBR.blind_rotate_kernel(b_til, a_til, tv, bsk, p, tile=32, tensor_cores=True)
        assert torch.equal(out, BR.blind_rotate_plain(b_til, a_til, tv, bsk, p))
    assert _count("bsk.strip_builds") - before == 1
    strips = CBR.key_strips(bsk, p, 32, 3)
    assert strips.numel() == lib.tfhe_blind_rotate_strip_bytes(10, p.n0, g.l, 32, 3) == 5 * 4 * 2 * 3 * 254 * 128
    assert torch.equal(strips, CBR.key_strips_plain(bsk, 3))
    bsk[1, 2, 1, 7] += 1 << 8  # still on the grid
    out = CBR.blind_rotate_kernel(b_til, a_til, tv, bsk, p, tile=32, tensor_cores=True)
    assert _count("bsk.strip_builds") - before == 2
    assert torch.equal(CBR.key_strips(bsk, p, 32, 3), CBR.key_strips_plain(bsk, 3))
    assert torch.equal(out, BR.blind_rotate_plain(b_til, a_til, tv, bsk, p))


def test_wgmma_strips_one_key_a_device(dev):
    """A device keeps one key's strips however many keys run on it: keys
    taken in turn build theirs at each switch, in place of the last key's,
    and each rotation is bit-equal to the plain one; a key's strips go when
    the key goes."""
    p = _short(P.SECURITY_128_BIT_FAST, 4)
    b_til, a_til, tv, _ = _planted(dev, p, 33, seed=12, per_ct_tv=False)
    keys = [_planted(dev, p, 1, seed=20 + t, per_ct_tv=False)[3] & ~0xFF for t in range(3)]
    refs = [BR.blind_rotate_plain(b_til, a_til, tv, bsk, p) for bsk in keys]
    before = _count("bsk.strip_builds")
    for bsk, ref in [*zip(keys, refs), *zip(keys, refs)]:
        assert torch.equal(CBR.blind_rotate_kernel(b_til, a_til, tv, bsk, p, tile=32, tensor_cores=True), ref)
        assert [e[0]() is bsk for e in CBR._strips.values()] == [True]
    assert _count("bsk.strip_builds") - before == 6
    del bsk, keys
    assert b_til.device.index not in CBR._strips


def test_tensor_core_kernel_full_rotation_and_key_check(dev):
    """A whole SECURITY_128_BIT_FAST rotation on the tensor cores equals the
    CUDA cores'; a key edited in place off the grid is seen (a dropped limb
    would lose its low byte)."""
    p = P.SECURITY_128_BIT_FAST
    b_til, a_til, tv, bsk = _inputs(dev, p, 20, False, seed=5)
    bsk &= ~0xFF
    assert CBR.key_limbs(bsk, p) == 3
    out = CBR.blind_rotate_kernel(b_til, a_til, tv, bsk, p, tensor_cores=True)
    assert torch.equal(out, CBR.blind_rotate_kernel(b_til, a_til, tv, bsk, p, tensor_cores=False))
    bsk[0, 0, 0, 0] |= 1
    assert CBR.key_limbs(bsk, p) == 4
    out = CBR.blind_rotate_kernel(b_til, a_til, tv, bsk, p, tensor_cores=True)
    assert torch.equal(out, CBR.blind_rotate_kernel(b_til, a_til, tv, bsk, p, tensor_cores=False))


def test_tensor_core_clusters_are_counted_with_their_shared_memory(dev):
    """The occupancy query of the tensor-core instance is made on the shape
    that is launched: its shared memory grows with the gadget length, so 32
    rows a cluster fit at L = 2 and not at L = 3, and N = 2048 with L = 3
    (nearly all of a block's shared memory) still holds a cluster of 16."""
    index = dev.index or 0
    fast, strict, radix = P.SECURITY_128_BIT_FAST, P.SECURITY_128_BIT, P.SECURITY_128_BIT_RADIX
    held = CBR.mma_slots(index, fast, 3)
    assert set(held) == {16, 32} and all(n >= 1 for n in held.values())
    assert held[32] == CBR.max_active_clusters(index, 10, 32, 8, 3, fast.trgsw_lv1.l)
    assert CBR.max_active_clusters(index, 10, 32, 8, 3, strict.trgsw_lv1.l) == 0  # L = 3: 232 KB
    assert set(CBR.mma_slots(index, strict, 4)) == {16}
    assert CBR.mma_slots(index, radix, 4)[16] >= 1
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert all(n * 8 <= sms for n in held.values()) and CBR.mma_slots(index, radix, 4)[16] * 16 <= sms
    with pytest.raises(RuntimeError, match="no instance"):  # no tile of 48
        CBR.max_active_clusters(index, 10, 48, 8, 3, 2)


def test_key_made_in_inference_mode_is_checked_every_call(dev):
    """A key tensor made under torch.inference_mode() has no version counter:
    the wrapper reads its limbs at every call instead of failing or trusting
    an earlier answer."""
    p = _short(P.SECURITY_128_BIT_FAST, 5)
    b_til, a_til, tv, bsk = _inputs(dev, p, 40, False, seed=9)
    with torch.inference_mode():
        key = bsk & ~0xFF
        assert CBR.key_limbs(key, p) == 3
        key[0, 0, 0, 0] |= 1
        assert CBR.key_limbs(key, p) == 4
    before = profiling.counters()
    out = CBR.blind_rotate_kernel(b_til, a_til, tv, key, p, tensor_cores=True)
    assert _launched(before, "k1.instance") == {(p.n1, 16, 8, "mma_s8x4"): 1}
    assert torch.equal(out, BR.blind_rotate_plain(b_til, a_til, tv, key, p))


@pytest.mark.parametrize(
    "name,batch", [("SECURITY_128_BIT_FAST", 8), ("SECURITY_128_BIT", 4), ("SECURITY_128_BIT_RADIX", 2)]
)
def test_kernel_matches_plain_full_width(dev, name, batch):
    p = getattr(P, name)
    args = _inputs(dev, p, batch, False, seed=batch)
    out = CBR.blind_rotate_kernel(*args, p)
    torch.cuda.synchronize()
    assert torch.equal(out, BR.blind_rotate_plain(*args, p))


@pytest.mark.parametrize(
    "kernel,at_1024", [("tfhe_blind_rotate", 8), ("tfhe_blind_rotate_mb", 4), ("tfhe_external_product", 8)]
)
def test_max_tile_per_ring_size(dev, kernel, at_1024):
    """Each kernel's largest tile, as its source states it and the wrappers
    read it: constant up to N=1024, then halved per doubling of N."""
    max_tile = getattr(_build.load(), f"{kernel}_max_tile")
    assert [max_tile(log_n) for log_n in range(6, 13)] == [at_1024] * 5 + [at_1024 // 2, at_1024 // 4]


def test_max_cluster_per_ring_size(dev):
    """Cluster instances exist at the parameter sets' ring sizes: 64 (up to
    8 blocks: a digit slice is at least one 8-word window) and 1024 up."""
    max_cluster = _build.load().tfhe_blind_rotate_max_cluster
    assert [max_cluster(log_n) for log_n in range(6, 13)] == [8, 1, 1, 1, 16, 16, 16]


def test_dispatch_launches_kernel_and_counts(dev):
    p = P.TEST_TINY
    b_til, a_til, tv, bsk = _inputs(dev, p, 3, False, seed=7)
    ct = torch.randint(-(1 << 31), 1 << 31, (3, p.n0 + 1), dtype=torch.int32, device=dev)
    before, tiles = _count("k1.launches"), profiling.counters()
    out = BR.blind_rotate(ct, tv, bsk, p)
    assert _count("k1.launches") == before + 1
    slots = CL.cluster_slots(dev.index or 0, p.n1.bit_length() - 1, CBR.held_clusters)
    planned = CBR.rotation_instance(3, 8, slots)  # N=64: CUDA cores
    assert planned[1] > 1  # three ciphertexts do not fill the card with single blocks
    assert _launched(tiles, "k1.instance") == {(p.n1, *planned, "imad"): 1}
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
    with pytest.raises(ValueError, match="no tensor-core instance"):  # N=64; N=4096 has none either
        CBR.blind_rotate_kernel(b_til, a_til, tv, bsk, p, tensor_cores=True)
    with pytest.raises(ValueError, match="needs its tile"):
        CBR.blind_rotate_kernel(b_til, a_til, tv, bsk, p, cluster=2)
    with pytest.raises(RuntimeError, match="no instance"):  # N=64 has no cluster of 16
        CBR.blind_rotate_kernel(b_til, a_til, tv, bsk, p, tile=1, cluster=16)
    with pytest.raises(RuntimeError, match="launch failed"):  # single blocks: powers of two
        CBR.blind_rotate_kernel(b_til, a_til, tv, bsk, p, tile=3)


def _mb_inputs(dev, p, batch, per_ct_tv, seed):
    b_til, a_til, tv, _ = _inputs(dev, p, batch, per_ct_tv, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1000)
    shape = (p.n0 // 2, 4, 2 * p.trgsw_lv1.l, 2, p.n1)
    bsk_mb = torch.randint(-(1 << 31), 1 << 31, shape, generator=g, dtype=torch.int32, device=dev)
    return b_til, a_til, tv, bsk_mb


@pytest.mark.parametrize("per_ct_tv", [False, True], ids=["shared_tv", "per_ct_tv"])
@pytest.mark.parametrize("tile", [1, 2, 4])
def test_mb_kernel_matches_plain_every_tile(dev, tile, per_ct_tv):
    args = _mb_inputs(dev, P.TEST_TINY, 11, per_ct_tv, seed=20 + tile)
    out = CMB.blind_rotate_mb_kernel(*args, P.TEST_TINY, tile=tile)
    torch.cuda.synchronize()
    assert torch.equal(out, BR.blind_rotate_mb_plain(*args, P.TEST_TINY))


@pytest.mark.parametrize(
    "name,batch", [("SECURITY_128_BIT_FAST", 2), ("SECURITY_128_BIT", 4), ("SECURITY_128_BIT_RADIX", 1)]
)
def test_mb_kernel_matches_plain_full_width(dev, name, batch):
    p = getattr(P, name)
    args = _mb_inputs(dev, p, batch, True, seed=30 + batch)
    out = CMB.blind_rotate_mb_kernel(*args, p)
    torch.cuda.synchronize()
    assert torch.equal(out, BR.blind_rotate_mb_plain(*args, p))


def _mb_extremes(bsk_mb):
    """0x80000000 and 0xFFFFFFFF in every pattern of the multi-bit key (in
    place): the monomial's sign and the extension's sign meet on them."""
    bsk_mb[:, :, 0, 0, ::7], bsk_mb[:, :, -1, 1, 3::11] = -(1 << 31), -1
    return bsk_mb


_MB_CLUSTER_INSTANCES = [(t, c) for c in (2, 4, 8) for t in (1, 2, 4)]


@pytest.mark.parametrize("per_ct_tv", [False, True], ids=["shared_tv", "per_ct_tv"])
@pytest.mark.parametrize("tile,cluster", _MB_CLUSTER_INSTANCES, ids=lambda v: str(v))
def test_mb_cluster_kernel_matches_plain_every_instance(dev, tile, cluster, per_ct_tv):
    """TEST_TINY (N=64: clusters of 2, 4 and 8), every tile of the cluster
    instance, a ragged batch (rows past the batch), full-range key words with
    the sign extremes."""
    b_til, a_til, tv, bsk_mb = _mb_inputs(dev, P.TEST_TINY, 2 * tile + 3, per_ct_tv, seed=200 + 10 * cluster + tile)
    _mb_extremes(bsk_mb)
    before = profiling.counters()
    out = CMB.blind_rotate_mb_kernel(b_til, a_til, tv, bsk_mb, P.TEST_TINY, tile=tile, cluster=cluster)
    torch.cuda.synchronize()
    assert _launched(before, "k4.instance") == {(P.TEST_TINY.n1, tile, cluster): 1}
    assert torch.equal(out, BR.blind_rotate_mb_plain(b_til, a_til, tv, bsk_mb, P.TEST_TINY))


@pytest.mark.parametrize(
    "name,batch,per_ct_tv",
    [("SECURITY_128_BIT_FAST", 1, False), ("SECURITY_128_BIT_FAST", 2, True), ("SECURITY_128_BIT", 4, False),
     ("SECURITY_128_BIT_RADIX", 1, False), ("SECURITY_128_BIT_NIBBLE", 1, True)],
)
def test_mb_cluster_kernel_matches_plain_full_width(dev, name, batch, per_ct_tv):
    """The batches `auto` sends the multi-bit kernel, at the real ring sizes:
    the plan gives each ciphertext a cluster of 16."""
    p = getattr(P, name)
    b_til, a_til, tv, bsk_mb = _mb_inputs(dev, p, batch, per_ct_tv, seed=300 + batch)
    _mb_extremes(bsk_mb)
    assert CMB.planned_instance(dev.index or 0, batch, p) == (1, 16)
    before = profiling.counters()
    out = CMB.blind_rotate_mb_kernel(b_til, a_til, tv, bsk_mb, p)
    torch.cuda.synchronize()
    assert _launched(before, "k4.instance") == {(p.n1, 1, 16): 1}
    assert torch.equal(out, BR.blind_rotate_mb_plain(b_til, a_til, tv, bsk_mb, p))


@pytest.mark.parametrize("name", ["TEST_TINY", "SECURITY_128_BIT_FAST"])
def test_blind_rotate_mb_key_launches_by_cap(dev, name):
    """`blind_rotate` with a multi-bit key launches the multi-bit kernel up to
    `mb_route_batch_cap` (4 at TEST_TINY, 2 at FAST) and the whole-rotation
    kernel above it, each equal to its plain version."""
    p = getattr(P, name)
    p = _short(p, 6) if p.n1 == 1024 else p
    cap = BR.mb_route_batch_cap(p)
    _, _, tv, bsk_mb = _mb_inputs(dev, p, cap + 1, False, seed=60)
    _, _, _, bsk = _inputs(dev, p, cap + 1, False, seed=61)
    ct = torch.randint(-(1 << 31), 1 << 31, (cap + 1, p.n0 + 1), dtype=torch.int32, device=dev)
    for batch, multibit in ((cap, True), (cap + 1, False)):
        x = ct[:batch]
        k1, k4 = _count("k1.launches"), _count("k4.launches")
        out = BR.blind_rotate(x, tv, bsk, p, bsk_mb=bsk_mb)
        assert (_count("k1.launches") - k1, _count("k4.launches") - k4) == ((0, 1) if multibit else (1, 0))
        b_til, a_til = BR.rotation_exponents(x, p)
        ref = (BR.blind_rotate_mb_plain(b_til, a_til, tv, bsk_mb, p) if multibit
               else BR.blind_rotate_plain(b_til, a_til, tv, bsk, p))
        assert torch.equal(out, ref)


def test_mb_cluster_tiles_and_refusals(dev):
    """The cluster instance's largest tile per ring size (4 up to N=2048, 1 at
    4096 where a tile of 2 spills; none where the ring size has no cluster
    instance), and what the wrapper refuses."""
    lib = _build.load()
    assert [lib.tfhe_blind_rotate_mb_max_cluster_tile(log_n) for log_n in range(6, 13)] == [4, 0, 0, 0, 4, 4, 1]
    p = P.TEST_TINY
    b_til, a_til, tv, bsk_mb = _mb_inputs(dev, p, 3, False, seed=62)
    with pytest.raises(RuntimeError, match="no instance"):  # N=64 has no cluster of 16
        CMB.blind_rotate_mb_kernel(b_til, a_til, tv, bsk_mb, p, tile=1, cluster=16)
    with pytest.raises(RuntimeError, match="no instance"):  # tiles 1, 2 and 4 only
        CMB.blind_rotate_mb_kernel(b_til, a_til, tv, bsk_mb, p, tile=3, cluster=2)
    with pytest.raises(ValueError, match="needs its tile"):
        CMB.blind_rotate_mb_kernel(b_til, a_til, tv, bsk_mb, p, cluster=2)


def _step_inputs(dev, p, rows, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    l, n, hb = p.trgsw_lv1.l, p.n1, p.trgsw_lv1.half_bg
    d = torch.randint(-hb, hb, (rows, 2 * l, n), generator=g, dtype=torch.int32, device=dev)
    t = torch.randint(-(1 << 31), 1 << 31, (2 * l, 2, n), generator=g, dtype=torch.int32, device=dev)
    return d, t


def _extremes(p, d, t):
    """Put the ends of the digit range and the words 0x80000000, 0xFFFFFFFF
    and 0 into the operands (in place)."""
    hb = p.trgsw_lv1.half_bg
    d[0, :, ::3], d[-1, :, 1::2] = -hb, hb - 1
    t[0, 0, ::2], t[-1, 1, ::3], t[0, 1, 5] = -(1 << 31), -1, 0
    return d, t


@pytest.mark.parametrize("split", [1, 8])
@pytest.mark.parametrize("tile", [1, 2, 4, 8])
def test_step_kernel_matches_plain_every_tile(dev, tile, split):
    """The CUDA-core instance, asked for by its tile: every tile, with and
    without the column split, a ragged row count."""
    d, t = _extremes(P.TEST_TINY, *_step_inputs(dev, P.TEST_TINY, 11, seed=40 + tile))
    before = profiling.counters()
    out = CS.external_product_kernel(d, t, P.TEST_TINY, tile=tile, split=split)
    torch.cuda.synchronize()
    assert _launched(before, "k5.instance") == {(P.TEST_TINY.n1, "imad", tile, split, 2 * P.TEST_TINY.trgsw_lv1.l): 1}
    assert torch.equal(out, polymul_small_by_torus(d, t, P.TEST_TINY.trgsw_lv1.half_bg))


@pytest.mark.parametrize(
    "name,rows",
    [("TEST_TINY", 11), ("TEST_TINY", 300), ("SECURITY_128_BIT_FAST", 8), ("SECURITY_128_BIT_FAST", 130),
     ("SECURITY_128_BIT_FAST", 256), ("SECURITY_128_BIT", 64), ("SECURITY_80_BIT", 17),
     ("SECURITY_128_BIT_RADIX", 64), ("SECURITY_128_BIT_NIBBLE", 16)],
)
def test_step_kernel_on_tensor_cores_matches_plain(dev, name, rows):
    """Single-limb digits go to the s8 limb product: full-range words, the
    digit range's ends, rows past the last block's 128 and few rows."""
    p = getattr(P, name)
    d, t = _extremes(p, *_step_inputs(dev, p, rows, seed=rows))
    before = profiling.counters()
    out = CS.external_product_kernel(d, t, p)
    torch.cuda.synchronize()
    instance = (p.n1, "mma_s8", CS.MMA_ROWS, 2 * p.n1 // CS.MMA_COLS, 2 * p.trgsw_lv1.l)
    assert _launched(before, "k5.instance") == {instance: 1}
    assert torch.equal(out, polymul_small_by_torus(d, t, p.trgsw_lv1.half_bg))
    if p.n1 <= 64:
        assert torch.equal(out, CS.limb_product_plain(d, t))


@pytest.mark.parametrize("name,rows", [("SECURITY_UINT4", 8), ("SECURITY_UINT4", 300), ("SECURITY_UINT1", 2048)])
def test_step_kernel_wide_digits_stay_on_cuda_cores(dev, name, rows):
    """Digits wider than 8 bits keep whole-word multiply-adds, with the
    columns split over the grid while the rows alone do not fill the card."""
    p = getattr(P, name)
    d, t = _extremes(p, *_step_inputs(dev, p, rows, seed=rows))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    instance = CS.step_instance(p, rows, _build.load().tfhe_external_product_max_tile(10), sms)
    assert instance[1] == "imad" and (instance[3] == 8) == (-(-rows // 8) < sms)
    before = profiling.counters()
    out = CS.external_product_kernel(d, t, p)
    torch.cuda.synchronize()
    assert _launched(before, "k5.instance") == {(*instance, 2 * p.trgsw_lv1.l): 1}
    assert torch.equal(out, polymul_small_by_torus(d, t, p.trgsw_lv1.half_bg))


def test_routes_launch_their_kernels_and_count(dev):
    """A multi-bit key launches the multi-bit kernel once;
    step_impl="pallas" launches the step kernel once per step; both equal
    their plain versions."""
    p = P.TEST_TINY
    b_til, a_til, tv, bsk_mb = _mb_inputs(dev, p, 3, False, seed=50)
    _, _, _, bsk = _inputs(dev, p, 3, False, seed=51)
    ct = torch.randint(-(1 << 31), 1 << 31, (3, p.n0 + 1), dtype=torch.int32, device=dev)
    b_til, a_til = BR.rotation_exponents(ct, p)
    before = _count("k4.launches")
    out = BR.blind_rotate(ct, tv, bsk, p, bsk_mb=bsk_mb)
    assert _count("k4.launches") == before + 1
    assert torch.equal(out, BR.blind_rotate_mb_plain(b_til, a_til, tv, bsk_mb, p))
    saved = PC.config.step_impl
    PC.config.step_impl = "pallas"
    try:
        before = _count("k5.launches")
        out = BR.blind_rotate(ct, tv, bsk, p)
        assert _count("k5.launches") == before + p.n0
    finally:
        PC.config.step_impl = saved
    assert torch.equal(out, BR.blind_rotate_plain(b_til, a_til, tv, bsk, p))


def test_fused_small_mb_without_multibit_key_launches_the_whole_rotation(dev):
    """step_impl="fused_small_mb" with no multi-bit key takes the standard
    rotation, as the JAX package falls through to its CMUX scan: K1 once,
    K4 never, equal to the plain version; with a multi-bit key the same
    batch still takes K4."""
    p = P.TEST_TINY
    _, _, tv, bsk_mb = _mb_inputs(dev, p, 8, False, seed=62)
    _, _, _, bsk = _inputs(dev, p, 8, False, seed=63)
    ct = torch.randint(-(1 << 31), 1 << 31, (8, p.n0 + 1), dtype=torch.int32, device=dev)
    b_til, a_til = BR.rotation_exponents(ct, p)
    saved = PC.config.step_impl
    PC.config.step_impl = "fused_small_mb"
    try:
        before = _count("k1.launches"), _count("k4.launches")
        out = BR.blind_rotate(ct, tv, bsk, p)
        torch.cuda.synchronize()
        assert (_count("k1.launches"), _count("k4.launches")) == (before[0] + 1, before[1])
        out_mb = BR.blind_rotate(ct, tv, bsk, p, bsk_mb=bsk_mb)
        torch.cuda.synchronize()
        assert (_count("k1.launches"), _count("k4.launches")) == (before[0] + 1, before[1] + 1)
    finally:
        PC.config.step_impl = saved
    assert torch.equal(out, BR.blind_rotate_plain(b_til, a_til, tv, bsk, p))
    assert torch.equal(out_mb, BR.blind_rotate_mb_plain(b_til, a_til, tv, bsk_mb, p))


def test_xla_route_runs_the_plain_rotation_on_the_card(dev):
    """step_impl="xla" runs blind_rotate_plain on a CUDA tensor, with a
    standard and with a multi-bit key at a batch "auto" sends to the
    multi-bit kernel, and launches neither rotation kernel."""
    p = P.TEST_TINY
    _, _, tv, bsk_mb = _mb_inputs(dev, p, 2, False, seed=60)
    _, _, _, bsk = _inputs(dev, p, 2, False, seed=61)
    ct = torch.randint(-(1 << 31), 1 << 31, (2, p.n0 + 1), dtype=torch.int32, device=dev)
    b_til, a_til = BR.rotation_exponents(ct, p)
    ref = BR.blind_rotate_plain(b_til, a_til, tv, bsk, p)
    saved = PC.config.step_impl
    PC.config.step_impl = "xla"
    try:
        before = _count("k1.launches"), _count("k4.launches")
        outs = [BR.blind_rotate(ct, tv, bsk, p), BR.blind_rotate(ct, tv, bsk, p, bsk_mb=bsk_mb)]
        torch.cuda.synchronize()
        assert (_count("k1.launches"), _count("k4.launches")) == before
    finally:
        PC.config.step_impl = saved
    assert all(out.is_cuda and torch.equal(out, ref) for out in outs)


def test_new_wrappers_reject_what_the_kernels_do_not_take(dev):
    p = P.TEST_TINY
    b_til, a_til, tv, bsk_mb = _mb_inputs(dev, p, 4, False, seed=52)
    with pytest.raises(ValueError, match="shape"):
        CMB.blind_rotate_mb_kernel(b_til, a_til, tv, bsk_mb[:-1].contiguous(), p)
    with pytest.raises(ValueError, match="on cpu"):
        CMB.blind_rotate_mb_kernel(b_til, a_til, tv, bsk_mb.cpu(), p)
    d, t = _step_inputs(dev, p, 4, seed=53)
    with pytest.raises(TypeError):
        CS.external_product_kernel(d.to(torch.int64), t, p)
    with pytest.raises(ValueError, match="contiguous"):
        CS.external_product_kernel(d.transpose(0, 1).contiguous().transpose(0, 1), t, p)
    with pytest.raises(RuntimeError, match="launch failed"):  # the column split is 1 or 8
        CS.external_product_kernel(d, t, p, tile=1, split=4)


def test_step_kernel_digit_contract(dev):
    """The tensor-core instance keeps a digit's low byte: digits in the
    gadget's range are exact, a digit outside s8 is outside the wrapper's
    contract, and `check_digit_range` is the refusal for a caller that
    cannot vouch for its digits."""
    p = P.SECURITY_128_BIT_FAST  # bgbit 8: the digit range is all of s8
    d, t = _extremes(p, *_step_inputs(dev, p, 9, seed=54))
    CS.check_digit_range(d, p)
    assert torch.equal(CS.external_product_kernel(d, t, p), polymul_small_by_torus(d, t, p.trgsw_lv1.half_bg))
    d[3, 1, 7] = p.trgsw_lv1.half_bg  # 128 does not fit s8
    with pytest.raises(ValueError, match="outside"):
        CS.check_digit_range(d, p)
    d[3, 1, 7] = -p.trgsw_lv1.half_bg - 1
    with pytest.raises(ValueError, match="outside"):
        CS.check_digit_range(d, p)


@pytest.mark.parametrize(
    "name,rows",
    [("TEST_TINY", 11), ("SECURITY_128_BIT_FAST", 1), ("SECURITY_128_BIT_FAST", 8), ("SECURITY_128_BIT", 8),
     ("SECURITY_128_BIT_RADIX", 16), ("SECURITY_UINT4", 8)],
)
def test_step_kernel_every_gadget_row_count(dev, name, rows):
    """K5 at every J from 1 to 2L (a tensor-parallel shard's 2L/tp rows, odd
    J included): the kernel equals the plain product on the first J rows,
    on both units, and counts its J."""
    p = getattr(P, name)
    d, t = _extremes(p, *_step_inputs(dev, p, rows, seed=90 + rows))
    for j in range(1, 2 * p.trgsw_lv1.l + 1):
        dj, tj = d[:, :j].contiguous(), t[:j].contiguous()
        before = profiling.counters()
        out = CS.external_product_kernel(dj, tj, p)
        torch.cuda.synchronize()
        (key,) = _launched(before, "k5.instance").keys()
        assert key[-1] == j
        assert torch.equal(out, polymul_small_by_torus(dj, tj, p.trgsw_lv1.half_bg)), j


def test_step_kernel_refuses_row_counts_outside_1_to_2l(dev):
    p = P.TEST_TINY
    d, t = _step_inputs(dev, p, 4, seed=97)
    with pytest.raises(ValueError, match="1 <= J"):
        CS.external_product_kernel(d[:, :0].contiguous(), t[:0].contiguous(), p)
    with pytest.raises(ValueError, match="1 <= J"):
        CS.external_product_kernel(torch.cat([d, d[:, :1]], 1), torch.cat([t, t[:1]]), p)
    with pytest.raises(ValueError, match="shape"):  # digits and key disagree on J
        CS.external_product_kernel(d[:, :2].contiguous(), t[:3].contiguous(), p)


def _nussbaumer_dot_case(dev, batch, k):
    """P1's s16 unit at a Nussbaumer shape, [B, K] x [K, 1024] for each of 16
    DFT points: counted under its own name and its shape, equal to the plain
    dot."""
    from rs_tfhe_tpu_torch.ops import nussbaumer as NU

    lhs = _plant_extremes(_rand(dev, (16, batch, k), torch.int16, 98))
    bop = _plant_extremes(_rand(dev, (16, k, 1024), torch.int16, 99))
    before, shapes = _count(f"probes.launches.{NU.DOT_NAME}"), profiling.counters()
    out = NU.pointwise_dot(lhs, bop)
    torch.cuda.synchronize()
    assert _count(f"probes.launches.{NU.DOT_NAME}") == before + 16
    assert _launched(shapes, "nussbaumer.shape") == {(batch, k, 1024): 16}
    assert torch.equal(out, torch.stack([CP.dot_plain(lhs[t], bop[t]) for t in range(16)]))


@pytest.mark.parametrize("batch", [1, 8])
def test_nussbaumer_pointwise_dot_at_fast_shape(dev, batch):
    """SECURITY_128_BIT_FAST: [B, 512] x [512, 1024] a point."""
    _nussbaumer_dot_case(dev, batch, 512)


@pytest.mark.parametrize("batch", [1, 8])
def test_nussbaumer_pointwise_dot_at_strict_shape(dev, batch):
    """SECURITY_128_BIT (2L = 6): [B, 768] x [768, 1024] a point."""
    _nussbaumer_dot_case(dev, batch, 768)


def test_nussbaumer_step_and_parallel_paths_on_the_card(dev):
    """TEST_TINY on the card: the Nussbaumer step equals the plain product;
    a NAND under step_impl="nussbaumer", the data-parallel NAND on a mesh of
    the card repeated and the tensor-parallel NAND (J = 3 a shard) equal the
    single-device NAND."""
    from rs_tfhe_tpu_torch import gates, key, parallel, tlwe
    from rs_tfhe_tpu_torch.ops import nussbaumer as NU

    p = P.TEST_TINY
    d, t = _extremes(p, *_step_inputs(dev, p, 5, seed=100))
    out = NU.external_product_step(d, NU.prepare_bsk_step(t, p), p)
    assert torch.equal(out, polymul_small_by_torus(d, t, p.trgsw_lv1.half_bg))
    g = torch.Generator(device=dev).manual_seed(101)
    sk = key.SecretKey.generate(p, g)
    ck = key.CloudKey.generate(sk, g)
    a = tlwe.lwe_encrypt_bool(g, sk.lv0, [True, False, True, False], p.tlwe_lv0.alpha)
    b = tlwe.lwe_encrypt_bool(g, sk.lv0, [True, True, False, False], p.tlwe_lv0.alpha)
    single = gates.nand(a, b, ck)
    saved = PC.config.step_impl
    PC.config.step_impl = "nussbaumer"
    try:
        assert torch.equal(gates.nand(a, b, ck), single)
    finally:
        PC.config.step_impl = saved
    assert torch.equal(parallel.data_parallel_gate("nand", a, b, ck, parallel.make_mesh(2, devices=[dev] * 2)),
                       single)
    before = _count("k5.launches")
    mesh = parallel.make_mesh(2, tp=2, devices=[dev] * 2)
    assert torch.equal(parallel.tensor_parallel_gate("nand", a, b, ck, mesh), single)
    assert _count("k5.launches") == before + 2 * p.n0


# ---------------------------------------------------------------------------
# The probe and primitive-rate kernels (csrc/probes.cu)
# ---------------------------------------------------------------------------

_INT_RANGE = {torch.int8: (-128, 128), torch.int16: (-(1 << 15), 1 << 15), torch.int32: (-(1 << 31), 1 << 31)}


def _rand(dev, shape, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    lo, hi = _INT_RANGE[dtype]
    return torch.randint(lo, hi, shape, generator=g, dtype=dtype, device=dev)


@pytest.mark.parametrize("dtype", list(_INT_RANGE), ids=["s8", "s16", "s32"])
@pytest.mark.parametrize("shape", [(128, 1024, 256), (80, 48, 72)], ids=["probe_shape", "ragged"])
def test_probe_dot_matches_plain(dev, dtype, shape):
    """Full-range, non-symmetric operands: a wrong mma lane map would give a
    permuted product, and ones would hide it."""
    m, k, n = shape
    a, b = _rand(dev, (m, k), dtype, 60), _rand(dev, (k, n), dtype, 61)
    before = _count("probes.launches.probe_dot")
    out = CP.probe_dot(a, b)
    torch.cuda.synchronize()
    assert _count("probes.launches.probe_dot") == before + 1
    assert torch.equal(out, CP.dot_plain(a, b))
    assert torch.equal(out.cpu(), CP.dot_plain(a.cpu(), b.cpu()))


@pytest.mark.parametrize(
    "shape", [(80, 48, 72), (129, 16, 257), (256, 1040, 384), (1024, 1024, 1024)],
    ids=lambda s: "x".join(map(str, s)),
)
def test_probe_dot_s8_tile_edges(dev, shape):
    """The tensor-core tile at shapes that straddle its 128 x 128 tile and
    its 128-byte stage (k below one stage, one row and column past a tile, a
    partial last stage), and one that fills the card; full-range operands
    with both extremes, since a wrong fragment or swizzle map permutes."""
    m, k, n = shape
    a, b = _rand(dev, (m, k), torch.int8, 72), _rand(dev, (k, n), torch.int8, 73)
    a[0, :2] = torch.tensor([-128, 127], dtype=torch.int8)
    b[:2, -1] = torch.tensor([-128, 127], dtype=torch.int8)
    before = _count("probes.launches.probe_dot")
    out = CP.probe_dot(a, b)
    torch.cuda.synchronize()
    assert _count("probes.launches.probe_dot") == before + 1
    assert torch.equal(out, CP.dot_plain(a, b))


def _plant_extremes(x):
    """The type's minimum, maximum and -1 (all bits set) in the first row
    and the last column: 0x8000 / 0x7FFF / 0xFFFF, 0x80000000 / 0x7FFFFFFF /
    0xFFFFFFFF."""
    info = torch.iinfo(x.dtype)
    ext = torch.tensor([info.min, info.max, -1], dtype=x.dtype)[: min(3, x.numel())]
    x.view(-1)[: len(ext)] = ext.to(x.device)
    x[-1, -1] = info.min
    return x


@pytest.mark.parametrize(
    "dtype,shape",
    [(dt, sh) for dt in (torch.int16, torch.int32)
     for sh in [(80, 48, 72), (129, 17, 257), (256, 1040, 384), (5, 1, 7), (128, 1024, 256), (1024, 1024, 1024)]]
    + [(torch.int32, (4096, 4096, 4096))],
    ids=lambda v: str(v).removeprefix("torch.") if isinstance(v, torch.dtype) else "x".join(map(str, v)),
)
def test_probe_dot_limbs_matches_plain(dev, dtype, shape):
    """The byte-limb dot on the tensor cores at shapes that straddle the
    128 x 128 tile, with K no multiple of 16 (the planes' zero fill) or of
    the 128-byte stage, K = 1, the probe shape (fewer tiles than SMs: the
    split instance, partials added by reductions) and shapes whose tiles
    fill the card (the in-tile instance, Horner's recombination); full-range
    operands with both extremes and -1 planted."""
    m, k, n = shape
    a, b = _plant_extremes(_rand(dev, (m, k), dtype, 76)), _plant_extremes(_rand(dev, (k, n), dtype, 77))
    before = _count("probes.launches.probe_dot")
    out = CP.probe_dot(a, b)
    torch.cuda.synchronize()
    assert _count("probes.launches.probe_dot") == before + 1
    assert torch.equal(out, CP.dot_plain(a, b))


@pytest.mark.parametrize("dtype", list(_INT_RANGE), ids=["s8", "s16", "s32"])
def test_probe_dot_wraps_mod_2_32(dev, dtype):
    before = _count("probes.launches.probe_dot_correct_s16")
    CP.probe_dot_correct_s16(dev, dtype)
    assert _count("probes.launches.probe_dot_correct_s16") == before + 1


@pytest.mark.parametrize("dtype", list(_INT_RANGE), ids=["int8", "int16", "int32"])
@pytest.mark.parametrize("shift", [5, 0, 255, -3, 300])
def test_probe_roll_matches_plain(dev, dtype, shift):
    x = _rand(dev, (8, 256), dtype, 62)
    out = CP.probe_roll(x, shift)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.roll(x, shift, dims=1))


#: The roll kernel's edges (tests/test_torch_probes.py): no shift, one
#: element, around a 16-byte vector, the last column, past a turn, negative.
_EDGE_SHIFTS = (0, 1, 15, 16, 17, "C-1", "C+3", -3)


def _shift(shift, cols):
    return {"C-1": cols - 1, "C+3": cols + 3}.get(shift, shift)


def _roll_matches(x, shift):
    before = _count("probes.launches.probe_roll")
    out = CP.probe_roll(x, shift)
    torch.cuda.synchronize()
    assert _count("probes.launches.probe_roll") == before + 1
    assert torch.equal(out, CP.roll_plain(x, shift))


@pytest.mark.parametrize("shift", _EDGE_SHIFTS, ids=str)
@pytest.mark.parametrize("shape", [(3, 1), (3, 3), (3, 17), (3, 1000), (8192, 1024), (2, 16384)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", list(_INT_RANGE), ids=["int8", "int16", "int32"])
def test_probe_roll_every_row_shape(dev, dtype, shape, shift):
    """Rows of one element and rows whose byte length is no multiple of 16
    (each row then begins off the 16-byte grid), the FAST accumulator's
    [8192, 1024], and rows of 16384 columns (int32: 64 KB, past the 48 KB a
    row could take when it was staged in shared memory); full-range words."""
    _roll_matches(_rand(dev, shape, dtype, 80 + shape[1]), _shift(shift, shape[1]))


@pytest.mark.parametrize("shift", [0, 5, 16, 1000])
@pytest.mark.parametrize("offset", [1, 2, 3, 5])
@pytest.mark.parametrize("dtype", list(_INT_RANGE), ids=["int8", "int16", "int32"])
def test_probe_roll_any_base(dev, dtype, offset, shift):
    """A contiguous input `offset` elements past an aligned allocation, so
    neither its base nor its rows lie on the 16-byte grid."""
    for rows, cols in ((8, 256), (5, 1000), (3, 17)):
        flat = _rand(dev, (rows * cols + offset,), dtype, 90 + offset)
        x = flat[offset:].view(rows, cols)
        assert x.data_ptr() % 16 and x.is_contiguous()
        _roll_matches(x, shift % cols)


def _bitcast_matches(x):
    before = _count("probes.launches.probe_bitcast_i32_to_i8")
    out = CP.probe_bitcast_i32_to_i8(x)
    torch.cuda.synchronize()
    assert _count("probes.launches.probe_bitcast_i32_to_i8") == before + 1
    assert torch.equal(out, CP.bitcast_i32_to_i8_plain(x))
    assert torch.equal(out, x.view(torch.int8))


@pytest.mark.parametrize("rows_first", [False, True], ids=["one_row", "one_column"])
@pytest.mark.parametrize("count", [1, 3, 5, 255, 257])
def test_probe_bitcast_every_count(dev, count, rows_first):
    """Word counts that leave a partial 16-byte vector (or none at all), with
    0x80000000 and 0xFFFFFFFF among full-range words."""
    x = _rand(dev, (count,), torch.int32, 100 + count)
    x[0], x[-1] = -(1 << 31), -1
    _bitcast_matches(x.view((count, 1) if rows_first else (1, count)))


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_probe_bitcast_any_base(dev, offset):
    """An input `offset` words past an aligned allocation: its 16-byte input
    windows straddle two aligned vectors."""
    for rows, cols in ((8, 256), (3, 5), (1, 1)):
        x = _rand(dev, (rows * cols + offset,), torch.int32, 110 + offset)[offset:].view(rows, cols)
        assert x.data_ptr() % 16
        _bitcast_matches(x)


def test_probe_bitcast_fast_key_size(dev):
    """Full-range words in the shape of the FAST cloud key's bsk
    ([n0, 2L, 2, N] = [700, 4, 2, 1024]) viewed as [5600, 1024]."""
    p = P.SECURITY_128_BIT_FAST
    bsk = _rand(dev, (p.n0, 2 * p.trgsw_lv1.l, 2, p.n1), torch.int32, 120)
    _bitcast_matches(bsk.view(-1, p.n1))


def _unpack_matches(x):
    before = _count("probes.launches.probe_unpack_s16")
    lo, hi = CP.probe_unpack_s16(x)
    torch.cuda.synchronize()
    assert _count("probes.launches.probe_unpack_s16") == before + 1
    plo, phi = CP.unpack_s16_plain(x)
    assert torch.equal(lo, plo) and torch.equal(hi, phi)


@pytest.mark.parametrize("rows_first", [False, True], ids=["one_row", "one_column"])
@pytest.mark.parametrize("count", [1, 7, 9, 8 * 1000 + 3])
def test_probe_unpack_every_count(dev, count, rows_first):
    """Word counts that leave a partial 8-word vector (the scalar tail), as
    one row or one column, with the extremes among the words."""
    x = _plant_extremes(_rand(dev, (count, 1) if rows_first else (1, count), torch.int32, 78 + count))
    _unpack_matches(x)


def test_probe_unpack_fast_key_size(dev):
    """Full-range words in the shape of the FAST cloud key's bsk as
    [5600, 1024]: every vector on the streaming path."""
    p = P.SECURITY_128_BIT_FAST
    _unpack_matches(_rand(dev, (p.n0 * 2 * p.trgsw_lv1.l * 2, p.n1), torch.int32, 121))


def test_probe_bitcast_and_unpack_match_plain(dev):
    x = _rand(dev, (8, 256), torch.int32, 63)
    out = CP.probe_bitcast_i32_to_i8(x)
    lo, hi = CP.probe_unpack_s16(x)
    torch.cuda.synchronize()
    assert torch.equal(out, CP.bitcast_i32_to_i8_plain(x))
    assert torch.equal(out, x.view(torch.int8))
    plo, phi = CP.unpack_s16_plain(x)
    assert torch.equal(lo, plo) and torch.equal(hi, phi)


@pytest.mark.parametrize("unit", ["tensor", "imad"])
@pytest.mark.parametrize(
    "shape", [(128, 128, 128), (128, 1024, 1024), (256, 1024, 512), (1024, 1024, 128), (128, 256, 1024)],
    ids=lambda s: "x".join(map(str, s)),
)
def test_chain_dot_matches_plain(dev, shape, unit):
    """Both feedback folds (N >= K and N dividing K), the small and the big
    (8-row column sums) form, on random operands."""
    m, k, n = shape
    a0, b = _rand(dev, (m, k), torch.int8, 64), _rand(dev, (k, n), torch.int8, 65)
    before = _count("probes.launches.chain_dot")
    res = CP.chain_dot(a0, b, 5, unit=unit)
    torch.cuda.synchronize()
    assert _count("probes.launches.chain_dot") == before + 1
    acc, fb = CP.chain_dot_plain(a0, b, 5)
    assert torch.equal(res.acc, acc)
    assert torch.equal(res.fb, fb)
    cycles, sms, busiest = res.tile_loop()
    assert cycles > 0 and 0 < sms <= torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = CP.dot_tiles(m, n, unit)
    assert 5 * tiles / sms <= busiest <= 5 * tiles


@pytest.mark.parametrize("shape", [(2048, 512, 2048), (1024, 256, 4096)], ids=["big", "small_form"])
def test_chain_dot_tensor_more_tiles_than_sms(dev, shape):
    """Each resident block walks several tensor-core tiles a step, in the big
    (8-row column sums) and the small feedback form; 5 steps, because a lhs
    the copies read stale (a missing proxy fence) shows only from step 2 on.
    Every tile of every step is counted on some SM."""
    m, k, n = shape
    a0, b = _rand(dev, (m, k), torch.int8, 74), _rand(dev, (k, n), torch.int8, 75)
    tiles = CP.dot_tiles(m, n, "tensor")
    assert tiles > torch.cuda.get_device_properties(dev).multi_processor_count
    assert CP.chain_shape(m, k)[0] == (shape == (2048, 512, 2048))
    before = _count("probes.launches.chain_dot")
    res = CP.chain_dot(a0, b, 5, unit="tensor")
    torch.cuda.synchronize()
    assert _count("probes.launches.chain_dot") == before + 1
    acc, fb = CP.chain_dot_plain(a0, b, 5)
    assert torch.equal(res.acc, acc)
    assert torch.equal(res.fb, fb)
    assert int(res.stats[1:].sum()) == 5 * tiles
    assert res.blocks < tiles


@pytest.mark.parametrize("reps", [3, 0])
@pytest.mark.parametrize("shape", [(128, 1024), (128, 128), (8, 1024), (256, 2048), (3, 17),
                                   (1, 32), (5, 64), (2, 2080), (1, 6144), (601, 256), (301, 512)])
def test_chain_roll_add_matches_plain(dev, shape, reps):
    """Random input (with ones the chain doubles each step and is 0 mod 2^32
    after 32 of them), 0x80000000 and 0xFFFFFFFF planted, on the instance the
    shape selects: the register instance at each instantiated width (32 to
    2048 words), the shared-memory one (0) at the others."""
    x = _rand(dev, shape, torch.int32, 66)
    x[0, :2] = torch.tensor([-(1 << 31), -1], dtype=torch.int32)
    words = CP.roll_add_words(shape[1])
    assert (words > 0) == (shape[1] in (32, 64, 128, 256, 512, 1024, 2048))
    before = profiling.counters()
    out = CP.chain_roll_add(x, reps)
    torch.cuda.synchronize()
    assert _launched(before, "probes.roll_add.instance") == {(words,): 1}
    assert torch.equal(out, CP.chain_roll_add_plain(x, reps))


def test_probe_wrappers_reject_what_the_kernels_do_not_take(dev):
    a, b = _rand(dev, (16, 24), torch.int8, 67), _rand(dev, (24, 16), torch.int8, 68)
    with pytest.raises(ValueError, match="multiple of 16"):
        CP.probe_dot(a, b)
    with pytest.raises(TypeError):
        CP.probe_dot(a, b.to(torch.int16))
    with pytest.raises(ValueError, match="on cpu"):
        CP.probe_dot(a, b.cpu())
    with pytest.raises(ValueError, match="feedback"):
        CP.chain_dot(_rand(dev, (16, 48), torch.int8, 69), _rand(dev, (48, 32), torch.int8, 70), 1)
    with pytest.raises(TypeError):
        CP.probe_bitcast_i32_to_i8(a)
    with pytest.raises(ValueError, match="contiguous"):
        CP.probe_roll(_rand(dev, (8, 16), torch.int32, 71).t())


# ---------------------------------------------------------------------------
# The small-batch key switch (csrc/key_switch.cu) against the one-hot product
# ---------------------------------------------------------------------------

_FAST = P.SECURITY_128_BIT_FAST
#: name -> (n_in, t, basebit, out_width, ciphertext width, first mask column):
#: the key-switching tables of FAST and strict (the same shape), a proxy
#: re-key table of basebit 6 and t 3 (lv0 -> lv0), and the second of two
#: tensor-parallel column shards of the FAST table (no body: the plain sum)
_KS_SHAPES = {
    **{name: (p.n1, p.trgsw_lv1.iks_t, p.trgsw_lv1.basebit, p.n0 + 1, p.n1 + 1, 0)
       for name, p in (("SECURITY_128_BIT_FAST", _FAST), ("SECURITY_128_BIT", P.SECURITY_128_BIT))},
    "rekey_b6_t3": (_FAST.n0, 3, 6, _FAST.n0 + 1, _FAST.n0 + 1, 0),
    "shard_tp2": (_FAST.n1 // 2, _FAST.trgsw_lv1.iks_t, _FAST.trgsw_lv1.basebit, _FAST.n0 + 1, _FAST.n1 + 1,
                  _FAST.n1 // 2),
}
_KS_TABLES = {}


def _ks_table(dev, name):
    """Random limbs (every byte value), with the key's own limbs of the words
    0x80000000 and 0xFFFFFFFF planted in the digit-0 and digit-(base-1) rows
    of every fifth row group; built once a shape."""
    if name not in _KS_TABLES:
        n_in, t, basebit, out_width, _, _ = _KS_SHAPES[name]
        base = 1 << basebit
        g = torch.Generator(device=dev).manual_seed(len(_KS_TABLES) + 300)
        table = torch.randint(-128, 128, (n_in * t * base, 4 * limb_width(out_width)), generator=g,
                              dtype=torch.int8, device=dev)
        words = torch.tensor([[-(1 << 31)], [-1]], dtype=torch.int32, device=dev).expand(2, out_width)
        planted = planar_limbs(words.contiguous())
        groups = torch.arange(0, n_in * t, 5, device=dev) * base
        table[groups] = planted[0]
        table[groups + base - 1] = planted[1]
        _KS_TABLES[name] = table
    return _KS_TABLES[name]


def _ks_ciphertexts(dev, name, batch, kind, seed):
    """int32 [batch, width]: random words with 0x80000000 and 0xFFFFFFFF
    planted in the masks and the bodies, or masks whose digits are all 0 or
    all base-1."""
    _, t, basebit, _, width, _ = _KS_SHAPES[name]
    g = torch.Generator(device=dev).manual_seed(seed)
    ct = torch.randint(-(1 << 31), 1 << 31, (batch, width), generator=g, dtype=torch.int32, device=dev)
    offset = 1 << (31 - basebit * t)
    if kind == "digits_0":
        ct[:, :-1] = -offset  # a + offset = 0
    elif kind == "digits_max":
        ct[:, :-1] = -1 - offset  # a + offset = 0xFFFFFFFF
    else:
        ct[0, :2] = torch.tensor([-(1 << 31), -1], dtype=torch.int32)
        ct[-1, -2:] = torch.tensor([-1, -(1 << 31)], dtype=torch.int32)
    return ct


def _ks_product(a, body, table, t, basebit, out_width):
    """The plain version: the one-hot product on the card."""
    ref = KS._product_sum(a, table, t, basebit, out_width)
    if body is None:
        return ref
    ref = -ref
    ref[..., out_width - 1] += body
    return ref


@pytest.mark.parametrize("kind", ["random", "digits_0", "digits_max"])
@pytest.mark.parametrize("batch", [1, 2, 3, 16, "cap", "cap+1"])
@pytest.mark.parametrize("name", list(_KS_SHAPES))
def test_key_switch_select_matches_product(dev, name, batch, kind):
    """Through `digit_select_subtract` (`digit_select_sum` for the shard),
    as every caller goes: up to the cap the selection kernel, equal to the
    one-hot product bit for bit, with the route's counters and one launch;
    one above the cap the product. The masks are `ct[..., :n]`, not copied."""
    n_in, t, basebit, out_width, _, start = _KS_SHAPES[name]
    cap = KS.KS_SELECT_MAX_BATCH
    batch = {"cap": cap, "cap+1": cap + 1}.get(batch, batch)
    table = _ks_table(dev, name)
    ct = _ks_ciphertexts(dev, name, batch, kind, seed=batch)
    a = ct[..., start:start + n_in]
    assert batch == 1 or not a.is_contiguous()
    body = None if name == "shard_tp2" else ct[..., -1]
    before = profiling.counters()
    if body is None:
        out = KS.digit_select_sum(a, table, t, basebit, out_width)
    else:
        out = KS.digit_select_subtract(a, body, table, t, basebit, out_width)
    torch.cuda.synchronize()
    route = "select" if batch <= cap else "product"
    expect = {f"keyswitch.route.{route}.calls": 1, f"keyswitch.route.{route}.ciphertexts": batch}
    if route == "select":
        expect.update({"ks.launches": 1, f"ks.instance.{min(16, 1 << (batch - 1).bit_length())}": 1})
    assert _moved(before) == expect
    assert out.shape == (batch, out_width) and out.dtype == torch.int32
    assert torch.equal(out, _ks_product(a, body, table, t, basebit, out_width))


@pytest.mark.parametrize("batch", [5, 17, 100, 512])
def test_key_switch_kernel_every_block_batch(dev, batch):
    """The kernel called directly past the cap too (the sweep's batches):
    blocks of 8 and of 16 ciphertexts, a ragged last block, several blocks
    on one slice of row groups."""
    name = "SECURITY_128_BIT_FAST"
    n_in, t, basebit, out_width, _, _ = _KS_SHAPES[name]
    table = _ks_table(dev, name)
    ct = _ks_ciphertexts(dev, name, batch, "random", seed=1000 + batch)
    a, body = ct[..., :n_in], ct[..., -1]
    out = CKS.digit_select_kernel(a, body, table, t, basebit, out_width)
    torch.cuda.synchronize()
    assert torch.equal(out, _ks_product(a, body, table, t, basebit, out_width))


def test_key_switch_keeps_leading_dimensions_and_the_key_switch_path(dev):
    """[2, 3, N+1] ciphertexts through `identity_key_switch` (a batch of 6
    on the kernel) equal the product; a single ciphertext [N+1] too."""
    p = _FAST
    name = "SECURITY_128_BIT_FAST"
    table = _ks_table(dev, name)
    ct = _ks_ciphertexts(dev, name, 6, "random", seed=77).reshape(2, 3, -1)
    before = profiling.counters()
    out = KS.identity_key_switch(ct, table, p)
    one = KS.identity_key_switch(ct[1, 2], table, p)
    torch.cuda.synchronize()
    assert _moved(before) == {"keyswitch.route.select.calls": 2, "keyswitch.route.select.ciphertexts": 7,
                                 "ks.launches": 2, "ks.instance.8": 1, "ks.instance.1": 1}
    g = p.trgsw_lv1
    ref = _ks_product(ct[..., :p.n1], ct[..., p.n1], table, g.iks_t, g.basebit, p.n0 + 1)
    assert out.shape == (2, 3, p.n0 + 1) and torch.equal(out, ref)
    assert one.shape == (p.n0 + 1,) and torch.equal(one, ref[1, 2])


def test_key_switch_wrapper_rejects_what_the_kernel_does_not_take(dev):
    name = "SECURITY_128_BIT_FAST"
    n_in, t, basebit, out_width, _, _ = _KS_SHAPES[name]
    table = _ks_table(dev, name)
    ct = _ks_ciphertexts(dev, name, 2, "random", seed=5)
    a, body = ct[..., :n_in], ct[..., -1]
    with pytest.raises(TypeError):
        CKS.digit_select_kernel(a.to(torch.int64), body, table, t, basebit, out_width)
    with pytest.raises(TypeError):
        CKS.digit_select_kernel(a, body, table.cpu(), t, basebit, out_width)
    with pytest.raises(ValueError, match="does not fit"):
        CKS.digit_select_kernel(a[..., :-1], body, table, t, basebit, out_width)
    with pytest.raises(ValueError, match="does not fit"):
        CKS.digit_select_kernel(a, body, table, t, basebit, limb_width(out_width) + 1)
    with pytest.raises(ValueError, match="body"):
        CKS.digit_select_kernel(a, body[:1], table, t, basebit, out_width)
