"""PyTorch port: the limb formulation of the negacyclic product (the
arithmetic of csrc/negacyclic_mma.cuh), the accumulator bound that decides
which parameter sets take the tensor cores, and the choice of the kernels'
instances from the batch. No GPU needed: the formulation is stated in plain
PyTorch (`cuda_step.limb_product_plain`) and held bit for bit (tolerance 0)
against the port's plain product and against the TPU kernel K5
`fused_external_product` in interpret mode; the kernels themselves are held
against the plain versions on the card in tests/test_torch_kernel_gpu.py."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rs_tfhe_tpu.ops.pallas_step import fused_external_product  # noqa: E402
from rs_tfhe_tpu.ops.poly import negacyclic_extend  # noqa: E402
from rs_tfhe_tpu.torus import split_u32_limbs  # noqa: E402
from rs_tfhe_tpu_torch import _build  # noqa: E402
from rs_tfhe_tpu_torch import params as P  # noqa: E402
from rs_tfhe_tpu_torch.ops import cuda_blind_rotate as CBR  # noqa: E402
from rs_tfhe_tpu_torch.ops import cuda_launch as CL  # noqa: E402
from rs_tfhe_tpu_torch.ops import cuda_step as CS  # noqa: E402
from rs_tfhe_tpu_torch.ops.poly import polymul_small_by_torus  # noqa: E402
from rs_tfhe_tpu_torch.torus import to_numpy, to_torch  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port: the suite runs six workers on the
    machine's cores, and torch's default of a thread a core oversubscribes
    them (the JAX side keeps its own pool)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_SETS = {**P.ALL_SECURITY_SETS, "TEST_TINY": P.TEST_TINY}


def _operands(p, rows, seed):
    """Digits over their whole range with its ends, full-range key words with
    0x80000000, 0xFFFFFFFF and 0 among them."""
    g, n = p.trgsw_lv1, p.n1
    rng = np.random.default_rng(seed)
    d = rng.integers(-g.half_bg, g.half_bg, (rows, 2 * g.l, n)).astype(np.int32)
    d[0, :, ::3], d[-1, :, 1::2] = -g.half_bg, g.half_bg - 1
    t = rng.integers(0, 1 << 32, (2 * g.l, 2, n), dtype=np.uint32)
    t[0, 0, ::2], t[-1, 1, ::3], t[0, 1, 5] = 0x80000000, 0xFFFFFFFF, 0
    return torch.from_numpy(d), to_torch(t, "cpu")


@pytest.mark.parametrize("name", ["TEST_TINY", "SECURITY_128_BIT_FAST", "SECURITY_128_BIT", "SECURITY_UINT4"])
def test_limb_product_equals_plain_product(name):
    """Extend, split into bytes, one Toeplitz product per limb, shift and
    add: equal to the plain product mod 2^32. The UINT set's 22-bit digits
    leave s32, so there the limb sums are taken in 64 bits."""
    p = _SETS[name]
    d, t = _operands(p, 2, seed=200)
    single = p.trgsw_lv1.bgbit <= 8
    assert CL.takes_tensor_cores(p) == single
    out = CS.limb_product_plain(d, t, s32=single)
    assert torch.equal(out, polymul_small_by_torus(d, t, p.trgsw_lv1.half_bg))
    if not single:
        with pytest.raises(ValueError, match="leaves s32"):
            CS.limb_product_plain(d, t)


def test_limb_product_equals_k5_fused_external_product():
    """The inputs of test_torch_step.py::test_plain_product_matches_k5_fused_external_product
    (J=4, O=2, N=128, F=128, digits in [-32, 32)) through the TPU kernel in
    interpret mode."""
    rng = np.random.default_rng(100)
    j, o, n, f = 4, 2, 128, 128
    t = rng.integers(0, 1 << 32, (j, o, n), dtype=np.uint32)
    d = rng.integers(-32, 32, (f, j, n)).astype(np.int32)
    xl = jnp.transpose(split_u32_limbs(negacyclic_extend(jnp.asarray(t))), (1, 3, 0, 2))
    k5 = fused_external_product(jnp.asarray(d).astype(jnp.int8).reshape(f, j * n), xl, 2, interpret=True)
    port = CS.limb_product_plain(torch.from_numpy(d), to_torch(t, "cpu"))
    np.testing.assert_array_equal(to_numpy(port), np.asarray(k5))


def test_dropped_limbs_lose_nothing_on_the_grid():
    """A key on the 2^8 grid (bsk_round_bits = 8, as SECURITY_128_BIT_FAST's)
    has a zero lowest byte in every extended word, -p included: three limbs
    give the product; a key off the grid needs all four."""
    p = P.TEST_TINY
    d, t = _operands(p, 3, seed=201)
    on_grid = t & ~0xFF
    ref = polymul_small_by_torus(d, on_grid, p.trgsw_lv1.half_bg)
    assert torch.equal(CS.limb_product_plain(d, on_grid, limbs=3), ref)
    assert not torch.equal(CS.limb_product_plain(d, t, limbs=3), polymul_small_by_torus(d, t, p.trgsw_lv1.half_bg))


@pytest.mark.parametrize("name", sorted(_SETS))
def test_accumulator_bound_decides_the_unit(name):
    """All 15 parameter sets: single-limb digits (bgbit <= 8) keep every s32
    limb sum under 2^31 and take the tensor cores; the UINT sets (bgbit
    10-23) do not."""
    p = _SETS[name]
    g = p.trgsw_lv1
    bound = CL.limb_accumulator_bound(p)
    assert bound == 2 * g.l * p.n1 * (1 << (g.bgbit - 1)) * 255
    if g.bgbit <= 8:
        assert bound < 1 << 31 and CL.takes_tensor_cores(p)
    else:
        assert name.startswith("SECURITY_UINT") and not CL.takes_tensor_cores(p)
    expected = {"SECURITY_128_BIT_FAST": 133_693_440, "SECURITY_128_BIT_NIBBLE": 802_160_640}
    assert bound == expected.get(name, bound)


def test_accumulator_bound_is_reached_and_holds():
    """Every digit -Bg/2 against every byte 255: the limb sum is exactly
    -bound, still inside s32, and the product is still right."""
    p = P.TEST_TINY
    g, n = p.trgsw_lv1, p.n1
    d = torch.full((1, 2 * g.l, n), -g.half_bg, dtype=torch.int32)
    t = torch.full((2 * g.l, 2, n), -1, dtype=torch.int32)  # 0xFFFFFFFF: its +p half is all bytes 255
    out = CS.limb_product_plain(d, t)
    assert torch.equal(out, polymul_small_by_torus(d, t, g.half_bg))
    ext_bytes_255 = n  # column N-1 of the product meets the +p half at every m
    assert 2 * g.l * ext_bytes_255 * g.half_bg * 255 == CL.limb_accumulator_bound(p)


@pytest.mark.parametrize(
    "n,cols,s0,rows,limbs",
    [(64, 64, 0, 16, 4), (64, 32, 32, 8, 4), (64, 32, 0, 8, 3), (1024, 256, 0, 32, 3), (1024, 256, 768, 16, 4),
     (1024, 256, 256, 16, 3)],
)
def test_strip_addressing_equals_the_negacyclic_product(n, cols, s0, rows, limbs):
    """The wgmma instance's operands as `strip_product_plain` addresses them
    (the key limb's Toeplitz operand read at byte (i + 2j) * 128 of the
    diagonal strip, the digits from their core-matrix plane) give the block's
    columns [s0, s0 + cols) of the plain product, bit for bit: digits at both
    ends of their range, key words 0x80000000, 0xFFFFFFFF and 0 planted; a key
    on the 2^8 grid with three limbs."""
    rng = np.random.default_rng(n + s0 + rows)
    d = torch.from_numpy(rng.integers(-128, 128, (rows, n)).astype(np.int32))
    d[0, ::3], d[-1, 1::2] = -128, 127
    p = to_torch(rng.integers(0, 1 << 32, n, dtype=np.uint32), "cpu")
    p[::5], p[1::7], p[2] = -(1 << 31), -1, 0
    if limbs == 3:
        p &= ~0xFF
    ref = polymul_small_by_torus(d[:, None, :], p[None, None, :], 128)[:, 0, s0:s0 + cols]
    assert torch.equal(CBR.strip_product_plain(d, p, s0, cols, limbs), ref)


@pytest.mark.parametrize("rows", [16, 32])
def test_digit_plane_layout(rows):
    """The digit plane the decomposition writes and wgmma reads: every digit
    of [rows, N] at its own byte; 16 digits of a row are one 16-byte word;
    the rows of an 8-row group are consecutive words (a block's rows, pushed
    as consecutive words); planes follow each other as whole 16-digit runs."""
    n = 1024
    rr, m = torch.meshgrid(torch.arange(rows), torch.arange(n), indexing="ij")
    off = CBR.digit_offset(rows, rr, m)
    assert torch.equal(torch.sort(off.reshape(-1)).values, torch.arange(rows * n))
    assert torch.equal(off[:, 1:16] - off[:, :1], torch.arange(1, 16).expand(rows, 15))
    words = off[:, ::16] // 16
    assert torch.equal(words[1:8] - words[:1], torch.arange(1, 8)[:, None].expand(7, n // 16))
    run = torch.arange(4 * n // 16)  # 16-digit runs over four planes
    assert torch.equal(CBR.digit_offset(rows, 0, 16 * run), (run // (n // 16)) * rows * n + CBR.digit_offset(
        rows, 0, 16 * (run % (n // 16))))


def test_strip_product_refuses_shapes_off_its_tiles():
    d = torch.zeros((12, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="rows 12"):
        CBR.strip_product_plain(d, torch.zeros(64, dtype=torch.int32), 0, 64)
    with pytest.raises(ValueError, match="s0=32"):
        CBR.strip_product_plain(torch.zeros((8, 64), dtype=torch.int32), torch.zeros(64, dtype=torch.int32), 32, 64)


def test_tensor_core_unit_names_the_instruction():
    """The launch counter tells the wgmma instance (the one that read the
    key's strips) from the mma.sync one, with the key's limbs."""
    assert CBR.tensor_core_unit(True, 3) == "wgmma_s8x3"
    assert CBR.tensor_core_unit(False, 3) == "mma_s8x3" and CBR.tensor_core_unit(False, 4) == "mma_s8x4"


@pytest.mark.parametrize(
    "n,cluster,bgbit,limbs",
    [(1024, 16, 8, 3), (1024, 16, 8, 4), (1024, 16, 6, 4), (2048, 16, 8, 4), (2048, 16, 6, 3), (1024, 4, 8, 4),
     (1024, 2, 6, 3)],
)
def test_fold_addressing_equals_the_negacyclic_product(n, cluster, bgbit, limbs):
    """The fold's operands as `fold_product_plain` addresses them (16 digit
    rows shifted by 8, the wrapped digits of a row's last 128 in a second
    sum, the key window's reversed byte planes cut as Toeplitz n8 tiles) give
    every block's columns of both output polynomials, summed over the gadget
    rows, bit for bit: digits at both ends of their range (-128 has no s8
    negation), key words 0x80000000, 0xFFFFFFFF and 0xFFFFFF00 planted, a key
    on the 2^8 grid with three limbs."""
    half, rows = 1 << (bgbit - 1), 4 if bgbit == 8 else 6
    rng = np.random.default_rng(n + cluster + bgbit + limbs)
    d = torch.from_numpy(rng.integers(-half, half, (rows, n)).astype(np.int32))
    d[0, ::3], d[-1, 1::2], d[1, n - 128:] = -half, half - 1, -half
    keys = to_torch(rng.integers(0, 1 << 32, (rows, 2, n), dtype=np.uint32), "cpu")
    keys[:, :, ::5], keys[:, :, 1::7], keys[:, :, 2::11] = -(1 << 31), -1, -256
    if limbs == 3:
        keys &= ~0xFF
    ref = polymul_small_by_torus(d, keys, half)
    w = 2 * n // cluster
    for rank in range(cluster):
        o, s0 = rank * w // n, rank * w % n
        assert torch.equal(CL.fold_product_plain(d, keys[:, o], s0, w, limbs), ref[o, s0:s0 + w]), rank


def test_fold_limb_sums_stay_in_s32_at_the_bound():
    """The fold's K is N a gadget row, as the whole product's: at
    `limb_accumulator_bound`'s extreme (every digit -128; key words 1,
    whose negation, the wrapped half of a low column's window, is
    0xFFFFFFFF) its limb sums stay in s32 for the sets that take the tensor
    cores, and the model refuses a product whose sums would not (70 gadget
    rows: 70 * 1024 * 128 * 255 > 2^31)."""
    strict = P.SECURITY_128_BIT
    n, rows = strict.n1, 2 * strict.trgsw_lv1.l
    d = torch.full((rows, n), -128, dtype=torch.int32)
    keys = torch.ones((rows, n), dtype=torch.int32)
    ref = polymul_small_by_torus(d, keys[:, None], 128)[0]
    assert torch.equal(CL.fold_product_plain(d, keys, 0, 128), ref[:128])
    with pytest.raises(ValueError, match="leaves s32"):
        CL.fold_product_plain(torch.full((70, n), -128, dtype=torch.int32), torch.ones((70, n), dtype=torch.int32), 0, 128)


@pytest.mark.parametrize(
    "name,tile,cluster,fold",
    [("SECURITY_128_BIT_FAST", 1, 16, True), ("SECURITY_128_BIT", 1, 16, True), ("SECURITY_128_BIT_RADIX", 1, 16, True),
     ("SECURITY_128_BIT_FAST", 1, 8, True), ("SECURITY_128_BIT_FAST", 1, 2, True), ("SECURITY_128_BIT_FAST", 3, 16, False),
     ("SECURITY_128_BIT", 2, 16, False), ("SECURITY_128_BIT_FAST", 1, 1, False), ("TEST_TINY", 1, 8, False),
     ("SECURITY_UINT1", 1, 16, False), ("SECURITY_UINT4", 1, 16, False)],
)
def test_fold_takes_tiles_of_one_from_1024_with_byte_digits(name, tile, cluster, fold):
    """The wrappers' unit for a (tile, cluster) instance: a tile of one on a
    cluster at N >= 1024 with digits of at most 8 bits takes the fold; a tile
    of three, a single block, N = 64 and digits over 8 bits (UINT1's 10,
    UINT4's 22) keep the CUDA cores (`imad`)."""
    assert CL.takes_fold(_SETS[name], tile, cluster) is fold


def test_fold_unit_in_the_add_cells_plan():
    """On an H100's clusters the plan gives a 16-bit add's B=1 groups (1, 16),
    which the fold takes, and its B=16 groups (3, 16), which keep `imad`; the
    unit names carry the key limbs."""
    for name in ("SECURITY_128_BIT_FAST", "SECURITY_128_BIT", "SECURITY_128_BIT_RADIX"):
        p = _SETS[name]
        assert CBR.rotation_instance(1, 8 if p.n1 == 1024 else 4, CL.H100_CLUSTER_SLOTS, p.n1) == (1, 16)
        assert CL.takes_fold(p, *CBR.rotation_instance(1, 8, CL.H100_CLUSTER_SLOTS, p.n1))
    assert CBR.rotation_instance(16, 8, CL.H100_CLUSTER_SLOTS, 1024) == (3, 16)
    assert not CL.takes_fold(P.SECURITY_128_BIT_FAST, 3, 16)
    assert (CL.fold_unit(3), CL.fold_unit(4)) == ("mma_fold_s8x3", "mma_fold_s8x4")


def test_fold_model_refuses_shapes_off_its_tiles():
    d, p = torch.zeros((2, 1024), dtype=torch.int32), torch.zeros((2, 1024), dtype=torch.int32)
    with pytest.raises(ValueError, match="cols 64"):
        CL.fold_product_plain(d, p, 0, 64)
    with pytest.raises(ValueError, match="N=64"):
        CL.fold_product_plain(d[:, :64], p[:, :64], 0, 128)


def _block_strip(poly: torch.Tensor, s0: int, cols: int, limb: int) -> torch.Tensor:
    """A block's strip built from its own reversed window alone, core by
    core: core delta, row r, byte b is byte `limb` of ext[s0 + cols - 1 + N -
    (8 delta + r + b)]."""
    n = poly.shape[0]
    words = poly.to(torch.int64) & 0xFFFFFFFF
    ext = torch.cat([(-words) & 0xFFFFFFFF, words])
    y = (8 * torch.arange((cols + n) // 8 - 2)[:, None, None] + torch.arange(8)[None, :, None]
         + torch.arange(16)[None, None, :])
    return ((ext[s0 + cols - 1 + n - y] >> (8 * limb)) & 0xFF).reshape(-1).to(torch.uint8)


@pytest.mark.parametrize("n,cols,limbs", [(64, 32, 4), (64, 16, 3), (1024, 256, 3)])
def test_key_strips_hold_every_blocks_strip(n, cols, limbs):
    """`key_strips_plain`'s layout, as the wgmma instance fetches it: the
    strip of (step, gadget row, polynomial, limb) at its unit's offset, and
    in it the block's strip from core matrix (N - cols - s0) / 8 on, equal to
    the block's own strip for every block of the polynomial; extremes planted
    in the key."""
    rng = np.random.default_rng(n + cols + limbs)
    n0, rows2 = 2, 4
    bsk = to_torch(rng.integers(0, 1 << 32, (n0, rows2, 2, n), dtype=np.uint32), "cpu")
    bsk.view(-1)[::7], bsk.view(-1)[3::11], bsk.view(-1)[5::13] = -(1 << 31), -1, 0
    strips = CBR.key_strips_plain(bsk, limbs)
    poly_bytes = (2 * n - 16) * 16
    assert strips.dtype == torch.uint8 and strips.numel() == n0 * rows2 * 2 * limbs * poly_bytes
    block_bytes = ((cols + n) // 8 - 2) * 128
    for i in range(n0):
        for j in range(rows2):
            for o in range(2):
                for k in range(limbs):
                    unit = ((i * rows2 + j) * 2 + o) * limbs + k
                    for s0 in range(0, n, cols):
                        at = unit * poly_bytes + (n - cols - s0) // 8 * 128
                        assert torch.equal(strips[at:at + block_bytes],
                                           _block_strip(bsk[i, j, o], s0, cols, 4 - limbs + k)), (i, j, o, k, s0)


def test_poly_strip_rows_are_the_reversed_bytes():
    """Row x of a polynomial's strip is bytes x .. x + 15 of the limb's
    reversed ext = [-p, p], for leading dimensions too."""
    poly = torch.tensor([[1, -1, -(1 << 31), 0x01020304] * 4, [7] * 16], dtype=torch.int32)
    strip = CBR.poly_strip_plain(poly, 0).reshape(2, 2 * 16 - 16, 16)
    ext = torch.cat([-poly.to(torch.int64), poly.to(torch.int64)], dim=-1) & 0xFF
    rev = ext.flip(-1)
    for x in range(2 * 16 - 16):
        assert torch.equal(strip[:, x].to(torch.int64), rev[:, x:x + 16])
    assert int(strip[0, 0, 0]) == 0x04 and int(strip[0, 0, 1]) == 0 and int(strip[0, 0, 2]) == 0xFF


@pytest.mark.parametrize("name", sorted(_SETS))
def test_step_instance_per_set(name):
    """Single-limb sets take the tensor-core instance at every row count
    (the grid splits the 2N columns 2N/64 ways); the UINT sets the CUDA-core
    instance, with the column split while the rows alone leave SMs idle."""
    p = _SETS[name]
    max_tile = 8 if p.n1 <= 1024 else 8192 // p.n1
    for rows in (1, 8, 131, 132 * 8 - 1, 132 * 8, 4096):
        n, unit, tile, split = CS.step_instance(p, rows, max_tile, 132)
        assert n == p.n1
        if CL.takes_tensor_cores(p):
            assert (unit, tile, split) == ("mma_s8", 128, 2 * p.n1 // 64)
        else:
            assert unit == "imad" and tile in (1, 2, 4, 8)[: max_tile.bit_length()] and split in (1, 8)
            assert (split == 8) == (-(-rows // max_tile) < 132)
            blocks = -(-rows // tile) * split
            assert blocks >= 132 or tile == 1  # the card is full, or no smaller tile is left


@pytest.mark.parametrize("max_tile,n", [(8, 1024), (4, 2048), (2, 4096)], ids=["N<=1024", "N=2048", "N=4096"])
def test_rotation_instance_every_batch(max_tile, n):
    """Every batch in 1..4096 with an H100's cluster slots: the instance is
    one the kernel has, covers the batch, and runs in one wave wherever some
    instance can."""
    slots = CL.H100_CLUSTER_SLOTS
    for batch in range(1, 4097):
        tile, cluster = CBR.rotation_instance(batch, max_tile, slots, n)
        assert cluster in slots and 1 <= tile <= max_tile
        assert cluster > 1 or tile & (tile - 1) == 0
        clusters = -(-batch // tile)
        assert clusters * tile >= batch
        one_wave_possible = any(-(-batch // max_tile) <= held for held in slots.values())
        assert (clusters <= slots[cluster]) == one_wave_possible, batch


def test_rotation_instance_small_batches_take_clusters():
    """One ciphertext runs on 16 SMs; a circuit's batches stay on clusters;
    B = 256 is one wave (it no longer takes twice B = 128's time); a batch
    that fills the card with tiles of 8 keeps single blocks."""
    slots = CL.H100_CLUSTER_SLOTS
    assert CBR.rotation_instance(1, 8, slots) == (1, 16)
    assert CBR.rotation_instance(7, 8, slots) == (1, 16)
    assert all(CBR.rotation_instance(b, 8, slots)[1] >= 2 for b in range(1, 129))
    for batch in (128, 256):
        tile, cluster = CBR.rotation_instance(batch, 8, slots)
        assert -(-batch // tile) <= slots[cluster]
    assert CBR.rotation_instance(1056, 8, slots) == (8, 1)
    assert CBR.rotation_instance(4096, 8, slots) == (8, 1)
    # a ring size without cluster instances (slots of single blocks only)
    assert CBR.rotation_instance(1, 8, {1: 132}) == (1, 1)
    assert CBR.rotation_instance(4096, 8, {1: 132}) == (8, 1)


def test_rotation_unit_takes_tensor_cores_where_they_win():
    """N = 1024 and 2048 with single-limb digits have the tensor-core instance
    (16 ciphertexts a cluster; 32 at N = 1024 with a three-limb key and L = 2): from the
    batch where its waves cost less than the CUDA-core instance's; never for
    wide digits, other ring sizes or a card that holds no cluster of 8."""
    slots = CL.H100_CLUSTER_SLOTS
    fast, strict = P.SECURITY_128_BIT_FAST, P.SECURITY_128_BIT

    def unit(p, batch, slots=slots, limbs=4):
        max_tile = 8 if p.n1 <= 1024 else 8192 // p.n1
        return CBR.rotation_unit(batch, p, CBR.rotation_instance(batch, max_tile, slots, p.n1), slots, limbs)

    assert unit(fast, 1) == (1, 16, False)
    assert unit(fast, 16)[2] is False
    for p in (fast, strict, P.SECURITY_80_BIT, P.SECURITY_110_BIT):
        for batch in (64, 128, 256, 512, 4096):
            assert unit(p, batch) == (16, 8, True)
    assert CBR.mma_tiles(fast, 3) == (16, 32) and CBR.mma_tiles(fast, 4) == (16,)
    assert CBR.mma_tiles(strict, 4) == (16,) and CBR.mma_tiles(strict, 3) == (16,)
    # a three-limb key: 16 rows a cluster while one wave of 15 clusters holds the batch, then 32
    assert unit(fast, 240, limbs=3) == (16, 8, True)
    assert unit(fast, 241, limbs=3) == (32, 8, True)
    assert unit(fast, 4096, limbs=3) == (32, 8, True)
    # N = 2048, a cluster of 16 with one row a block: the units cross between 12 and 16 ciphertexts
    assert [unit(P.SECURITY_128_BIT_RADIX, b)[2] for b in (1, 4, 8, 12, 16, 24, 32)] == [False] * 4 + [True] * 3
    assert unit(P.SECURITY_128_BIT_RADIX, 2048) == (16, 16, True)  # N = 2048: a cluster of 16
    for batch in (1, 64, 4096):
        assert unit(P.SECURITY_UINT4, batch)[2] is False
        assert unit(P.SECURITY_128_BIT_NIBBLE, batch)[2] is False  # N = 4096: no instance
        assert unit(P.TEST_TINY, batch)[2] is False
        assert unit(fast, batch, {1: 132, 2: 66})[2] is False
    crossover = [b for b in range(1, 129) if unit(fast, b)[2]]
    assert crossover == list(range(crossover[0], 129))  # one crossover, no flapping


def test_key_limbs_follow_the_data():
    """Three limbs only where the set rounds its key to the 2^8 grid and the
    key's low bytes are really 0; an in-place edit is seen; a new tensor at a
    freed one's address is checked anew."""
    fast, strict = P.SECURITY_128_BIT_FAST, P.SECURITY_128_BIT
    key = torch.randint(-(1 << 31), 1 << 31, (4, 4, 2, 64), dtype=torch.int32)
    assert CBR.key_limbs(key, fast) == 4
    assert CBR.key_limbs(key & ~0xFF, strict) == 4
    on_grid = key & ~0xFF
    assert CBR.key_limbs(on_grid, fast) == 3
    on_grid[1, 2, 1, 3] += 1
    assert CBR.key_limbs(on_grid, fast) == 4
    for _ in range(4):  # same shape, likely the same address as the tensor just dropped
        fresh = key & ~0xFF
        assert CBR.key_limbs(fresh, fast) == 3
        fresh = key.clone()
        assert CBR.key_limbs(fresh, fast) == 4


def test_key_limbs_of_a_key_made_in_inference_mode():
    """Such a tensor has no version counter: its limbs are read at every
    call, so an edit in place is still seen and nothing raises."""
    fast = P.SECURITY_128_BIT_FAST
    with torch.inference_mode():
        key = torch.randint(-(1 << 31), 1 << 31, (4, 4, 2, 64), dtype=torch.int32) & ~0xFF
        assert CBR.key_limbs(key, fast) == 3
        key[0, 0, 0, 0] |= 1
    assert key.is_inference()
    assert CBR.key_limbs(key, fast) == 4
    assert id(key) not in CL._grid_checked


def test_rotation_unit_counts_waves_from_the_tensor_core_slots():
    """`held`, the clusters of the tensor-core instance the card holds per
    tile, decides its waves: a tile with none is no candidate, and with none
    at all the CUDA cores keep the batch."""
    slots = CL.H100_CLUSTER_SLOTS
    fast = P.SECURITY_128_BIT_FAST

    def unit(batch, held):
        return CBR.rotation_unit(batch, fast, CBR.rotation_instance(batch, 8, slots), slots, 3, held)

    assert unit(4096, {16: 15, 32: 15}) == (32, 8, True)
    assert unit(4096, {16: 15, 32: 0}) == (16, 8, True)
    assert unit(4096, {16: 0, 32: 0}) == (8, 1, False)
    assert unit(4096, {16: 0, 32: 0}) == (*CBR.rotation_instance(4096, 8, slots), False)
    # 241 ciphertexts: two waves of 15 clusters of 16, or one of 32; with 16 clusters held, one wave of 16
    assert unit(241, {16: 15, 32: 15}) == (32, 8, True)
    assert unit(241, {16: 16, 32: 15}) == (16, 8, True)
    assert CBR.rotation_unit(4096, fast, (8, 1), slots, 3) == (32, 8, True)  # planning without the card


@pytest.mark.parametrize("name", ["TEST_TINY", "SECURITY_128_BIT_FAST", "SECURITY_UINT4"])
def test_check_digit_range(name):
    """Digits in [-Bg/2, Bg/2) pass, the first value past either end raises."""
    p = getattr(P, name)
    half = p.trgsw_lv1.half_bg
    d = torch.randint(-half, half, (3, 2 * p.trgsw_lv1.l, 16), dtype=torch.int32)
    d[0, 0, 0], d[1, 0, 1] = -half, half - 1
    CS.check_digit_range(d, p)
    CS.check_digit_range(d[:0], p)
    for bad in (half, -half - 1):
        d[2, 1, 3] = bad
        with pytest.raises(ValueError, match="outside"):
            CS.check_digit_range(d, p)


def test_headers_are_hashed_and_on_the_include_path(monkeypatch):
    """An edited csrc/*.cuh rebuilds the library: the headers are part of the
    build's hash, and nvcc is given csrc/ as an include directory."""
    names = [h.name for h in _build._HEADERS]
    assert "negacyclic_mma.cuh" in names
    flags = list(_build._FLAGS)
    assert flags[flags.index("-I") + 1].endswith("csrc")
    with_headers = _build.library_path()
    monkeypatch.setattr(_build, "_HEADERS", ())
    assert _build.library_path() != with_headers
    assert len({name for _, _, name in _build._UNITS}) == len(_build._UNITS)
