"""The port's plain flash-attention and SSD versions against the reference's
oracles and its Pallas kernels (interpret mode), plus their dispatch.

Inputs are drawn with numpy from a seed and fed to both packages.  The
tolerances are the reference's own (``tests/test_kernels.py``): attention
1e-4 in float32 and 3e-2 in bfloat16; SSD y and states 2e-4, chunk decay
1e-5 relative / 1e-6 absolute; one chunk against the chunked SSD 2e-3."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ssd_scan import ssd_intra_pallas
from repro.models.ssm import ssd_chunked as jssd_chunked
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.kernels import ref as tref
from repro_torch.models.ssm import ssd_chunked as tssd_chunked

from _torch_parity import bf16_pair

_SEEDS = range(4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel workers beside timing-based tests of the reference, and idle
    OpenMP threads spinning here would add noise to their timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a, np.float32)


def _attn_inputs(seed, s_mult=8):
    rng = np.random.default_rng(512 + seed)   # seeds 0-3 cover causal x dtype
    bh = int(rng.integers(1, 5))
    s = int(rng.integers(1, 24)) * s_mult
    d = int(rng.integers(4, 80))
    causal = bool(rng.integers(0, 2))
    dtype = "bf16" if rng.integers(0, 2) else "f32"
    qkv = [rng.normal(size=(bh, s, d)).astype(np.float32) for _ in range(3)]
    if dtype == "bf16":
        pairs = [bf16_pair(a) for a in qkv]
    else:
        pairs = [(jnp.asarray(a), torch.from_numpy(a)) for a in qkv]
    tol = 3e-2 if dtype == "bf16" else 1e-4
    return pairs, causal, tol


@pytest.mark.parametrize("seed", _SEEDS)
def test_flash_plain_matches_oracle_and_pallas(seed):
    pairs, causal, tol = _attn_inputs(seed)
    (qj, qt), (kj, kt), (vj, vt) = pairs
    got = tref.flash_attention_ref(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    want = jref.flash_attention_ref(qj, kj, vj, causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    pallas = flash_attention_pallas(qj, kj, vj, causal=causal, block_q=64,
                                    block_k=64, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(pallas), rtol=tol, atol=tol)


@pytest.mark.parametrize("s", [1, 7, 13])
def test_flash_plain_ragged_lengths(s):
    """Lengths the Pallas kernel would run with a block of one: the plain
    version against the oracle, causal and not."""
    rng = np.random.default_rng(s)
    q, k, v = (rng.normal(size=(3, s, 16)).astype(np.float32)
               for _ in range(3))
    for causal in (True, False):
        got = tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                       causal=causal)
        want = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                        causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


def _gqa_inputs(seed):
    """q (B, S, H, d), k and v (B, S, KV, d) from a numpy seed; seeds 0-3
    cover causal x dtype and H // KV of 1, 2 and 4."""
    rng = np.random.default_rng(700 + seed)
    b = int(rng.integers(1, 3))
    s = int(rng.integers(1, 12)) * 8
    kv = int(rng.integers(1, 3))
    h = kv * (1, 2, 4, 2)[seed % 4]
    d = (64, 16, 32, 24)[seed % 4]
    causal = seed % 2 == 0
    dtype = "bf16" if seed in (1, 2) else "f32"
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, s, kv, d)).astype(np.float32)
            for _ in range(2))
    if dtype == "bf16":
        pairs = [bf16_pair(a) for a in (q, k, v)]
    else:
        pairs = [(jnp.asarray(a), torch.from_numpy(a)) for a in (q, k, v)]
    tol = 3e-2 if dtype == "bf16" else 1e-4
    return pairs, causal, tol


@pytest.mark.parametrize("seed", _SEEDS)
def test_flash_plain_gqa_matches_oracle_and_pallas(seed):
    """The plain version's (B, S, H, d) form with KV heads read in groups
    against the reference's oracle and its Pallas kernel on jnp.repeat
    expanded, folded inputs."""
    pairs, causal, tol = _gqa_inputs(seed)
    (qj, qt), (kj, kt), (vj, vt) = pairs
    b, s, h, d = qt.shape
    got = tref.flash_attention_ref(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape

    def fold(a):
        a = jnp.repeat(a, h // a.shape[2], axis=2)
        return a.transpose(0, 2, 1, 3).reshape(b * h, s, d)

    def unfold(o):
        return np.asarray(o, np.float32).reshape(b, h, s, d).transpose(
            0, 2, 1, 3)

    want = jref.flash_attention_ref(fold(qj), fold(kj), fold(vj),
                                    causal=causal)
    np.testing.assert_allclose(_f32(got), unfold(want), rtol=tol, atol=tol)
    pallas = flash_attention_pallas(fold(qj), fold(kj), fold(vj),
                                    causal=causal, block_q=64, block_k=64,
                                    interpret=True)
    np.testing.assert_allclose(_f32(got), unfold(pallas), rtol=tol,
                               atol=tol)


def test_flash_launcher_refuses_before_building(monkeypatch):
    """KV heads that do not divide the query heads, and a last dimension
    that is not contiguous, are refused before nvcc or ctypes is touched;
    the dispatch picks the wgmma kernels at d 64 and 128 (and bfloat16 at
    112 and 192), the warp-level tensor cores at the other multiples of
    8."""
    from repro_torch.kernels import _build

    def boom(*a, **k):
        raise AssertionError("the launcher reached the build")
    monkeypatch.setattr(_build, "load", boom)
    q = torch.zeros((1, 8, 6, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="do not divide"):
        tflash.flash_attention_cuda(q, q[:, :, :4], q[:, :, :4])
    with pytest.raises(ValueError, match="do not divide"):
        tref.flash_attention_ref(q, q[:, :, :4], q[:, :, :4])
    t = torch.zeros((1, 64, 8, 6), dtype=torch.bfloat16).transpose(1, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tflash.flash_attention_cuda(t, t[:, :, :4], t[:, :, :4])
    assert [tflash.variant(dt, d) for dt, d in [
        (torch.bfloat16, 64), (torch.bfloat16, 128), (torch.bfloat16, 80),
        (torch.bfloat16, 256), (torch.float32, 128), (torch.float32, 64),
        (torch.float32, 80)]] == [
            "tc", "tc", "mma", "mma", "tf32", "tf32", "mma"]


@pytest.mark.parametrize("d,bf16_kind,f32_kind", [
    (64, "tc", "tf32"), (128, "tc", "tf32"),      # the wgmma kernels
    (8, "mma", "mma"), (32, "mma", "mma"), (40, "mma", "mma"),
    (80, "mma", "mma"), (112, "tc", "mma"), (192, "tc", "mma"),
    (256, "mma", "mma"),
    (17, "simt", "simt"), (1, "simt", "simt"), (100, "simt", "simt"),
    (255, "simt", "simt")])
def test_flash_variant_by_width(d, bf16_kind, f32_kind):
    """"tc"/"tf32" at d 64 and 128, "tc" also in bfloat16 at zamba2's 112
    and MLA's 192, "mma" at every other multiple of 8 up to 256, "simt" for
    the widths left."""
    assert tflash.variant(torch.bfloat16, d) == bf16_kind
    assert tflash.variant(torch.float32, d) == f32_kind


@pytest.mark.parametrize("kind,dtype,d", [
    ("tf32", torch.float32, 80),       # a width of the warp-level kernel
    ("tf32", torch.bfloat16, 128),     # bfloat16 goes to "tc"
    ("tc", torch.float32, 64),         # float32 goes to "tf32"
    ("wgmma", torch.float32, 128),     # no such kernel
    ("mma", torch.float32, 17),        # a width only the CUDA cores take
    ("mma", torch.bfloat16, 17),
    ("mma", torch.bfloat16, 64),       # a wgmma kernel's width
    ("tc", torch.bfloat16, 80),        # the warp-level kernel's width
])
def test_flash_forced_kind_refuses_before_building(monkeypatch, kind, dtype,
                                                   d):
    """A kernel forced with ``kind=`` at a dtype or width it does not take
    is refused before nvcc or ctypes is touched, even for tensors on the
    CPU, and no launch counter moves."""
    from repro_torch.kernels import _build

    def boom(*a, **k):
        raise AssertionError("the launcher reached the build")
    monkeypatch.setattr(_build, "load", boom)
    q = torch.zeros((1, 70, 4, d), dtype=dtype)
    kv = torch.zeros((1, 70, 2, d), dtype=dtype)
    before = tops.launches()
    with pytest.raises(ValueError, match=f"no '{kind}' kernel"):
        tflash.flash_attention_cuda(q, kv, kv, kind=kind)
    assert tops.launches() == before


@pytest.mark.parametrize("d,total", [(64, 115776), (128, 230464)])
def test_flash_tf32_shared_memory_fits(d, total):
    """The float32 tensor-core kernel's layout fits in a Hopper block at
    both widths, at the bytes that the built kernel reported on the H100
    (``tc_occupancy(d, "tf32")``); a width it does not take has no
    layout."""
    assert tflash.tf32_smem_bytes(d) == total
    assert total <= tflash.SMEM_LIMIT
    with pytest.raises(ValueError, match="takes d in"):
        tflash.tf32_smem_bytes(80)


@pytest.mark.parametrize("d,dv,total", [(64, 64, 148576),
                                        (112, 112, 230480),
                                        (128, 128, 230480),
                                        (192, 192, 197712),
                                        (192, 128, 214112)])
def test_flash_tc_shared_memory_fits(d, dv, total):
    """The bfloat16 tensor-core kernel's layout (``TcSmem``) fits in a
    Hopper block at every (q/k, v) width it takes: Q's 128 rows, a ring of
    K/V stages (4 at d 64 and at MLA's 192/128 with 64-key tiles, 3 at 112
    and 128, 3 at 192/192), its mbarriers (two a stage, and full and empty
    of each consumer warpgroup's Q rows) and the alignment; a pair it does
    not take has no layout."""
    assert tflash.tc_smem_bytes(d, dv) == total
    assert total <= tflash.SMEM_LIMIT
    assert tflash.tc_key_tile(d, dv) == (64 if d == 192 else 128)
    with pytest.raises(ValueError, match="takes"):
        tflash.tc_smem_bytes(128, 64)
    with pytest.raises(ValueError, match="takes"):
        tflash.tc_smem_bytes(80)


@pytest.mark.parametrize("B,H,sq,causal,sms", [
    (1, 16, 2048, True, 132),       # internlm2's prefill: 256 units
    (1, 48, 2048, True, 132),       # grok-1's group of 6: 768
    (1, 48, 2304, True, 132),       # internvl2's 2304 rows
    (1, 16, 4096, False, 132),      # seamless's encoder, non-causal
    (16, 2, 4096, True, 132),       # codeqwen's rank of 16
    (2, 3, 333, True, 7),           # ragged, a card of 7 SMs
    (1, 4, 300, False, 132)])       # fewer units than SMs
def test_flash_tc_walk_takes_every_unit_once_heaviest_first(B, H, sq, causal,
                                                          sms):
    """The persistent grid's work order: min(units, SMs) blocks take every
    (b, h, q-tile) exactly once; each round takes the next G units of the
    one-block-a-unit order (heads the fast axis; causal, the last q-tiles
    first), so a block's q-tiles never get heavier; and the longest block
    reads at most one unit's key tiles more than the mean."""
    blocks = tflash.tc_walk(B, H, sq, causal, sms)
    q_tiles = -(-sq // tflash.TC_ROWS)
    G = len(blocks)
    assert G == min(B * H * q_tiles, sms)
    units = [u for its in blocks for u in its]
    assert sorted(units) == [(b, h, t) for b in range(B) for h in range(H)
                             for t in range(q_tiles)]
    for blk, its in enumerate(blocks):
        for r, (b, h, t) in enumerate(its):
            # the unit's place in the one-block-a-unit order
            u = ((q_tiles - 1 - t) if causal else t) * B * H + b * H + h
            assert divmod(u, G) == (r, G - 1 - blk if r % 2 else blk)
        if causal:
            tiles = [t for _, _, t in its]
            assert tiles == sorted(tiles, reverse=True)
    weight = lambda t: tflash._row_tiles(t * tflash.TC_ROWS, sq, sq, 128,
                                         causal)
    loads = [sum(weight(t) for _, _, t in its) for its in blocks]
    most = max(weight(t) for _, _, t in units)
    assert max(loads) <= -(-sum(loads) // G) + most


def _chunks_cover(B, H, sq, sk, causal, sms, key_tile=128):
    """The split plan's chunks of each q-tile, as the kernel walks them:
    q-tile t's key tiles [c·per, min((c+1)·per, need)) for c below its own
    count of chunks."""
    chunks, per = tflash.split_plan(B, H, sq, sk, causal, sms, key_tile)
    k_tiles = -(-sk // key_tile)
    out = []
    for t in range(-(-sq // tflash.TC_ROWS)):
        last = min((t + 1) * tflash.TC_ROWS, sq) - 1
        need = min(k_tiles, last // key_tile + 1) if causal else k_tiles
        mine = -(-need // per)
        assert mine <= chunks
        out.append((need, [range(c * per, min((c + 1) * per, need))
                           for c in range(mine)], last))
    return chunks, per, out


@pytest.mark.parametrize("B,H,sq,sk,causal,sms,key_tile", [
    (1, 8, 2048, 2048, True, 132, 128),     # zamba2's rank of 8 heads
    (1, 4, 2048, 2048, True, 132, 128),     # internlm2's rank of four
    (1, 2, 700, 700, True, 132, 64),        # ragged, 64-key tiles
    (1, 3, 300, 5000, False, 132, 128),     # Sq != Sk, non-causal
    (1, 2, 3000, 1500, True, 132, 128),     # Sq > Sk
    (1, 1, 1100, 1100, True, 16, 128),      # a card of 16 SMs
    (1, 4, 1, 65536, False, 132, 128)])     # 512 key tiles: 16 chunks
def test_flash_split_plan_covers_every_key_tile_once(B, H, sq, sk, causal,
                                                     sms, key_tile):
    """Every key tile a q-tile reads is in exactly one of its chunks, no
    chunk starts past the causal diagonal, and a grid under one wave is
    split into more blocks than it had."""
    chunks, per, tiles = _chunks_cover(B, H, sq, sk, causal, sms, key_tile)
    for need, parts, last in tiles:
        seen = [t for part in parts for t in part]
        assert seen == list(range(need))
        assert all(len(part) >= 1 for part in parts)
        if causal:
            assert all(part[0] * key_tile <= last for part in parts)
    blocks = B * H * sum(len(parts) for _, parts, _ in tiles)
    assert blocks > B * H * len(tiles)
    assert 1 < chunks <= tflash.MAX_CHUNKS and per >= 1


@pytest.mark.parametrize("B,H,sq,sk,causal,sms", [
    (1, 16, 2048, 2048, True, 132),   # internlm2's prefill: 256 blocks
    (1, 8, 2048, 2048, True, 128),    # 128 blocks on a card of 128 SMs
    (1, 16, 128, 128, True, 132),     # one key tile: nothing to split
    (1, 16, 1, 4096, False, 16),      # decode-like, on 16 SMs
    (1, 16, 512, 512, True, 132)])    # a split would save 256 keys
def test_flash_split_plan_leaves_a_wave_unsplit(B, H, sq, sk, causal, sms):
    """A grid of a wave or more, q-tiles of one key tile, or a split that
    would take less than ``SPLIT_MIN_KEYS`` off the longest q-tile, launch
    as before: one chunk of every key tile the last q-tile reads."""
    chunks, per = tflash.split_plan(B, H, sq, sk, causal, sms)
    assert (chunks, per) == (1, -(-sk // 128))   # the last q-tile reads all


def _narrow_v_inputs(dtype, layout, seed=0):
    """q and k 192 wide, v 128 (MLA's widths): numpy from a seed, each as
    (JAX, torch) arrays, in the 3-D (BH, S, d) or 4-D (B, S, H, d)
    layout."""
    rng = np.random.default_rng(1920 + seed)
    shape = (3, 37) if layout == "BH,S,d" else (2, 37, 3)
    q, k = (rng.normal(size=shape + (192,)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=shape + (128,)).astype(np.float32)
    if dtype == "bf16":
        return [bf16_pair(a) for a in (q, k, v)]
    return [(jnp.asarray(a), torch.from_numpy(a)) for a in (q, k, v)]


@pytest.mark.parametrize("layout", ["BH,S,d", "B,S,H,d"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_plain_narrow_v_matches_oracle(layout, causal, dtype):
    """v narrower than q and k (MLA: 128 beside 192): the plain version
    in both layouts against the reference's oracle, which reads v at its
    own width (on the folded heads in the 4-D layout)."""
    tol = 3e-2 if dtype == "bf16" else 1e-4
    (qj, qt), (kj, kt), (vj, vt) = _narrow_v_inputs(dtype, layout)
    got = tref.flash_attention_ref(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == (*qt.shape[:-1], 128)
    if layout == "B,S,H,d":
        fold = lambda a: a.transpose(0, 2, 1, 3).reshape(
            -1, a.shape[1], a.shape[3])
        want = jref.flash_attention_ref(fold(qj), fold(kj), fold(vj),
                                        causal=causal)
        want = np.asarray(want, np.float32).reshape(
            2, 3, 37, 128).transpose(0, 2, 1, 3)
    else:
        want = jref.flash_attention_ref(qj, kj, vj, causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("layout", ["BH,S,d", "B,S,H,d"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_narrow_v_matches_autograd(layout, causal):
    """``flash_attention_bwd`` with v narrower than q and k (MLA's 128
    beside 192, o and do at 128) against autograd through the plain
    version, float32 at 1e-4; blocks of 16 rows so that the causal key
    ranges differ from block to block."""
    (_, q), (_, k), (_, v) = _narrow_v_inputs("f32", layout, seed=1)
    if layout == "B,S,H,d":
        k, v = k[:, :, :1], v[:, :, :1]         # 3 query heads on one KV
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = tref.flash_attention_ref(q, k, v, causal=causal)
    do = torch.from_numpy(np.random.default_rng(5).normal(
        size=tuple(o.shape)).astype(np.float32))
    want = torch.autograd.grad(o, (q, k, v), do)
    got = tflash.flash_attention_bwd(q.detach(), k.detach(), v.detach(),
                                     o.detach(), do, causal=causal, block=16)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_f32_d64_ragged_matches_oracle_and_pallas(causal):
    """The float32 tensor-core kernel's width (d 64) at a length that is
    not a multiple of its 64-row and 64-key tiles: the plain version the
    card's kernel is held against agrees with the oracle and the Pallas
    kernel (which runs it in blocks of 8)."""
    rng = np.random.default_rng(64)
    q, k, v = (rng.normal(size=(2, 200, 64)).astype(np.float32)
               for _ in range(3))
    got = tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal)
    assert got.dtype == torch.float32 and got.shape == (2, 200, 64)
    qj, kj, vj = map(jnp.asarray, (q, k, v))
    want = jref.flash_attention_ref(qj, kj, vj, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    pallas = flash_attention_pallas(qj, kj, vj, causal=causal, block_q=64,
                                    block_k=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("d", [40, 112])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_plain_mma_widths_match_oracle_and_pallas(d, causal, dtype):
    """Widths of the warp-level tensor-core kernel (d 40 and zamba2-7b's
    112) at 40 tokens, short of one 64-row tile: the plain version the
    card's kernel is held against agrees with the oracle and the Pallas
    kernel (blocks of 8)."""
    rng = np.random.default_rng(d)
    qkv = [rng.normal(size=(2, 40, d)).astype(np.float32) for _ in range(3)]
    if dtype == "bf16":
        pairs = [bf16_pair(a) for a in qkv]
    else:
        pairs = [(jnp.asarray(a), torch.from_numpy(a)) for a in qkv]
    tol = 3e-2 if dtype == "bf16" else 1e-4
    (qj, qt), (kj, kt), (vj, vt) = pairs
    got = tref.flash_attention_ref(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == (2, 40, d)
    want = jref.flash_attention_ref(qj, kj, vj, causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    pallas = flash_attention_pallas(qj, kj, vj, causal=causal, block_q=8,
                                    block_k=8, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(pallas), rtol=tol, atol=tol)


def _ssd_inputs(seed):
    rng = np.random.default_rng(600 + seed)
    b = int(rng.integers(1, 4))
    q = int(rng.integers(1, 12)) * 8
    h = int(rng.integers(1, 10))
    p = int(rng.integers(2, 40))
    g = int(rng.integers(1, 3))
    if h % g:
        g = 1
    n = int(rng.integers(2, 40))
    x = rng.normal(size=(b, q, h, p)).astype(np.float32)
    da = -np.log1p(np.exp(rng.normal(size=(b, q, h)))).astype(np.float32)
    B = rng.normal(size=(b, q, g, n)).astype(np.float32)
    C = rng.normal(size=(b, q, g, n)).astype(np.float32)
    return x, da, B, C


@pytest.mark.parametrize("seed", _SEEDS)
def test_ssd_plain_matches_oracle_and_pallas(seed):
    arrs = _ssd_inputs(seed)
    got = tref.ssd_intra_ref(*map(torch.from_numpy, arrs))
    want = jref.ssd_intra_ref(*map(jnp.asarray, arrs))
    pallas = ssd_intra_pallas(*map(jnp.asarray, arrs), block_h=4,
                              interpret=True)
    assert [t.dtype for t in got] == [torch.float32] * 3
    for other in (want, pallas):
        for g, w, (rtol, atol) in zip(got, other, [(2e-4, 2e-4), (2e-4, 2e-4),
                                                   (1e-5, 1e-6)]):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                       atol=atol)


def test_ssd_one_chunk_equals_chunked_ssd():
    """One-chunk SSD == the port's chunked SSD with chunk == seq, and the
    port's chunked SSD == the reference's."""
    rng = np.random.default_rng(7)
    b, s, h, p, n = 2, 64, 4, 16, 8
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(h,)) * 0.2).astype(np.float32)
    B = rng.normal(size=(b, s, 1, n)).astype(np.float32)
    C = rng.normal(size=(b, s, 1, n)).astype(np.float32)
    t = lambda a: torch.from_numpy(a)
    y_full, _ = tssd_chunked(t(x), t(dt), t(A), t(B), t(C), chunk=s)
    y_k, _, _ = tref.ssd_intra_ref(t(x * dt[..., None]), t(dt * A), t(B),
                                   t(C))
    np.testing.assert_allclose(y_k.numpy(), y_full.numpy(), rtol=2e-3,
                               atol=2e-3)
    y_ref, _ = jssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), chunk=s)
    np.testing.assert_allclose(y_full.numpy(), np.asarray(y_ref), rtol=1e-4,
                               atol=1e-4)


def test_lm_ops_take_the_plain_version_for_cpu_tensors(monkeypatch):
    """A CPU tensor never reaches a kernel launcher, and so never moves a
    launch counter."""
    def boom(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA launcher")
    monkeypatch.setattr(tops, "flash_attention_cuda", boom)
    monkeypatch.setattr(tops, "ssd_intra_cuda", boom)
    tops.reset_launches()
    q = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 9, 8)).astype(np.float32))
    torch.testing.assert_close(tops.flash_attention(q, q, q),
                               tref.flash_attention_ref(q, q, q),
                               rtol=0, atol=0)
    x, da, B, C = map(torch.from_numpy, _ssd_inputs(0))
    for got, want in zip(tops.ssd_intra(x, da, B, C),
                         tref.ssd_intra_ref(x, da, B, C)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert tops.launches() == {"haar": 0, "knn_scores": 0,
                               "knn_scores_gemv": 0, "knn_scores_tiled": 0,
                               "flash_attention_tc": 0,
                               "flash_attention_tf32": 0,
                               "flash_attention_mma": 0,
                               "flash_attention_simt": 0, "ssd_intra_tc": 0,
                               "ssd_intra_simt": 0, "decode_attention": 0,
                               "expand_kv_bytes": 0, "moe_rows_computed": 0,
                               "moe_rows_routed": 0}


def test_lm_ops_refuse_other_devices():
    q = torch.empty((2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tops.flash_attention(q, q, q)
    x = torch.empty((1, 8, 2, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tops.ssd_intra(x, torch.empty((1, 8, 2), device="meta"),
                       torch.empty((1, 8, 1, 4), device="meta"),
                       torch.empty((1, 8, 1, 4), device="meta"))


def test_lm_launchers_check_before_building():
    """The launchers refuse CPU tensors before touching nvcc or ctypes, and
    the SSD launcher knows its shared-memory budget."""
    x = torch.zeros((2, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention_cuda(x, x, x)
    xs = torch.zeros((1, 8, 2, 4))
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_intra_cuda(xs, torch.zeros((1, 8, 2)),
                            torch.zeros((1, 8, 1, 4)),
                            torch.zeros((1, 8, 1, 4)))
    # shared-memory budget of one chunk: the path's shape fits, a chunk of
    # 512 rows at n 128 does not
    assert tssd.smem_bytes(128, 64, 128) == 133632
    assert tssd.smem_bytes(512, 64, 128) > tssd.SMEM_LIMIT


@pytest.mark.parametrize("q,p,n,kind", [
    (128, 64, 128, "tc"),          # mamba2-370m
    (128, 64, 64, "tc"),           # zamba2-7b
    (128, 64, 32, "tc"),
    (128, 8, 8, "tc"),
    (40, 17, 9, "simt"),           # the ragged shapes of the card's tests
    (77, 33, 31, "simt"),
    (1, 5, 3, "simt"),
    (8, 16, 16, "simt"),           # the smoke configs' chunk of 8
    (128, 72, 128, "simt"),        # p past 64
    (128, 64, 136, "simt"),        # n past 128
    (128, 60, 128, "simt"),        # p not a multiple of 8
    (256, 64, 128, "simt"),
])
def test_ssd_variant_picks_by_shape(q, p, n, kind):
    assert tssd.variant(q, p, n) == kind


@pytest.mark.parametrize("kind", [None, "tc", "simt"])
def test_ssd_launcher_refuses_before_building(monkeypatch, kind):
    """At a tensor-core shape, either kernel refuses bfloat16, a tensor that
    is not contiguous and a tensor off the card before nvcc or ctypes is
    touched; the tensor-core kernel is refused at a shape it does not
    take."""
    from repro_torch.kernels import _build

    def boom(*a, **k):
        raise AssertionError("the launcher reached the build")
    monkeypatch.setattr(_build, "load", boom)
    rng = np.random.default_rng(1)
    b, q, h, p, g, n = 1, 128, 2, 64, 1, 128
    x = torch.from_numpy(rng.normal(size=(b, q, h, p)).astype(np.float32))
    da = torch.zeros((b, q, h))
    B = torch.zeros((b, q, g, n))
    before = tops.launches()
    with pytest.raises(TypeError, match="float32"):
        tssd.ssd_intra_cuda(x.bfloat16(), da, B, B, kind=kind)
    with pytest.raises(ValueError, match="contiguous"):
        tssd.ssd_intra_cuda(x.transpose(1, 2).contiguous().transpose(1, 2),
                            da, B, B, kind=kind)
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_intra_cuda(x, da, B, B, kind=kind)
    if kind == "tc":
        x, B = torch.zeros((1, 40, 2, 17)), torch.zeros((1, 40, 1, 9))
        with pytest.raises(ValueError, match="no 'tc' kernel"):
            tssd.ssd_intra_cuda(x, torch.zeros((1, 40, 2)), B, B, kind=kind)
    assert tops.launches() == before


@pytest.mark.parametrize("n", [128, 64])
def test_ssd_tc_shared_memory_fits(n):
    """The tensor-core kernel's shared memory at the two configs' state
    widths fits in a Hopper block; B's hi and lo tiles cover whole halves
    of 64 columns (32 KB each)."""
    assert tssd.tc_smem_bytes(n) <= tssd.SMEM_LIMIT
    assert tssd.tc_smem_bytes(n) == tssd.tc_smem_bytes(n - 8)
    assert tssd.tc_smem_bytes(n) - tssd.tc_smem_bytes(n - 64) \
        == (2 * 2 * 128 * 128 if n == 128 else 0)
