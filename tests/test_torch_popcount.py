"""The port's bit-packed popcount route (kmlserver_tpu_torch/ops/popcount.py)
against the JAX package's on the same numpy inputs.

On the CPU the port's wrapper runs the kernel's plain PyTorch version; the
JAX side runs its Pallas kernel in interpret mode (``impl="vpu"``, as
tests/test_popcount.py does) and its XLA unpack-matmul (``impl="mxu"``).
Counts are integers, so every comparison is exact. The CUDA kernel itself
is held against the plain version on the card by chip_smoke.py and by the
``cuda``-marked test at the end of this file.
"""

import numpy as np
import pytest
import torch

from kmlserver_tpu.mining.vocab import build_baskets
from kmlserver_tpu.ops import popcount as ref_pc
from kmlserver_tpu_torch.ops import popcount as pc

from .oracle import random_baskets
from .test_ops import table_from_baskets

SHAPES = [(40, 17), (700, 300), (129, 257)]  # tests/test_popcount.py's (P, V)


def _baskets(pv):
    p, v = pv
    rng = np.random.default_rng(p * 1000 + v)
    return build_baskets(
        table_from_baskets(random_baskets(rng, n_playlists=p, n_tracks=v, mean_len=6))
    )


def _port(b, **kw):
    got = pc.popcount_pair_counts(
        b.playlist_rows, b.track_ids,
        n_playlists=b.n_playlists, n_tracks=b.n_tracks, device="cpu", **kw,
    )
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    return got.numpy()


def _jax(b, **kw):
    return np.asarray(
        ref_pc.popcount_pair_counts(
            b.playlist_rows, b.track_ids,
            n_playlists=b.n_playlists, n_tracks=b.n_tracks, **kw,
        )
    )


@pytest.fixture(scope="module")
def mxu_counts():
    """The JAX unpack-matmul counts, once per shape."""
    return {pv: _jax(_baskets(pv), impl="mxu") for pv in SHAPES}


@pytest.mark.parametrize("pv", SHAPES)
@pytest.mark.parametrize("variant", ["bcast", "row"])
@pytest.mark.parametrize("swar", [False, True])
def test_counts_match_jax(pv, variant, swar, mxu_counts):
    b = _baskets(pv)
    got = _port(b, variant=variant, swar=swar)
    np.testing.assert_array_equal(got, _jax(b, impl="vpu", variant=variant, swar=swar))
    np.testing.assert_array_equal(got, mxu_counts[pv])


@pytest.mark.parametrize(
    "tiles",
    [(16, 64, 128), (8, 24, 8), (64, 32, 256), (6, 10, 64), (8, 24, 5), (16, 64, 1)],
)
def test_non_default_tiles_match_jax(tiles, monkeypatch):
    """Non-default tile knobs pad differently; the counts must not move.
    (6, 10) does not fit the SWAR kernel's block, which then takes its
    default; (8, 24, 5) pads V to 144, no multiple of the tensor-core
    kernel's 128-row tile, and W to 10 words, no multiple of 4; a word chunk
    of 1 leaves W unpadded (9 words)."""
    ti, tj, wk = tiles
    monkeypatch.setenv("KMLS_POPCOUNT_TILE_I", str(ti))
    monkeypatch.setenv("KMLS_POPCOUNT_TILE_J", str(tj))
    monkeypatch.setenv("KMLS_POPCOUNT_WORD_CHUNK", str(wk))
    b = _baskets((129, 257))
    assert pc.padded_shape(b.n_tracks, b.n_playlists) == ref_pc.padded_shape(
        b.n_tracks, b.n_playlists
    )
    got = _port(b)
    np.testing.assert_array_equal(got, _jax(b, impl="mxu"))
    np.testing.assert_array_equal(got, _jax(b, impl="vpu"))


def test_bitpack_by_track_matches_jax():
    b = _baskets((700, 300))
    v_pad, w_pad = pc.padded_shape(b.n_tracks, b.n_playlists)
    kw = dict(
        n_playlists=b.n_playlists, n_tracks=b.n_tracks, v_pad=v_pad, w_pad=w_pad
    )
    got = pc.bitpack_by_track(b.playlist_rows, b.track_ids, device="cpu", **kw)
    want = np.asarray(ref_pc.bitpack_by_track(b.playlist_rows, b.track_ids, **kw))
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))


@pytest.mark.parametrize(
    "n_tracks,n_playlists", [(1, 1), (17, 40), (128, 32), (129, 33), (5000, 100_000)]
)
@pytest.mark.parametrize("tiles", [(None, None, None), (16, 64, 128), (24, 40, 100)])
def test_padded_shape_and_v_tile_parity(n_tracks, n_playlists, tiles, monkeypatch):
    for name, val in zip(("TILE_I", "TILE_J", "WORD_CHUNK"), tiles):
        if val is not None:
            monkeypatch.setenv(f"KMLS_POPCOUNT_{name}", str(val))
    assert pc.padded_shape(n_tracks, n_playlists) == ref_pc.padded_shape(
        n_tracks, n_playlists
    )
    assert pc.v_tile() == ref_pc.v_tile()
    assert pc.word_chunk() == ref_pc.word_chunk()


@pytest.mark.parametrize(
    "shape,tiles",
    [
        ((100, 512), (32, 128, 512)),  # V not a multiple of lcm(TI, TJ)
        ((128, 500), (32, 128, 512)),  # W not a multiple of WORD_CHUNK
        ((96, 64), (32, 48, 64)),  # TI ∤ TJ: lcm 96 ok ...
        ((48, 64), (32, 48, 64)),  # ... 48 is not
    ],
)
def test_padding_contract_errors_match_jax(shape, tiles):
    ti, tj, wk = tiles
    kw = dict(tile_i=ti, tile_j=tj, word_chunk=wk)
    bt = np.zeros(shape, dtype=np.uint32)

    def outcome(fn):
        try:
            fn()
        except ValueError as exc:
            return "ValueError", "truncating grid" in str(exc)
        return "ok", False

    ref = outcome(lambda: ref_pc.popcount_pair_counts_padded(bt, interpret=True, **kw))
    port = outcome(
        lambda: pc.popcount_pair_counts_padded(torch.from_numpy(bt.view(np.int32)), **kw)
    )
    assert port == ref


@pytest.mark.parametrize("knobs", [(0, 128, 512), (32, 128, 200), (32, -1, 512)])
def test_invalid_tiles_raise_like_jax(knobs):
    for mod in (pc, ref_pc):
        with pytest.raises(ValueError):
            mod.resolve_tiles(*knobs)


def test_knobs_are_read_lazily(monkeypatch):
    """An env change after import takes effect on the next call — for the
    tiles, the variant and the swar flag alike (popcount.py:75-117)."""
    assert pc.resolve_tiles() == (32, 128, 512)
    monkeypatch.setenv("KMLS_POPCOUNT_TILE_I", "16")
    monkeypatch.setenv("KMLS_POPCOUNT_TILE_J", "64")
    monkeypatch.setenv("KMLS_POPCOUNT_WORD_CHUNK", "256")
    assert pc.resolve_tiles() == (16, 64, 256) == ref_pc.resolve_tiles()
    assert pc.padded_shape(100, 100) == (128, 256)
    assert pc.resolve_kernel_opts(None, None) == ("bcast", False)
    monkeypatch.setenv("KMLS_POPCOUNT_VARIANT", "row")
    monkeypatch.setenv("KMLS_POPCOUNT_SWAR", "1")
    assert pc.resolve_kernel_opts(None, None) == ("row", True)
    assert pc.resolve_kernel_opts(None, None) == ref_pc.resolve_kernel_opts(None, None)
    monkeypatch.setenv("KMLS_POPCOUNT_VARIANT", "diagonal")
    with pytest.raises(ValueError, match="variant"):
        pc.resolve_kernel_opts(None, None)


def test_block_shape_keeps_knobs_where_they_fit():
    assert pc.block_shape(32, 128) == (32, 128)
    assert pc.block_shape(16, 64) == (16, 64)
    assert pc.block_shape(128, 128) == (128, 128)
    assert pc.block_shape(6, 10) == (32, 128)  # not multiples of 4
    assert pc.block_shape(256, 256) == (32, 128)  # 4096 threads


def test_plain_version_is_exact_on_full_words():
    """All 32 bits of a word, including bit 31 (negative as int32), count."""
    rng = np.random.default_rng(3)
    words = rng.integers(0, 2**32, size=(64, 40), dtype=np.uint64).astype(np.uint32)
    words[0] = 0xFFFFFFFF
    words[1] = 0x80000000
    got = pc.popcount_pair_counts_plain(torch.from_numpy(words.view(np.int32)))
    anded = words[:, None, :] & words[None, :, :]
    want = np.unpackbits(anded.view(np.uint8), axis=2).sum(axis=2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0] == 32 * 40 and got[1, 1] == 40


def test_plain_version_is_exact_on_all_ones_at_the_largest_count():
    """All-ones rows make every cell 32·W_pad, the largest count a cell can
    reach: at 32,768 words that is 2^20, beyond the scale mine's 32·31,744,
    still exact in the int32 result."""
    w = 32_768
    words = np.full((6, w), 0xFFFFFFFF, dtype=np.uint32)
    words[4] = 0x80000000  # bit 31 alone in every word
    words[5, ::2] = 0
    got = pc.popcount_pair_counts_plain(torch.from_numpy(words.view(np.int32)))
    want = np.full((6, 6), 32 * w, dtype=np.int64)
    want[4, :] = want[:, 4] = w
    want[5, :] = want[:, 5] = 32 * (w // 2)
    want[4, 5] = want[5, 4] = w // 2
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and int(got.max()) == 1 << 20


def test_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(TypeError, match="int32"):
        pc.popcount_pair_counts_padded(torch.zeros((128, 512), dtype=torch.int64))
    with pytest.raises(ValueError, match="variant"):
        pc.popcount_pair_counts_padded(
            torch.zeros((128, 512), dtype=torch.int32), variant="diagonal"
        )


def test_launch_counter_moves_only_on_the_card():
    """The CPU path is the plain version: no kernel launch is counted."""
    before = dict(pc.LAUNCHES)
    pc.popcount_pair_counts_padded(torch.zeros((128, 512), dtype=torch.int32))
    assert pc.LAUNCHES == before


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")


_COUNTER = {False: "popcount_pairs", True: "popcount_pairs_swar"}


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """On the card: both CUDA kernels against the plain version, exact."""
    _needs_card()
    b = _baskets((700, 300))
    for swar in (False, True):
        before = pc.LAUNCHES[_COUNTER[swar]]
        got = pc.popcount_pair_counts(
            b.playlist_rows, b.track_ids, n_playlists=b.n_playlists,
            n_tracks=b.n_tracks, swar=swar, device="cuda",
        ).cpu().numpy()
        assert pc.LAUNCHES[_COUNTER[swar]] == before + 1
        np.testing.assert_array_equal(got, _port(b))


def _edge_bitset(shape, fill, seed=0):
    rng = np.random.default_rng(seed)
    if fill == "ones":
        return np.full(shape, 0xFFFFFFFF, dtype=np.uint32)
    words = rng.integers(0, 2**32, size=shape, dtype=np.uint64)
    if fill == "bit31":
        words[::2] |= 1 << 31
    return words.astype(np.uint32)


# (V_pad, W_pad), tile knobs, words, base offset in int32 elements: the
# edges chip_smoke.py's phase 3 runs
EDGES = [
    ((256, 512), (32, 128, 512), "ones", 0),
    ((512, 384), (32, 128, 128), "bit31", 0),
    ((144, 10), (8, 24, 5), "random", 0),  # V_pad ∤ 128, W_pad ∤ 4
    ((640, 128), (32, 128, 128), "random", 1),  # base off a 16-byte boundary
    ((128, 512), (32, 128, 512), "random", 0),  # a lone diagonal tile
    ((720, 128), (6, 10, 64), "random", 0),  # the SWAR kernel's fallback block
]


@pytest.mark.cuda
@pytest.mark.parametrize("swar", [False, True])
@pytest.mark.parametrize("shape,tiles,fill,offset", EDGES)
def test_cuda_kernels_match_plain_at_the_edges(shape, tiles, fill, offset, swar):
    """On the card: the tensor-core kernel (and the SWAR kernel) against
    the plain version at the padding contract's edges, exact."""
    _needs_card()
    ti, tj, wk = tiles
    words = _edge_bitset(shape, fill).view(np.int32)
    flat = torch.zeros(words.size + offset, dtype=torch.int32, device="cuda")
    bt = flat[offset:].view(shape)
    bt.copy_(torch.from_numpy(words))
    got = pc.popcount_pair_counts_padded(
        bt, swar=swar, tile_i=ti, tile_j=tj, word_chunk=wk
    )
    want = pc.popcount_pair_counts_plain(bt)
    assert torch.equal(got, want)
    if fill == "ones":
        assert bool((got == 32 * shape[1]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("swar", [False, True])
def test_cuda_launch_moves_only_its_own_counter(swar):
    """``swar=True`` counts in ``popcount_pairs_swar`` alone, the default
    in ``popcount_pairs`` alone."""
    _needs_card()
    bt = torch.from_numpy(_edge_bitset((256, 512), "random").view(np.int32)).cuda()
    before = dict(pc.LAUNCHES)
    pc.popcount_pair_counts_padded(bt, swar=swar)
    torch.cuda.synchronize()
    assert {k: pc.LAUNCHES[k] - before[k] for k in before} == {
        k: int(k == _COUNTER[swar]) for k in before
    }
