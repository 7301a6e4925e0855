"""The segment-sum kernel's schedule and its ring (``ops/segsum.py``,
``ops/csrc/segsum.cu``).

On the CPU: the schedule that :func:`segsum.build_csr` returns (a
permutation of the rows, longest first, ties by row index; the count of
long rows against :data:`segsum.LONG_ROW_EVENTS`), the wrapper's checks of
it, and the plain version's bits unchanged by it. On the card (``cuda``
marker): the kernel against its plain version bit for bit — ranks 1, 7,
32, 33, 64 and 160 (two passes), on the 16-byte and the 4-byte copy path,
rows on both sides of the long-row threshold and of one ring stage, a
300,000-event row with row scales of 10^±4 (so that any other add order
shows), Zipf-skewed lengths, empty rows and an all-empty CSR — and the
same schedule from a CUDA build as from a CPU build.
"""

import dataclasses

import numpy as np
import pytest
import torch

from kmlserver_tpu.mining import als as ref_als
from kmlserver_tpu_torch.ops import segsum

RANKS = [1, 7, 32, 33, 64, 160]


def events(rng, lengths, n_in: int):
    """Events for rows of the given lengths, shuffled (so each row's events
    interleave with the others', as a basket stream gives them)."""
    seg = np.repeat(np.arange(len(lengths)), lengths)
    rng.shuffle(seg)
    gidx = rng.integers(0, n_in, seg.shape[0])
    return seg, gidx


def scaled_mat(rng, n_in: int, rank: int) -> np.ndarray:
    """Rows scaled by 10^[-4, 4): a sum taken in any other order differs."""
    return (rng.standard_normal((n_in, rank))
            * 10.0 ** rng.integers(-4, 4, (n_in, 1))).astype(np.float32)


def build(seg, gidx, n_out: int, n_in: int, device: str = "cpu") -> segsum.Csr:
    return segsum.build_csr(torch.as_tensor(seg).to(device), torch.as_tensor(gidx).to(device),
                            n_out, n_in)


class TestSchedule:
    @pytest.mark.parametrize("seed,n_out,nnz", [(0, 1, 5), (1, 50, 400), (2, 500, 20_000),
                                                (3, 64, 0), (4, 2_000, 2_000)])
    def test_order_is_a_permutation_longest_first_ties_by_row(self, seed, n_out, nnz):
        rng = np.random.default_rng(seed)
        # lengths in steps of 4 rows, so ties are many
        seg = rng.integers(0, max(1, n_out // 4), nnz) * 4 % n_out
        csr = build(seg, rng.integers(0, 30, nnz), n_out, 30)
        lengths = np.bincount(seg, minlength=n_out)
        assert csr.order.dtype == torch.int32
        assert np.array_equal(csr.order.numpy(), np.lexsort((np.arange(n_out), -lengths)))

    @pytest.mark.parametrize("threshold,want", [(1_000, 0), (41, 0), (40, 3), (21, 3),
                                                (20, 5), (1, 8), (0, 10)])
    def test_long_row_count_follows_the_threshold(self, monkeypatch, threshold, want):
        """Rows of 40, 40, 40, 20, 20, 5, 5, 5 and two empty rows: n_long is
        the count of rows with at least ``LONG_ROW_EVENTS`` events — none,
        some, every non-empty one, every one at a threshold of 0."""
        monkeypatch.setattr(segsum, "LONG_ROW_EVENTS", threshold)
        lengths = [5, 40, 0, 20, 40, 5, 0, 40, 20, 5]
        seg, gidx = events(np.random.default_rng(7), lengths, 11)
        csr = build(seg, gidx, len(lengths), 11)
        assert csr.n_long == want
        assert csr.order.tolist() == [1, 4, 7, 3, 8, 0, 5, 9, 2, 6]

    @pytest.mark.parametrize("n_out", [0, 1, 9])
    def test_empty_csr(self, n_out):
        csr = build(np.zeros(0, np.int64), np.zeros(0, np.int64), n_out, 4)
        assert csr.n_long == 0 and csr.order.tolist() == list(range(n_out))
        got = segsum.segment_sum(torch.ones(4, 3), csr)
        assert got.shape == (n_out, 3) and not got.any()

    def test_default_threshold_is_a_positive_int(self):
        assert isinstance(segsum.LONG_ROW_EVENTS, int) and segsum.LONG_ROW_EVENTS >= 1


class TestWrapperChecks:
    def _csr(self):
        seg, gidx = events(np.random.default_rng(3), [3, 0, 7, 1], 6)
        return build(seg, gidx, 4, 6)

    @pytest.mark.parametrize("order", [
        torch.tensor([2, 0, 3, 1], dtype=torch.int64),
        torch.tensor([2, 0, 3], dtype=torch.int32),
        torch.tensor([[2, 0], [3, 1]], dtype=torch.int32),
    ])
    def test_refuses_a_malformed_order(self, order):
        csr = dataclasses.replace(self._csr(), order=order)
        with pytest.raises(ValueError, match="order"):
            segsum.segment_sum(torch.zeros(6, 4), csr)

    @pytest.mark.parametrize("n_long", [-1, 5])
    def test_refuses_a_long_row_count_outside_the_rows(self, n_long):
        csr = dataclasses.replace(self._csr(), n_long=n_long)
        with pytest.raises(ValueError, match="n_long"):
            segsum.segment_sum(torch.zeros(6, 4), csr)

    def test_checks_run_before_the_plain_version_and_count_no_launch(self):
        before = segsum.LAUNCHES["segsum"]
        csr = dataclasses.replace(self._csr(), n_long=9)
        with pytest.raises(ValueError):
            segsum.segment_sum(torch.zeros(6, 4), csr)
        segsum.segment_sum(torch.zeros(6, 4), self._csr())
        assert segsum.LAUNCHES["segsum"] == before

    def test_refuses_a_device_it_has_no_kernel_for(self):
        csr = self._csr()
        meta = dataclasses.replace(csr, offsets=csr.offsets.to("meta"), gidx=csr.gidx.to("meta"),
                                   order=csr.order.to("meta"))
        with pytest.raises(ValueError, match="no segsum kernel"):
            segsum.segment_sum(torch.zeros(6, 4, device="meta"), meta)

    @pytest.mark.parametrize("rank", [1, 7, 32])
    def test_the_schedule_leaves_the_plain_bits_alone(self, monkeypatch, rank):
        """On the CPU the sum follows the CSR, whatever the schedule: a
        reversed order and every row long give the same bits as numpy's
        sequential ``np.add.at``."""
        rng = np.random.default_rng(rank)
        seg, gidx = events(rng, [300, 0, 17, 64, 1], 50)
        mat = scaled_mat(rng, 50, rank)
        want = np.zeros((5, rank), np.float32)
        np.add.at(want, seg, mat[gidx])
        monkeypatch.setattr(segsum, "LONG_ROW_EVENTS", 0)
        csr = build(seg, gidx, 5, 50)
        assert csr.n_long == 5
        flipped = dataclasses.replace(csr, order=torch.flip(csr.order, [0]).contiguous())
        for c in (csr, flipped):
            assert np.array_equal(segsum.segment_sum(torch.from_numpy(mat), c).numpy(), want)

    def test_matches_the_references_accumulate_on_zipf_rows(self):
        """The reference's chunked XLA scatter-add over the padded stream,
        against the port's segment sum of the same Zipf-skewed events."""
        import jax.numpy as jnp

        rng = np.random.default_rng(11)
        n_out, n_in, nnz, rank = 200, 120, 6_000, 8
        seg = np.minimum(rng.zipf(1.3, nnz) - 1, n_out - 1).astype(np.int32)
        gidx = rng.integers(0, n_in, nnz).astype(np.int32)
        mat = rng.standard_normal((n_in, rank)).astype(np.float32)
        chunk = ref_als._als_chunk(nnz)
        pad = (-nnz) % chunk
        want = ref_als._sparse_accumulate(
            jnp.asarray(np.concatenate([seg, np.full(pad, n_out, np.int32)])),
            jnp.asarray(np.concatenate([gidx, np.full(pad, n_in, np.int32)])),
            jnp.asarray(mat), n_out, chunk)
        csr = build(seg, gidx, n_out, n_in)
        assert int(np.bincount(seg).max()) == int(
            (csr.offsets[1:] - csr.offsets[:-1])[csr.order[0].long()])
        got = segsum.segment_sum(torch.from_numpy(mat), csr).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
class TestKernel:
    """On the card: the kernel against its plain version, bit for bit."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (runs on the GPU machine)")

    def check(self, seg, gidx, mat: np.ndarray, n_out: int, *, misaligned: bool = False):
        """Kernel == CPU plain version bit for bit, twice, one launch each."""
        n_in, rank = mat.shape
        want = segsum.segment_sum_plain(torch.from_numpy(mat), torch.from_numpy(seg),
                                        torch.from_numpy(gidx), n_out)
        csr = build(seg, gidx, n_out, n_in, "cuda")
        if misaligned:  # a base 4 bytes off a 16-byte boundary: the 4-byte copies
            flat = torch.empty(n_in * rank + 1, device="cuda")
            dev = flat[1:].view(n_in, rank)
            dev.copy_(torch.from_numpy(mat))
            assert dev.data_ptr() % 16 != 0
        else:
            dev = torch.from_numpy(mat).cuda()
        before = segsum.LAUNCHES["segsum"]
        a = segsum.segment_sum(dev, csr)
        b = segsum.segment_sum(dev, csr)
        torch.cuda.synchronize()
        assert segsum.LAUNCHES["segsum"] == before + 2
        got = a.cpu()
        bad = (got.view(torch.int32) != want.view(torch.int32)).any(dim=1).nonzero()
        assert bad.numel() == 0, f"{bad.numel()} rows differ, first {bad[:5].flatten().tolist()}"
        assert torch.equal(a, b)
        return csr

    @pytest.mark.parametrize("rank", RANKS)
    def test_rows_around_the_threshold_and_the_stage(self, monkeypatch, rank):
        """Rows at LONG_ROW_EVENTS - 1, + 0, + 1, at one ring stage and one
        plus one, at a few stages and a ragged end, and empty rows."""
        monkeypatch.setattr(segsum, "LONG_ROW_EVENTS", 200)
        stage = segsum.kernel_plan(rank)["stage_events"]
        lengths = [199, 200, 201, stage, stage + 1, 3 * stage - 1, 7 * stage + 5, 0, 1, 31, 33,
                   0, 64, 2, 0]
        rng = np.random.default_rng(rank)
        seg, gidx = events(rng, lengths, 700)
        csr = self.check(seg, gidx, scaled_mat(rng, 700, rank), len(lengths))
        assert csr.n_long == sum(n >= 200 for n in lengths)

    @pytest.mark.parametrize("rank", RANKS)
    def test_every_row_through_the_ring(self, monkeypatch, rank):
        """A threshold of 0 sends every row, the empty ones too, through
        the block path; the 4-byte copies on a misaligned base too."""
        monkeypatch.setattr(segsum, "LONG_ROW_EVENTS", 0)
        rng = np.random.default_rng(100 + rank)
        lengths = rng.integers(0, 300, 40)
        lengths[::7] = 0
        seg, gidx = events(rng, lengths, 90)
        mat = scaled_mat(rng, 90, rank)
        csr = self.check(seg, gidx, mat, len(lengths))
        assert csr.n_long == len(lengths)
        self.check(seg, gidx, mat, len(lengths), misaligned=True)

    @pytest.mark.parametrize("rank", RANKS)
    def test_one_row_of_300k_events(self, rank):
        rng = np.random.default_rng(300 + rank)
        lengths = [300_000, 5, 0, 1_500, 90]
        seg, gidx = events(rng, lengths, 20_000)
        csr = self.check(seg, gidx, scaled_mat(rng, 20_000, rank), len(lengths))
        assert csr.n_long == sum(n >= segsum.LONG_ROW_EVENTS for n in lengths)
        assert csr.order[0].item() == 0

    @pytest.mark.parametrize("rank", RANKS)
    def test_zipf_lengths(self, rank):
        rng = np.random.default_rng(400 + rank)
        n_out, n_in, nnz = 30_000, 5_000, 600_000
        seg = np.minimum(rng.zipf(1.1, nnz) - 1, n_out - 1)
        gidx = rng.integers(0, n_in, nnz)
        csr = self.check(seg, gidx, scaled_mat(rng, n_in, rank), n_out)
        assert 0 < csr.n_long < n_out

    @pytest.mark.parametrize("n_out", [1, 5_000])
    def test_an_all_empty_csr_writes_zeros(self, n_out):
        csr = build(np.zeros(0, np.int64), np.zeros(0, np.int64), n_out, 8, "cuda")
        got = segsum.segment_sum(torch.full((8, 32), 7.0, device="cuda"), csr)
        torch.cuda.synchronize()
        assert got.shape == (n_out, 32) and not got.any()

    def test_the_schedule_is_the_same_from_a_cuda_build(self):
        rng = np.random.default_rng(5)
        seg = np.minimum(rng.zipf(1.2, 200_000) - 1, 9_999)
        seg[seg % 97 == 5] = 7  # many ties at a few lengths
        gidx = rng.integers(0, 3_000, seg.shape[0])
        cpu = build(seg, gidx, 10_000, 3_000)
        card = build(seg, gidx, 10_000, 3_000, "cuda")
        assert card.n_long == cpu.n_long
        assert torch.equal(card.order.cpu(), cpu.order)
        assert torch.equal(card.offsets.cpu(), cpu.offsets)
        assert torch.equal(card.gidx.cpu(), cpu.gidx)

    def test_plan_fits_the_card(self):
        plan = segsum.kernel_plan(32)
        assert plan["blocks_per_sm"] >= 1 and plan["sms"] == torch.cuda.get_device_properties(
            0).multi_processor_count
        assert plan["consumer_warps"] == 1 and plan["stage_events"] >= 32
