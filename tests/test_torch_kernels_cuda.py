"""The CUDA kernels on the card against their plain PyTorch versions: the
owner flash-decode K1/K2, the stream flash-decode K3/K4 and the block-table
flash-decode K7 at the serving shapes (K7 also against K1 and K3 where
they compute the same function; the pipelined kernels K2/K3 also where a
thread's keys run out, under other bounds, and call to call bit for bit;
the tiled K1/K7 at the edges of their tiles, at a 4096-entry table and
at blocks of 100 and 800 tokens, K4
with masked blocks, the three call to call bit for bit, and three broken
copies of the source shown to fail) and the VQ nearest-code K5/K6 (the
cluster-split kernel of ``csrc/vq.cu``) at the HCodec-1.0 shapes and K6
at HCodec-2.0's 16 layers, with exact ties across codebook chunks, N below
the cluster size, D from 16 to ``vq.MAX_DIM``, rows of NaN, the layers'
codebooks by pointer, the wrappers' refusals and three broken copies of the
source shown to fail; K6 on HCodec-1.5's aggregated groups with their
zero padding rows; and HCodec-2.0's ``resample`` and ``stft`` (cuDNN,
cuFFT) against the same functions on the CPU. Needs a CUDA card; imports
no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q
"""
import pytest
import torch

from unified_audio_tpu_torch.ops import dsp
from unified_audio_tpu_torch.ops.cuda import build

from unified_audio_tpu_torch.ops.cuda import paged_attention as t_pa
from unified_audio_tpu_torch.ops.cuda import vq


@pytest.mark.requires_cuda
class TestKernelsOnCard:
    """The CUDA kernels against their plain versions on the card. K1/K2 at
    the serving shapes, with the tolerance of ``compare_with_plain``: fp32
    within 1e-5; bf16 within 2 bf16 ulps of the fp32 plain result on the
    same (bf16-valued) inputs. K5/K6 under the rule of ``judge_codes``."""

    @pytest.fixture
    def card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")
        return torch.device("cuda")

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("quant", [False, True])
    def test_kernel_matches_plain(self, card, dtype, quant):
        kernel, ref = ((t_pa.paged_flash_decode_owner_q8,
                        t_pa.paged_flash_decode_owner_q8_ref) if quant
                       else (t_pa.paged_flash_decode_owner,
                             t_pa.paged_flash_decode_owner_ref))
        err, ok = t_pa.compare_with_plain(
            kernel, ref, t_pa.serving_case(quant, dtype, card))
        assert ok, f"max abs err {err}"

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("quant", [False, True])
    @pytest.mark.parametrize("bound", [320, 64])
    def test_stream_kernel_matches_plain(self, card, dtype, quant, bound):
        """K3 (float pool) and K4 (int8 pool) at the UniTok serving shapes,
        scattered tables, a slot whose only keys lie in the last chunk, and
        rows with no visible key (zeros), within ``compare_with_plain``'s
        tolerance; also under a bound of 64 blocks, the mask cut to it."""
        kernel, ref = ((t_pa.paged_flash_decode_stream_flat_q8,
                        t_pa.paged_flash_decode_stream_flat_q8_ref) if quant
                       else (t_pa.paged_flash_decode_stream_flat,
                             t_pa.paged_flash_decode_stream_flat_ref))
        args = t_pa.stream_serving_case(quant, dtype, card)
        vis = args[-3][:, :bound * 64].contiguous()
        args[-3:] = [vis, args[-2], bound]
        empty = ~(vis != 0).any(1)
        assert 1 <= int(empty.sum()) < len(empty)
        err, ok = t_pa.compare_with_plain(kernel, ref, args, empty=empty)
        assert ok, f"max abs err {err}"

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("bs,mb", [(64, 14), (16, 40)])
    def test_table_kernel_matches_plain(self, card, dtype, bs, mb):
        """K7 at ``table_serving_case``: trash entries x100, a repeated
        block, an index past the table, inactive slots (zeros); also with
        16-token blocks and 40-entry tables, so that a walk crosses many
        blocks."""
        args = t_pa.table_serving_case(dtype, card, block_size=bs,
                                       max_blocks=mb)
        err, ok = t_pa.compare_with_plain(t_pa.paged_flash_decode,
                                          t_pa.paged_flash_decode_ref, args)
        assert ok, f"max abs err {err}"

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_table_kernel_equals_owner_on_regions(self, card, dtype):
        """K7 on region tables (each slot's 14-block region) equals K1 at
        the owner serving case."""
        q, k, v, start, index, li = t_pa.serving_case(False, dtype, card)
        tables = (start[:, None] + torch.arange(14, device=card)).int()
        err, ok = t_pa.compare_kernels(
            t_pa.paged_flash_decode(q, k, v, tables, index, li),
            t_pa.paged_flash_decode_owner(q, k, v, start, index, li),
            index < 0)
        assert ok, f"max abs err {err}"

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_table_kernel_equals_stream_on_allocator_tables(self, card,
                                                            dtype):
        """K7 equals K3 under the visibility its tables give, on every slot
        of ``table_serving_case`` but the one whose table repeats a block
        (K7 attends positions, the mask dedups blocks)."""
        from unified_audio_tpu_torch.serve.paged import table_visibility

        q, k, v, tables, index, li = t_pa.table_serving_case(dtype, card)
        vis = table_visibility(tables, index, k.shape[1], k.shape[2])
        got = t_pa.paged_flash_decode(q, k, v, tables, index, li)
        want = t_pa.paged_flash_decode_stream_flat(q, k, v,
                                                   vis.to(torch.int8), li)
        keep = torch.arange(len(q), device=card) != 6
        err, ok = t_pa.compare_kernels(got[keep], want[keep],
                                       (index < 0)[keep])
        assert ok, f"max abs err {err}"

    def test_table_wrapper_refuses(self, card):
        """hd != 64, a table that is not int32 and tensors on two devices
        raise ValueError before any launch."""
        q, k, v, tables, index, li = t_pa.table_serving_case(torch.bfloat16,
                                                             card)
        before = t_pa.paged_flash_decode.launches
        q32 = q[..., :32].contiguous()
        k32, v32 = (x.view(*x.shape[:3], 8, 64)[..., :32].contiguous()
                    for x in (k, v))
        for bad in ((q32, k32, v32, tables, index, li),
                    (q, k, v, tables.long(), index, li),
                    (q, k, v, tables.cpu(), index, li),
                    (q, k, v, tables, index.cpu(), li)):
            with pytest.raises(ValueError):
                t_pa.paged_flash_decode(*bad)
        assert t_pa.paged_flash_decode.launches == before

    # K2 positions at the pipelined kernel's edges (256 threads, two keys
    # in flight a thread): position 0, the last position of one, two and
    # three keys a thread (255, 511, 767) and one past each (256, 768), a
    # full 14-block region (895), an inactive slot; every slot inactive
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("edges", [
        [0, 255, 511, 895, 256, 767, -1, 768],
        [895] * 8,
        [-1] * 8,
    ], ids=["edges", "full_regions", "all_inactive"])
    def test_owner_q8_split_edges(self, card, dtype, edges):
        """K2 on the edge positions above, spread over the 16 slots, within
        ``compare_with_plain``'s tolerance, inactive slots exact zeros."""
        args = t_pa.serving_case(True, dtype, card)
        args[-2] = torch.tensor(edges * 2, dtype=torch.int32, device=card)
        err, ok = t_pa.compare_with_plain(
            t_pa.paged_flash_decode_owner_q8,
            t_pa.paged_flash_decode_owner_q8_ref, args)
        assert ok, f"max abs err {err}"
        if min(edges) < 0 and max(edges) < 0:
            assert not t_pa.paged_flash_decode_owner_q8(*args).any()

    @staticmethod
    def _stream_edge_case(dtype, card, bound):
        """K3 at ``stream_serving_case`` cut to ``bound`` blocks, slot 4's
        mask replaced: blocks 21-24 fully visible (256 keys, one a thread),
        block 25 visible on its first 10 keys only, and every other key of
        block 26 (masked keys inside a live block, a second key for some
        threads)."""
        args = t_pa.stream_serving_case(False, dtype, card)
        vis = args[-3].clone()
        vis[4] = 0
        vis[4, 21 * 64:25 * 64] = 1
        vis[4, 25 * 64:25 * 64 + 10] = 1
        vis[4, 26 * 64:27 * 64:2] = 1
        args[-3:] = [vis[:, :bound * 64].contiguous(), args[-2], bound]
        return args

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("bound", [320, 64, 37])
    def test_stream_split_edges(self, card, dtype, bound):
        """K3 under bounds of 320 (two rounds of 256 blocks' mask scan), 64
        and 37 blocks, a slot whose live blocks end partly masked, rows with
        no visible key (zeros)."""
        args = self._stream_edge_case(dtype, card, bound)
        empty = ~(args[-3] != 0).any(1)
        err, ok = t_pa.compare_with_plain(
            t_pa.paged_flash_decode_stream_flat,
            t_pa.paged_flash_decode_stream_flat_ref, args, empty=empty)
        assert ok, f"max abs err {err}"

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("kernel", ["K2", "K3"])
    def test_split_kernels_repeat_bit_for_bit(self, card, dtype, kernel):
        """Three back-to-back calls give the same bits: the threads' partial
        states merge in a fixed order."""
        if kernel == "K2":
            fn, args = (t_pa.paged_flash_decode_owner_q8,
                        t_pa.serving_case(True, dtype, card))
        else:
            fn, args = (t_pa.paged_flash_decode_stream_flat,
                        self._stream_edge_case(dtype, card, 320))
        outs = [fn(*args) for _ in range(3)]
        torch.cuda.synchronize()
        assert all(torch.equal(outs[0], o) for o in outs[1:])

    def test_split_wrappers_refuse(self, card):
        """K2 and K3 raise ValueError before any launch on what they do not
        take: hd != 64, a q/pool dtype mismatch (K3), scales of the wrong
        shape or dtype (K2), per-slot ints or a mask on the CPU, a mask that
        is not int8, a bound outside the pool."""
        q, k, v, ks, vs, start, index, li = t_pa.serving_case(
            True, torch.bfloat16, card)
        k2 = t_pa.paged_flash_decode_owner_q8
        bad2 = ((q[..., :32].contiguous(), k, v, ks, vs, start, index, li),
                (q, k, v, ks[:, :32].contiguous(), vs, start, index, li),
                (q, k, v, ks.double(), vs, start, index, li),
                (q, k, v, ks, vs, start.cpu(), index, li),
                (q, k, v, ks, vs, start, index.long(), li))
        q3, k3, v3, vis, li3, nb = t_pa.stream_serving_case(
            False, torch.bfloat16, card)
        k3_fn = t_pa.paged_flash_decode_stream_flat
        bad3 = ((q3.float(), k3, v3, vis, li3, nb),
                (q3, k3, v3, vis.cpu(), li3, nb),
                (q3, k3, v3, vis.bool(), li3, nb),
                (q3, k3, v3, vis, li3, nb + 1))
        before = (k2.launches, k3_fn.launches)
        for fn, cases in ((k2, bad2), (k3_fn, bad3)):
            for bad in cases:
                with pytest.raises(ValueError):
                    fn(*bad)
        assert (k2.launches, k3_fn.launches) == before

    # K1 positions at the tiled kernel's edges (64-row tiles): position 0,
    # the last row of one tile and the first of the next (63, 64; 127,
    # 128), eight tiles (511), a full 14-block region (895), an inactive
    # slot; every slot at the region's end; every slot inactive
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("edges", [
        [0, 63, 64, 511, 895, -1, 127, 128],
        [895] * 8,
        [-1] * 8,
    ], ids=["edges", "full_regions", "all_inactive"])
    def test_owner_tiled_edges(self, card, dtype, edges):
        """K1 on the edge positions above, spread over the 16 slots, within
        ``compare_with_plain``'s tolerance, inactive slots exact zeros."""
        args = t_pa.serving_case(False, dtype, card)
        args[-2] = torch.tensor(edges * 2, dtype=torch.int32, device=card)
        err, ok = t_pa.compare_with_plain(
            t_pa.paged_flash_decode_owner, t_pa.paged_flash_decode_owner_ref,
            args)
        assert ok, f"max abs err {err}"
        if max(edges) < 0:
            assert not t_pa.paged_flash_decode_owner(*args).any()

    @staticmethod
    def _stream_q8_edge_case(dtype, card, bound):
        """K4 at ``stream_serving_case`` cut to ``bound`` blocks, slot 4's
        mask replaced: blocks 21-24 fully visible, block 25 visible on its
        first 10 keys, every other key of block 26, block 27 fully masked
        between live blocks and block 28 visible on its first key only."""
        args = t_pa.stream_serving_case(True, dtype, card)
        vis = args[-3].clone()
        vis[4] = 0
        vis[4, 21 * 64:25 * 64] = 1
        vis[4, 25 * 64:25 * 64 + 10] = 1
        vis[4, 26 * 64:27 * 64:2] = 1
        vis[4, 28 * 64] = 1
        args[-3:] = [vis[:, :bound * 64].contiguous(), args[-2], bound]
        return args

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("bound", [320, 64, 37])
    def test_stream_q8_edges(self, card, dtype, bound):
        """K4 under bounds of 320, 64 and 37 blocks: a live block partly
        masked, a fully masked block between live ones, rows with no
        visible key (zeros)."""
        args = self._stream_q8_edge_case(dtype, card, bound)
        empty = ~(args[-3] != 0).any(1)
        assert bool(empty.any())
        err, ok = t_pa.compare_with_plain(
            t_pa.paged_flash_decode_stream_flat_q8,
            t_pa.paged_flash_decode_stream_flat_q8_ref, args, empty=empty)
        assert ok, f"max abs err {err}"

    @staticmethod
    def _wide_table_case(dtype, card):
        """K7 with 4096-entry tables over a pool of 1280 16-token blocks:
        slot 0 past the table (all 65,536 positions, four rounds of staged
        entries), slot 1 inside the second round, slot 2 inactive, slot 3
        at position 0; entries drawn with repeats, so tables repeat
        blocks."""
        q, k, v, _, _, li = t_pa.table_serving_case(dtype, card,
                                                    block_size=16)
        g = torch.Generator(device=card).manual_seed(4)
        tables = torch.randint(0, k.shape[1], (4, 4096), generator=g,
                               device=card, dtype=torch.int32)
        index = torch.tensor([4096 * 16 + 37, 1500 * 16 + 9, -1, 0],
                             dtype=torch.int32, device=card)
        return [q[:4].contiguous(), k, v, tables, index, li]

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_table_kernel_wide_table(self, card, dtype):
        """K7 at MB = 4096 (wider than the 2048 entries the first port's
        kernel took) within ``compare_with_plain``'s tolerance."""
        args = self._wide_table_case(dtype, card)
        err, ok = t_pa.compare_with_plain(t_pa.paged_flash_decode,
                                          t_pa.paged_flash_decode_ref, args)
        assert ok, f"max abs err {err}"

    @staticmethod
    def _large_block_case(dtype, card, bs):
        """K1 over a 2-layer pool of eight ``bs``-token blocks: four slots
        with 2-block regions, slot 0 at its region's end, slot 1 on the
        first row of its second block, slot 2 at position 70, slot 3
        inactive; layer 1."""
        g = torch.Generator(device=card).manual_seed(5)
        q = torch.randn(4, 8, 64, generator=g, device=card).to(dtype)
        k, v = (torch.randn(2, 8, bs, 8 * 64, generator=g,
                            device=card).to(dtype) for _ in range(2))
        start = torch.tensor([0, 2, 4, 6], dtype=torch.int32, device=card)
        index = torch.tensor([2 * bs - 1, bs, 70, -1], dtype=torch.int32,
                             device=card)
        return [q, k, v, start, index, 1]

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("bs", [100, 800])
    def test_owner_and_table_large_blocks(self, card, dtype, bs):
        """K1 and K7 at blocks of 100 tokens (64-row tiles that do not
        divide a block) and of 800 (a block the ring could not hold twice
        whole) within ``compare_with_plain``'s tolerance: K1 on the
        regions, K7 on tables naming each region's blocks in reverse; K7 on
        the regions' own tables equals K1."""
        q, k, v, start, index, li = self._large_block_case(dtype, card, bs)
        err, ok = t_pa.compare_with_plain(
            t_pa.paged_flash_decode_owner, t_pa.paged_flash_decode_owner_ref,
            [q, k, v, start, index, li])
        assert ok, f"K1 max abs err {err}"
        regions = (start[:, None] + torch.arange(2, device=card)).int()
        err, ok = t_pa.compare_with_plain(
            t_pa.paged_flash_decode, t_pa.paged_flash_decode_ref,
            [q, k, v, regions.flip(1).contiguous(), index, li])
        assert ok, f"K7 max abs err {err}"
        err, ok = t_pa.compare_kernels(
            t_pa.paged_flash_decode(q, k, v, regions, index, li),
            t_pa.paged_flash_decode_owner(q, k, v, start, index, li),
            index < 0)
        assert ok, f"K7 against K1 max abs err {err}"

    def _k1_k4_k7_cases(self, card, dtype):
        """(wrapper, plain version, arguments, rows with no key) of K1, K4
        and K7 at their edge cases."""
        owner = t_pa.serving_case(False, dtype, card)
        stream = self._stream_q8_edge_case(dtype, card, 320)
        table = t_pa.table_serving_case(dtype, card)
        return [(t_pa.paged_flash_decode_owner,
                 t_pa.paged_flash_decode_owner_ref, owner, None),
                (t_pa.paged_flash_decode_stream_flat_q8,
                 t_pa.paged_flash_decode_stream_flat_q8_ref, stream,
                 ~(stream[-3] != 0).any(1)),
                (t_pa.paged_flash_decode, t_pa.paged_flash_decode_ref,
                 table, None)]

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_k1_k4_k7_repeat_bit_for_bit(self, card, dtype):
        """K1, K4 and K7: three back-to-back calls give the same bits (the
        partial states merge in a fixed order)."""
        for fn, _, args, _ in self._k1_k4_k7_cases(card, dtype):
            outs = [fn(*args) for _ in range(3)]
            torch.cuda.synchronize()
            assert all(torch.equal(outs[0], o) for o in outs[1:]), \
                fn.__name__

    def test_k1_k4_k7_wrappers_refuse(self, card):
        """K1, K4 and K7 raise ValueError before any launch on what they do
        not take: hd != 64, a q/pool dtype mismatch (K1), per-slot ints on
        the CPU or not int32, scales of the wrong shape (K4), a mask that
        is not int8, a bound outside the pool, a table with no entry or
        not int32 (K7)."""
        q, k, v, start, index, li = t_pa.serving_case(False, torch.bfloat16,
                                                      card)
        k1 = t_pa.paged_flash_decode_owner
        bad1 = ((q[..., :32].contiguous(), k, v, start, index, li),
                (q.float(), k, v, start, index, li),
                (q, k, v, start.cpu(), index, li),
                (q, k, v, start, index.long(), li))
        q4, k4, v4, ks, vs, vis, li4, nb = t_pa.stream_serving_case(
            True, torch.bfloat16, card)
        k4_fn = t_pa.paged_flash_decode_stream_flat_q8
        bad4 = ((q4, k4, v4, ks[:, :32].contiguous(), vs, vis, li4, nb),
                (q4, k4, v4, ks, vs, vis.bool(), li4, nb),
                (q4, k4, v4, ks, vs, vis, li4, nb + 1))
        q7, k7, v7, tables, index7, li7 = t_pa.table_serving_case(
            torch.bfloat16, card)
        k7_fn = t_pa.paged_flash_decode
        bad7 = ((q7, k7, v7, tables[:, :0].contiguous(), index7, li7),
                (q7, k7, v7, tables.long(), index7, li7))
        before = (k1.launches, k4_fn.launches, k7_fn.launches)
        for fn, cases in ((k1, bad1), (k4_fn, bad4), (k7_fn, bad7)):
            for bad in cases:
                with pytest.raises(ValueError):
                    fn(*bad)
        assert (k1.launches, k4_fn.launches, k7_fn.launches) == before

    # Broken copies of the kernels, one per failure mode: a tile of the
    # tiled K1/K7 computed before its copies are waited for; a K3/K4 key's
    # mask byte taken from the block before (or after) its own; the partner
    # group's accumulators dropped at the first step of a tiled warp's merge
    MUTANTS = {
        "wrong_stage_waited": (
            "cp_async_wait_pending<kMaxStages - 2>(stages - 2);",
            "cp_async_wait_pending<kMaxStages - 2>(stages - 1);"),
        "mask_of_wrong_block": (
            "key.seen = kMask ? seen[tok] : 1;",
            "key.seen = kMask ? seen[tok >= 64 ? tok - 64 : tok + 64] : 1;"),
        "group_dropped_in_merge": (
            "st.acc[e] = st.acc[e] * f + a_o * f_o;",
            "st.acc[e] = st.acc[e] * f + (off == Lay::kLanes ? 0.f : a_o)"
            " * f_o;"),
    }

    @pytest.mark.parametrize("mutant", sorted(MUTANTS))
    def test_mutants_fail(self, card, mutant, tmp_path, monkeypatch):
        """Each broken copy of ``csrc/paged_attention.cu`` builds and puts
        at least one of K1, K4 and K7 (bf16) outside the tolerance of
        ``compare_with_plain``, where the real kernels pass."""
        old, new = self.MUTANTS[mutant]
        src = (build.CSRC_DIR / "paged_attention.cu").read_text()
        assert src.count(old) == 1
        path = tmp_path / f"paged_attention_{mutant}.cu"
        path.write_text(src.replace(old, new))
        lib = t_pa.typed(build.load_library(path))
        cases = self._k1_k4_k7_cases(card, torch.bfloat16)
        for fn, ref, args, empty in cases:
            assert t_pa.compare_with_plain(fn, ref, args, empty)[1]
        monkeypatch.setattr(t_pa, "_library", lambda: lib)
        results = [t_pa.compare_with_plain(fn, ref, args, empty)
                   for fn, ref, args, empty in cases]
        assert not all(ok for _, ok in results), results

    @pytest.mark.parametrize("m,n", [(250, 1024), (2000, 1024), (37, 300)])
    def test_vq_kernels_match_plain(self, card, m, n):
        """K5 per layer (staged) and K6 (fused): codes equal to the plain
        search in >= 99.9% of (row, layer) places, every other one a near
        tie (``judge_codes``); ragged M and N included."""
        x, cbs = vq.random_case(m, n=n, device=card, seed=m)
        for fn in (vq.rvq_encode_fused, vq.rvq_encode_staged):
            codes = fn(x, cbs)
            torch.cuda.synchronize()
            assert codes.shape == (m, cbs.shape[0])
            share, worst, ok = vq.judge_codes(x, cbs, codes)
            assert share >= 0.999 and ok, (fn.__name__, share, worst)

    @staticmethod
    def _vq_tie_case(card, m, nq, integer=True):
        """Rows and codebooks (N = 1024 in chunks of 128, D = 512), integer-
        valued (every distance exact) or normal: equal codebook rows on
        either side of chunk boundaries (127|128, 511|512) and in the first
        and last chunk (0 and 1023); the first rows of x equal to the higher
        of each pair."""
        g = torch.Generator().manual_seed(m + nq)
        if integer:
            cbs = torch.randint(-2, 3, (nq, 1024, 512), generator=g).float()
            x = torch.randint(-2, 3, (m, 512), generator=g).float()
        else:
            cbs = torch.randn(nq, 1024, 512, generator=g)
            x = torch.randn(m, 512, generator=g)
        for lo, hi in ((127, 128), (511, 512), (0, 1023)):
            cbs[:, hi] = cbs[:, lo]
        x[:3] = cbs[0, [128, 512, 1023]]
        return x.to(card), cbs.to(card)

    @pytest.mark.parametrize("integer", [True, False])
    @pytest.mark.parametrize("nq", [1, 4])
    @pytest.mark.parametrize("m", [240, 2000])
    def test_vq_exact_ties_across_chunks(self, card, m, nq, integer):
        """Exact ties across chunks go to the lower code: the tied rows'
        codes are 127, 511 and 0, at 16 rows a cluster (M = 240, 15
        clusters) and 32 (M = 2000). On integer data (both sums exact) the
        codes equal the plain search's everywhere; on normal data equal
        codebook rows give equal distances wherever they sit in a tile, and
        the codes pass ``judge_codes``."""
        x, cbs = self._vq_tie_case(card, m, nq, integer)
        got = (vq.nearest_code(x, cbs[0])[:, None] if nq == 1
               else vq.rvq_encode_fused(x, cbs))
        torch.cuda.synchronize()
        assert got[:3, 0].tolist() == [127, 511, 0]
        if integer:
            assert torch.equal(got.cpu(),
                               vq.rvq_encode_fused_ref(x, cbs).cpu())
        else:
            share, worst, ok = vq.judge_codes(x, cbs, got)
            assert share >= 0.999 and ok, (share, worst)

    @pytest.mark.parametrize("m,n,d", [
        (100, 5, 16),      # N < the cluster: three empty chunks
        (37, 9, 64),       # chunks of 2, three empty
        (250, 1024, 16),   # D = 16, one stage zero-padded to 32
        (2000, 1024, 16),
        (240, 1024, vq.MAX_DIM),     # the widest D at 16 rows
        (250, 1024, vq.MAX_DIM),     # ... and at 32
        (2000, 1024, vq.MAX_DIM),
    ])
    def test_vq_edges_match_plain(self, card, m, n, d):
        """K5 per layer (staged) and K6 (fused) under ``judge_codes`` at
        the edges of the plan: N below the cluster size, the narrowest and
        widest D at 16 and 32 rows a cluster."""
        x, cbs = vq.random_case(m, n=n, d=d, nq=2, device=card, seed=m + d)
        for fn in (vq.rvq_encode_fused, vq.rvq_encode_staged):
            codes = fn(x, cbs)
            torch.cuda.synchronize()
            share, worst, ok = vq.judge_codes(x, cbs, codes)
            assert share >= 0.999 and ok, (fn.__name__, share, worst)

    @pytest.mark.parametrize("m", [100, 250, 2000])
    def test_vq_nan_rows_keep_codes_in_range(self, card, m):
        """Rows of x holding a NaN (every distance NaN) take code 0 in
        every layer, as the plain argmin gives, from K5 and K6 at 16 (M =
        100) and 32 rows a cluster (M = 250, 2000); the other rows pass
        ``judge_codes``, and the context stays usable: a clean call
        afterwards passes ``judge_codes`` too."""
        x, cbs = vq.random_case(m, device=card, seed=m + 7)
        nan = torch.tensor([0, 31, 32, m - 1], device=card)
        x[nan, 5] = float("nan")
        keep = torch.ones(m, dtype=torch.bool, device=card)
        keep[nan] = False
        for fn in (vq.rvq_encode_fused, vq.rvq_encode_staged):
            codes = fn(x, cbs)
            torch.cuda.synchronize()
            assert torch.equal(codes[nan].cpu(),
                               torch.zeros(4, 4, dtype=torch.int32))
            share, worst, ok = vq.judge_codes(x[keep], cbs, codes[keep])
            assert share >= 0.999 and ok, (fn.__name__, share, worst)
        y, cbs2 = vq.random_case(m, device=card, seed=m)
        share, worst, ok = vq.judge_codes(y, cbs2,
                                          vq.rvq_encode_fused(y, cbs2))
        assert share >= 0.999 and ok, (share, worst)

    @pytest.mark.parametrize("m,rows", [(125, 16), (1184, 32)])
    def test_vq_sixteen_layers_match_plain(self, card, m, rows):
        """K6 at HCodec-2.0's shapes: nq = 16 = ``MAX_LAYERS`` (every
        codebook slot of a launch in use), N = 1024, D = 512, M = 125 (one
        10-s clip at 12.5 Hz, 16 rows a cluster) and 1184 (32 clips of 3 s,
        32 rows), under ``judge_codes``, one launch a call; a 17th layer
        is refused before any launch."""
        x, cbs = vq.random_case(m, nq=vq.MAX_LAYERS, device=card, seed=m)
        assert vq.plan(m, vq.active_clusters(512, 16)) == rows
        before = vq.rvq_encode_fused.launches
        codes = vq.rvq_encode_fused(x, cbs)
        torch.cuda.synchronize()
        assert codes.shape == (m, 16)
        assert vq.rvq_encode_fused.launches == before + 1
        share, worst, ok = vq.judge_codes(x, cbs, codes)
        assert share >= 0.999 and ok, (share, worst)
        with pytest.raises(ValueError, match="1 to 16"):
            vq.rvq_encode_fused(x, list(cbs) + [cbs[0]])
        assert vq.rvq_encode_fused.launches == before + 1

    @pytest.mark.parametrize("orig,new", [(48000, 16000), (44100, 16000),
                                          (16000, 48000)])
    def test_resample_on_card_matches_cpu(self, card, orig, new,
                                          monkeypatch):
        """The polyphase convolution through cuDNN (TF32 off, as the CLI
        runs it) within 1e-5 of the CPU's, on a length the ratio does not
        divide."""
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
        g = torch.Generator().manual_seed(orig + new)
        x = torch.randn(2, 2 * orig + 7, generator=g)
        got = dsp.resample(x.to(card), orig, new)
        want = dsp.resample(x, orig, new)
        assert got.shape == want.shape
        torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)

    def test_stft_on_card_matches_cpu(self, card):
        """HCodec-2.0's STFT (n_fft 1920, hop 960, uncentered) through
        cuFFT against the CPU's on 64 frames of noise with a negative mean:
        bins within 1e-5 of the peak; at DC and Nyquist the imaginary part
        +0.0 and the phase (0 or pi) equal exactly."""
        g = torch.Generator().manual_seed(0)
        x = torch.randn(2, 1920 * 32 + 960, generator=g) - 0.5
        got = dsp.stft(x.to(card), 1920, 960).cpu()
        want = dsp.stft(x, 1920, 960)
        assert got.shape == want.shape == (2, 961, 64)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
        for k in (0, -1):
            assert not torch.signbit(got[:, k].imag).any()
            assert torch.equal(got[:, k].angle(), want[:, k].angle())
        assert (want[:, 0].real < 0).any()

    def test_vq_takes_layers_by_pointer(self, card):
        """K6 over nq separately allocated codebooks (no stacked copy, as
        ``ResidualVQ.encode`` passes them) == K6 over their stack, bit for
        bit, and repeat calls agree."""
        x, cbs = vq.random_case(250, device=card, seed=3)
        apart = [cb.clone() for cb in cbs]
        outs = [vq.rvq_encode_fused(x, apart) for _ in range(2)] + \
            [vq.rvq_encode_fused(x, cbs)]
        torch.cuda.synchronize()
        assert all(torch.equal(outs[0], o) for o in outs[1:])

    @pytest.mark.parametrize("threshold", [0.0, 0.3])
    def test_k6_on_aggregated_groups(self, card, threshold):
        """K6 on HCodec-1.5's rows: a 2-layer query-token aggregator at the
        shipped width (512) over 250 frames grouped by similarity, the
        padding groups' rows zero. One launch; the codes pass
        ``judge_codes`` on all 250 rows, padding included, also against a
        codebook whose two smallest rows tie in norm (a zero row's exact
        tie)."""
        from unified_audio_tpu_torch.models.hcodec import adaptive
        from unified_audio_tpu_torch.utils.initialization import init_random_

        g = torch.Generator(device=card).manual_seed(0)
        agg = init_random_(adaptive.QueryTokenAggregator(512).to(card),
                           g).eval()
        frames = torch.randn(1, 250, 512, device=card, generator=g)
        frames[:, 1:] += 0.8 * frames[:, :-1].clone()
        gid = adaptive.similarity_group_ids(frames, threshold)
        with torch.no_grad():
            groups, counts = agg(frames, gid)
        pad = counts[0] == 0
        assert 0 < int(pad.sum()) < 250
        rows = groups.reshape(-1, 512).contiguous()
        assert bool((rows[pad] == 0).all())
        _, cbs = vq.random_case(1, device=card, seed=5)
        tie = cbs.clone()
        small = tie[0].square().sum(-1).argmin()
        tie[0, (small + 7) % 1024] = tie[0, small].flip(0)  # equal norm
        for books in (cbs, tie):
            before = vq.rvq_encode_fused.launches
            codes = vq.rvq_encode_fused(rows, books)
            assert vq.rvq_encode_fused.launches == before + 1
            share, worst, ok = vq.judge_codes(rows, books, codes)
            assert ok, f"share {share}, worst excess {worst}"

    def test_vq_wrappers_refuse(self, card):
        """K5 and K6 raise ValueError before any launch on what they do not
        take: D not a multiple of 16 or above ``MAX_DIM``, fp64 or fp16
        inputs, a codebook on the CPU, non-contiguous or misaligned rows,
        codebooks of unequal N, more than ``MAX_LAYERS`` layers, no rows."""
        x, cbs = vq.random_case(64, n=128, d=64, device=card, seed=1)
        wide = torch.zeros(64, vq.MAX_DIM + 16, device=card)
        odd = torch.zeros(64, 24, device=card)
        skew = torch.zeros(64 * 64 + 1, device=card)[1:].view(64, 64)
        bad5 = ((wide, torch.zeros(128, vq.MAX_DIM + 16, device=card)),
                (odd, torch.zeros(128, 24, device=card)),
                (x.double(), cbs[0].double()),
                (x, cbs[0].half()),
                (x, cbs[0].cpu()),
                (torch.zeros(64, 128, device=card).t(), cbs[0]),
                (skew, cbs[0]),
                (x[:0], cbs[0]),
                (x[0], cbs[0]))
        bad6 = ((x, [cbs[0], cbs[1][:64]]),
                (x, [cbs[0]] * (vq.MAX_LAYERS + 1)),
                (x, cbs[:, :, :32]),
                (x, cbs.transpose(1, 2).contiguous().transpose(1, 2)))
        before = (vq.nearest_code.launches, vq.rvq_encode_fused.launches)
        for fn, cases in ((vq.nearest_code, bad5),
                          (vq.rvq_encode_fused, bad6)):
            for bad in cases:
                with pytest.raises(ValueError):
                    fn(*bad)
        assert (vq.nearest_code.launches,
                vq.rvq_encode_fused.launches) == before

    # Broken copies of the VQ kernel: the cluster merge taking the higher
    # code on an exact tie; one rank's candidates left out of the merge;
    # every layer after the first updating the residual from layer 0's code
    VQ_MUTANTS = {
        "merge_tie_reversed": (
            "          if (better(d2, i2, bd, bi)) {",
            "          if (d2 < bd || (d2 == bd && i2 > bi)) {"),
        "rank_skipped": (
            "for (int q = 0; q < kCluster; ++q) {",
            "for (int q = 0; q < kCluster; q += 1 + (q == 2)) {"),
        "stale_code": (
            "        chosen[t] = bi;",
            "        if (l == 0) chosen[t] = bi;"),
    }

    @pytest.mark.parametrize("mutant", sorted(VQ_MUTANTS))
    def test_vq_mutants_fail(self, card, mutant, tmp_path, monkeypatch):
        """Each broken copy of ``csrc/vq.cu`` builds and fails
        ``judge_codes`` at M = 250 or 2000 or the exact-tie case, all of
        which the real kernel passes."""
        old, new = self.VQ_MUTANTS[mutant]
        src = (build.CSRC_DIR / "vq.cu").read_text()
        assert src.count(old) == 1
        path = tmp_path / f"vq_{mutant}.cu"
        path.write_text(src.replace(old, new))
        lib = vq.typed(build.load_library(path))
        cases = [vq.random_case(m, device=card, seed=m) for m in (250, 2000)]
        tie = self._vq_tie_case(card, 250, 4)

        def passes():
            for x, cbs in cases:
                share, _, ok = vq.judge_codes(x, cbs,
                                              vq.rvq_encode_fused(x, cbs))
                if not (share >= 0.999 and ok):
                    return False
            return torch.equal(vq.rvq_encode_fused(*tie),
                               vq.rvq_encode_fused_ref(*tie))

        assert passes()
        monkeypatch.setattr(vq, "_library", lambda: lib)
        assert not passes()
