"""The CUDA kernels on the card against their plain PyTorch versions: the
owner flash-decode K1/K2, the stream flash-decode K3/K4 and the block-table
flash-decode K7 at the serving shapes (K7 also against K1 and K3 where
they compute the same function; the pipelined kernels K2/K3 also where a
thread's keys run out, under other bounds, and call to call bit for bit)
and the VQ nearest-code K5/K6 at the HCodec-1.0 shapes. Needs a CUDA card; imports
no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q
"""
import pytest
import torch

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
