"""Owner flash-decode K1/K2 on the card: the CUDA kernels against their
plain PyTorch versions at the serving shapes. Needs a CUDA card; imports no
JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q
"""
import pytest
import torch

from unified_audio_tpu_torch.ops.cuda import paged_attention as t_pa


@pytest.mark.requires_cuda
class TestKernelsOnCard:
    """The CUDA kernels against their plain versions on the card, at the
    serving shapes, with the tolerance of ``compare_with_plain``: fp32
    within 1e-5; bf16 within 2 bf16 ulps of the fp32 plain result on the
    same (bf16-valued) inputs."""

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
