"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA GPU and skip without one. They import neither
JAX nor the test conftest (which does), so on a machine without JAX run
them as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from csm_mlx_tpu_torch.ops import attention, quant  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("rows", [1, 3, 8, 64, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8a8_kernel_matches_plain(cuda_device, rows, dtype):
    rng = np.random.RandomState(rows)
    w = torch.from_numpy((rng.randn(1000, 512) * 0.1).astype(np.float32))
    x = torch.from_numpy(rng.randn(rows, 512).astype(np.float32))
    q = {k: v.to(cuda_device) for k, v in quant.quantize_weight_w8(w).items()}
    xd = x.to(cuda_device, dtype)
    before = quant.w8a8_matvec.launches
    got = quant.w8a8_matvec(xd, q["weight_q"], q["scales"], q["biases"])
    want = quant.w8a8_matvec_plain(xd, q["weight_q"], q["scales"], q["biases"])
    torch.cuda.synchronize()
    assert quant.w8a8_matvec.launches == before + 1
    # the int32 products are exact on both sides; the fp32 fix-up differs
    # in the order of the row sum only, then bf16 rounds the output
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-5 * scale)


def test_w8a8_kernel_rejects_what_it_does_not_take(cuda_device):
    q = {k: v.to(cuda_device)
         for k, v in quant.quantize_weight_w8(torch.randn(64, 40)).items()}
    with pytest.raises(ValueError, match="IN % 16"):
        quant.w8a8_matvec(torch.randn(2, 40, device=cuda_device),
                          q["weight_q"], q["scales"], q["biases"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,pads", [(64, (0, 63)), (256, (0, 37)),
                                    (512, (200, 5))])
def test_flash_prefill_kernel_matches_plain(cuda_device, dtype, s, pads):
    rng = np.random.RandomState(s)
    b, h, kv, d, cap = 2, 8, 2, 64, s + 40
    q = torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32))
    kc = torch.from_numpy(rng.randn(b, kv, cap, d).astype(np.float32))
    vc = torch.from_numpy(rng.randn(b, kv, cap, d).astype(np.float32))
    q, kc, vc = (t.to(cuda_device, dtype) for t in (q, kc, vc))
    pad = torch.tensor(pads, dtype=torch.int32, device=cuda_device)
    before = attention.flash_prefill_sdpa.launches
    # k/v are strided slices of cache-shaped buffers, read in place
    got = attention.flash_prefill_sdpa(q, kc[:, :, :s], vc[:, :, :s],
                                       d ** -0.5, pad)
    want = attention.flash_prefill_plain(q, kc[:, :, :s], vc[:, :, :s],
                                         d ** -0.5, pad)
    torch.cuda.synchronize()
    assert attention.flash_prefill_sdpa.launches == before + 1
    assert torch.isfinite(got).all()  # also rows before the pad
    # fp32: sum order and expf; bf16: the plain version rounds the
    # probabilities to bf16 before P.V, and both round the output
    atol = 1e-4 if dtype == torch.float32 else 3e-2
    for bi, p0 in enumerate(pads):
        torch.testing.assert_close(got[bi, :, p0:].float(),
                                   want[bi, :, p0:].float(), rtol=0,
                                   atol=atol)
