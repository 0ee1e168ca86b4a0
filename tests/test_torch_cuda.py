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

from csm_mlx_tpu_torch import config as port_config  # noqa: E402
from csm_mlx_tpu_torch.models.csm import CSM, ModelArgs  # noqa: E402
from csm_mlx_tpu_torch.ops import _build, attention, quant  # noqa: E402
from csm_mlx_tpu_torch.ops import flash_train  # noqa: E402
from csm_mlx_tpu_torch.ops import resident_decoder as resident  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("in_dim", [512, 528])
@pytest.mark.parametrize("rows", [1, 3, 8, 64, 65, 100, 128, 300, 513])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8a8_kernel_matches_plain(cuda_device, rows, dtype, in_dim):
    """Up to 64 rows the matvec, above them the tensor-core GEMM (its 128-row
    and 128-channel tiles ragged at 65, 300, 513 rows and 1000 channels;
    IN = 528 is a multiple of 16 but not of its 64-byte k-tile); a second
    call bit-equal."""
    rng = np.random.RandomState(rows)
    w = torch.from_numpy((rng.randn(1000, in_dim) * 0.1).astype(np.float32))
    x = torch.from_numpy(rng.randn(rows, in_dim).astype(np.float32))
    q = {k: v.to(cuda_device) for k, v in quant.quantize_weight_w8(w).items()}
    xd = x.to(cuda_device, dtype)
    before = quant.w8a8_matvec.launches
    gemm_before = quant.w8a8_matvec.gemm_launches
    got = quant.w8a8_matvec(xd, q["weight_q"], q["scales"], q["biases"])
    again = quant.w8a8_matvec(xd, q["weight_q"], q["scales"], q["biases"])
    want = quant.w8a8_matvec_plain(xd, q["weight_q"], q["scales"], q["biases"])
    torch.cuda.synchronize()
    assert quant.w8a8_matvec.launches == before + 2
    assert quant.w8a8_matvec.gemm_launches == gemm_before + (
        2 if rows > quant.W8A8_MATVEC_MAX_ROWS else 0)
    assert torch.equal(got, again)
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
                                    (512, (200, 5)), (512, (64, 130)),
                                    (256, (100, 255)), (2048, (0, 200))])
def test_flash_prefill_kernel_matches_plain(cuda_device, dtype, s, pads):
    """Pads inside the first 64-row tile, across a later one and past the
    first (64: a whole tile; 255: all but one row); a second call
    bit-equal."""
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
    again = attention.flash_prefill_sdpa(q, kc[:, :, :s], vc[:, :, :s],
                                         d ** -0.5, pad)
    want = attention.flash_prefill_plain(q, kc[:, :, :s], vc[:, :, :s],
                                         d ** -0.5, pad)
    torch.cuda.synchronize()
    assert attention.flash_prefill_sdpa.launches == before + 2
    assert torch.isfinite(got).all()  # also rows before the pad
    assert torch.equal(got, again)
    # fp32: sum order and expf; bf16: both round the probabilities to bf16
    # before P.V (in other places), and both round the output
    atol = 1e-4 if dtype == torch.float32 else 3e-2
    for bi, p0 in enumerate(pads):
        torch.testing.assert_close(got[bi, :, p0:].float(),
                                   want[bi, :, p0:].float(), rtol=0,
                                   atol=atol)


def test_flash_prefill_kernel_rejects_what_it_does_not_take(cuda_device):
    """Rows that are not 16-byte aligned raise: the kernel reads q, k and v
    in place and never copies."""
    pad = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    q = torch.zeros((2, 8, 64, 64), device=cuda_device, dtype=torch.bfloat16)
    k = torch.zeros((2, 2, 64, 64), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="S%64"):
        attention.flash_prefill_sdpa(q[:, :, :40], k[:, :, :40],
                                     k[:, :, :40], 1.0, pad)
    odd = torch.zeros((2, 2, 64 * 65 + 4), device=cuda_device,
                      dtype=torch.bfloat16)[..., 4:].view(2, 2, 65, 64)
    with pytest.raises(ValueError, match="16-byte"):
        attention.flash_prefill_sdpa(q, odd[:, :, :64], k, 1.0, pad)


# --- kernel 3: the whole-frame decoder --------------------------------------

# decoders of the tiny test config and of a medium one (full head_dim and
# 32 codebooks, narrow widths); both need heads * head_dim == hidden_size
RESIDENT_CONFIGS = {
    "tiny": (dict(num_hidden_layers=2, num_attention_heads=2,
                  num_key_value_heads=1, head_dim=16, intermediate_size=64,
                  hidden_size=32), 64, 8),
    "medium": (dict(num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, head_dim=128,
                    intermediate_size=1024, hidden_size=512), 300, 32),
}


def i32(value, device):
    """A () int32 tensor on `device`: the per-step scalar kernels 3 and 4
    read from device memory."""
    return torch.tensor(value, dtype=torch.int32, device=device)


def resident_model(name, device, backbone_head_dim=32):
    """A random W8A8 CSM on `device` whose decoder is RESIDENT_CONFIGS[name]
    (a one-layer backbone of two heads of `backbone_head_dim`; kernel 4
    takes 64); `quantize_model` on CUDA prepares kernel 3's tables."""
    dec, vocab, n_cb = RESIDENT_CONFIGS[name]
    key = f"resident_{name}_{backbone_head_dim}"
    port_config.BACKBONE_CONFIGURATION[key] = port_config.LlamaConfig(
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
        head_dim=backbone_head_dim, intermediate_size=128,
        hidden_size=2 * backbone_head_dim)
    port_config.DECODER_CONFIGURATION[key] = port_config.LlamaConfig(**dec)
    args = ModelArgs(key, key, 128, vocab, n_cb)
    gen = torch.Generator(device=device).manual_seed(3)
    model = CSM(args, dtype=torch.float32, generator=gen, device=device)
    model.params["audio_head"] = torch.randn(
        model.params["audio_head"].shape, generator=gen, device=device)
    quant.quantize_model(model, mode="w8a8", min_size=0)
    assert "_resident" in model.params
    return model


def forced_agreement(model, proj01, tokens, kernel_logits):
    """The plain version teacher-forced on the kernel's tokens: the share of
    picks it agrees with, the largest top-2 margin of a disagreeing pick
    and the largest logit error, both in units of the logits row's std."""
    _, logits = resident.resident_decode_frame_plain(
        model.params["_resident"], model.args, proj01, 0.0,
        forced=tokens.long())
    std = logits.std(dim=-1)
    top2 = logits.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]) / std
    flips = logits.argmax(-1) != tokens[1:].long()
    worst = margin[flips].max().item() if bool(flips.any()) else 0.0
    err = ((kernel_logits - logits).abs().amax(-1) / std).max().item()
    return 1.0 - flips.float().mean().item(), worst, err


@pytest.mark.parametrize("rows", [1, 2, 8, 9, 16, 17, 64])
@pytest.mark.parametrize("name", ["tiny", "medium"])
def test_resident_kernel_matches_plain(cuda_device, name, rows):
    """Every block prepares every row up to 8 rows (and recomputes the
    attention at 1 row, and 2 on the tiny model); from 9 rows the per-row
    phases spread over the blocks; the n8 tensor-core tiles are ragged at 2,
    9 and 17 rows. A second launch is bit-equal."""
    model = resident_model(name, cuda_device)
    d = model.args.decoder_config.hidden_size
    gen = torch.Generator(device=cuda_device).manual_seed(rows)
    proj01 = torch.randn((2, rows, d), generator=gen, device=cuda_device)
    before = resident.resident_decode_frame.launches
    toks, logits = resident.resident_decode_frame(
        model.params["_resident"], model.args, proj01, i32(0, cuda_device),
        0.0, return_logits=True)
    again, logits_again = resident.resident_decode_frame(
        model.params["_resident"], model.args, proj01, i32(0, cuda_device),
        0.0, return_logits=True)
    torch.cuda.synchronize()
    assert resident.resident_decode_frame.launches == before + 2
    assert toks.shape == (model.args.n_audio_codebooks, rows)
    assert not toks[0].any() and int(toks.min()) >= 0
    assert int(toks.max()) < model.args.n_audio_vocab
    torch.testing.assert_close(again, toks, rtol=0, atol=0)  # deterministic
    assert torch.equal(logits_again, logits)
    # The plain version sums in the kernel's order (bit-equal on the H100).
    # For a torch whose exp rounds otherwise: int8 requantization turns an
    # ulp into a code step now and then, which grows to ~0.1 of the logits'
    # std through the layers and the KV cache of random weights (as much as
    # the plain version moves when its input moves by 1e-6). So the logits
    # may differ by 0.3 std, and picks only at near-ties below that margin.
    agree, worst, err = forced_agreement(model, proj01, toks, logits)
    assert agree >= 0.99 and worst < 0.3 and err <= 0.3, (agree, worst, err)


def test_resident_kernel_samples_at_temperature(cuda_device):
    """T = 0.8: codebook-1 picks over 1024 rows of one proj01 against
    softmax(plain logits / T), chi-square p >= 1e-3 over the bins with an
    expected count >= 5 and one pooled bin. The head is scaled to a logits
    std of 2.5, so that many tokens carry probability."""
    from scipy import stats

    model = resident_model("medium", cuda_device)
    res, args = dict(model.params["_resident"]), model.args
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    row = torch.randn((2, 1, args.decoder_config.hidden_size), generator=gen,
                      device=cuda_device)
    _, logits = resident.resident_decode_frame_plain(res, args, row, 0.0)
    resident.set_resident_audio_head(
        res, model.params["audio_head"] * (2.5 / logits[0].std().item()),
        res["audio_head_q"].shape[1])
    proj01 = row.expand(2, 64, -1).contiguous()
    picks = torch.cat([resident.resident_decode_frame(
        res, args, proj01, i32(seed, cuda_device), 0.8)[1]
        for seed in range(16)]).cpu().numpy()
    _, logits = resident.resident_decode_frame_plain(res, args, row, 0.0)
    probs = torch.softmax(logits[0, 0] / 0.8, -1).double().cpu().numpy()
    expected = probs * len(picks)
    observed = np.bincount(picks, minlength=len(probs))
    big = expected >= 5
    obs = np.append(observed[big], observed[~big].sum())
    exp = np.append(expected[big], expected[~big].sum())
    p = stats.chi2.sf(((obs - exp) ** 2 / exp).sum(), len(obs) - 1)
    assert big.sum() >= 5 and p >= 1e-3, (big.sum(), p)


@pytest.mark.parametrize("rows", [1, 9])
def test_resident_kernel_phase_records(cuda_device, rows):
    """With the phase-record buffer set, the tokens equal those of the call
    without it, and the records are in time order, one per barrier and a
    last one of kind "end"."""
    model = resident_model("medium", cuda_device)
    res, args = model.params["_resident"], model.args
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    proj01 = torch.randn((2, rows, args.decoder_config.hidden_size),
                         generator=gen, device=cuda_device)
    zero = i32(0, cuda_device)
    want = resident.resident_decode_frame(res, args, proj01, zero, 0.0)
    stamps = torch.zeros((4096, 4), dtype=torch.int64, device=cuda_device)
    resident.resident_decode_frame.stamps = stamps
    try:
        got = resident.resident_decode_frame(res, args, proj01, zero, 0.0)
    finally:
        resident.resident_decode_frame.stamps = None
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    rec = stamps.cpu()
    n = int((rec[:, 0] != 0).sum())
    assert n > 4 * args.n_audio_codebooks
    kinds = rec[:n, 3] & 0xFF
    assert resident.PHASE_KINDS[int(kinds[-1])] == "end"
    assert bool((rec[1:n, 0] >= rec[:n - 1, 2]).all())  # release after arrival
    assert bool((rec[:n, 2] >= rec[:n, 0]).all())


def test_resident_kernel_rejects_what_it_does_not_take(cuda_device):
    model = resident_model("tiny", cuda_device)
    res, args = model.params["_resident"], model.args
    d = args.decoder_config.hidden_size
    zero = i32(0, cuda_device)
    # the seed is a device tensor, never a Python int nor a host tensor
    for seed in (0, torch.tensor(0, dtype=torch.int32), zero.long()):
        with pytest.raises(ValueError, match="seed"):
            resident.resident_decode_frame(
                res, args, torch.zeros((2, 1, d), device=cuda_device), seed,
                0.0)
    with pytest.raises(ValueError, match="rows"):
        resident.resident_decode_frame(
            res, args, torch.zeros((2, 65, d), device=cuda_device), zero,
            0.0)
    with pytest.raises(ValueError, match="float32"):
        resident.resident_decode_frame(
            res, args, torch.zeros((2, 1, d), device=cuda_device,
                                   dtype=torch.bfloat16), zero, 0.0)
    cpu_res = dict(res, norm=res["norm"].cpu())
    with pytest.raises(ValueError, match="norm"):
        resident.resident_decode_frame(
            cpu_res, args, torch.zeros((2, 1, d), device=cuda_device), zero,
            0.0)
    # code tables that break the layout the kernel reads: off a 16-byte
    # boundary (its bulk copies), or not contiguous
    t = res["layers"][1][6]
    buf = torch.empty(t.numel() + 1, dtype=torch.int8, device=cuda_device)
    shifted = buf[1:].view(t.shape)
    shifted.copy_(t)
    for table, what in ((shifted, "aligned"),
                        (t.t().contiguous().t(), "contiguous")):
        broken = dict(res, layers=[list(lw) for lw in res["layers"]])
        broken["layers"][1][6] = table
        with pytest.raises(ValueError, match=what):
            resident.resident_decode_frame(
                broken, args, torch.zeros((2, 1, d), device=cuda_device),
                zero, 0.0)


# --- kernels 6 and 7: causal flash attention for training ------------------


def _flash_inputs(device, dtype, b, h, n_kv, s, seed):
    """q/k/v as transposed (B, S, heads, 64) projections, as the model makes
    them, and a random dO."""
    rng = np.random.RandomState(seed)

    def proj(heads):
        t = torch.from_numpy(rng.randn(b, s, heads, 64).astype(np.float32))
        return t.to(device, dtype).transpose(1, 2)

    return proj(h), proj(n_kv), proj(n_kv), proj(h)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,n_kv,s", [(2, 4, 2, 70), (1, 8, 2, 128),
                                        (2, 32, 8, 575),
                                        # one tile and its edges, with a
                                        # group of 1 and of 4
                                        (1, 4, 4, 1), (2, 8, 2, 1),
                                        (1, 4, 4, 63), (2, 8, 2, 63),
                                        (1, 4, 4, 64), (2, 8, 2, 64),
                                        (1, 4, 4, 65), (2, 8, 2, 65),
                                        (1, 32, 8, 2048)])
def test_flash_train_kernels_match_plain(cuda_device, dtype, b, h, n_kv, s):
    q, k, v, do = _flash_inputs(cuda_device, dtype, b, h, n_kv, s, s)
    scale = 64 ** -0.5
    before = (flash_train.flash_train_fwd.launches,
              flash_train.flash_train_bwd.launches)
    out, lse = flash_train.flash_train_fwd(q, k, v, scale)
    grads = flash_train.flash_train_bwd(q, k, v, out, lse, do, scale)
    want_out, want_lse = flash_train.flash_train_fwd_plain(q, k, v, scale)
    want = flash_train.flash_train_bwd_plain(q, k, v, do, scale)
    torch.cuda.synchronize()
    assert (flash_train.flash_train_fwd.launches,
            flash_train.flash_train_bwd.launches) == (before[0] + 1,
                                                      before[1] + 1)
    assert out.dtype == dtype and all(g.dtype == dtype for g in grads)
    # fp32: sum order and expf only. bf16: both take the same bf16 inputs
    # and sum in fp32; the kernels round P and dS to bf16 where they feed
    # their second products (P V, dS K, P^T dO, dS^T Q), the plain versions
    # keep them fp32; both round the outputs to bf16, and the kernel's delta
    # reads the bf16 O, the plain one its fp32 O. At S = 1 each row attends
    # only itself, so dq = dk = 0 up to the rounding of dP - delta on both
    # sides: their error is taken against dv's scale.
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)
    for name, got, ref in zip(("O", "dq", "dk", "dv"), (out, *grads),
                              (want_out, *want)):
        assert torch.isfinite(got).all()
        ref = ref.float()
        ref_max = ref.abs().max().item()
        if s == 1 and name in ("dq", "dk"):
            ref_max = want[2].abs().max().item()
        torch.testing.assert_close(got.float(), ref, rtol=tol,
                                   atol=tol * ref_max)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_train_kernels_repeat_bit_equal(cuda_device, dtype):
    """Two calls on the same inputs give the same bits: no float atomics,
    every output element summed by one block in a fixed order (KTO's
    step-0 loss of exactly 0.5 and the bit-equal resume depend on it)."""
    q, k, v, do = _flash_inputs(cuda_device, dtype, 2, 32, 8, 575, 7)
    out, lse = flash_train.flash_train_fwd(q, k, v, 0.125)
    out2, lse2 = flash_train.flash_train_fwd(q, k, v, 0.125)
    grads = flash_train.flash_train_bwd(q, k, v, out, lse, do, 0.125)
    grads2 = flash_train.flash_train_bwd(q, k, v, out, lse, do, 0.125)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    for g, g2 in zip(grads, grads2):
        assert torch.equal(g, g2)


def test_flash_attention_autograd_on_card(cuda_device):
    """flash_attention's gradient on the card against autograd through the
    masked sdpa, fp32, with q/k/v as strided views."""
    q, k, v, do = _flash_inputs(cuda_device, torch.float32, 1, 8, 2, 200, 3)
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = flash_train.flash_attention(q, k, v, 0.125)
    got = torch.autograd.grad(out, (q, k, v), do)
    ref_out = attention.sdpa(q, k, v, 0.125, attention.causal_mask_bias(
        200, 200, device=cuda_device)[None, None])
    want = torch.autograd.grad(ref_out, (q, k, v), do)
    torch.testing.assert_close(out, ref_out, rtol=1e-4, atol=1e-4)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_flash_train_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros((1, 4, 64, 32), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim 64"):
        flash_train.flash_train_fwd(q, q[:, :2], q[:, :2], 1.0)
    q = torch.zeros((1, 4, 64, 64), device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        flash_train.flash_train_fwd(q, q[:, :2], q[:, :2], 1.0)


def test_lora_train_step_on_card(cuda_device, tmp_path):
    """One LoRA train_step of a small CUDA model whose backbone has
    head_dim 64 and a sequence past flash_min_len: kernels 6 and 7 run
    (remat: two forwards a layer), only the adapters move, and the loss and
    adapters agree with the same step on the CPU (plain versions)."""
    from csm_mlx_tpu_torch.finetune import lora
    from csm_mlx_tpu_torch.finetune import trainer as ft
    from csm_mlx_tpu_torch.loaders import tree_to_flat

    port_config.BACKBONE_CONFIGURATION["train_small"] = port_config.LlamaConfig(
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=64, intermediate_size=512, hidden_size=256)
    port_config.DECODER_CONFIGURATION["train_small"] = port_config.LlamaConfig(
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
        head_dim=64, intermediate_size=256, hidden_size=128)
    args = ModelArgs("train_small", "train_small", 128, 64, 8)
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(0, 64, size=(2, 80, 9)).astype(np.int32),
             "masks": np.ones((2, 80, 9), dtype=np.int32),
             "loss_masks": np.ones((2, 80, 9), dtype=np.int32)}
    cpu_model = CSM(args, dtype=torch.float32, device="cpu",
                    generator=torch.Generator().manual_seed(1))
    lora.linear_to_lora_layers(cpu_model, {"rank": 4, "keys": ["attn"]})
    gen = torch.Generator().manual_seed(2)
    for name, p in tree_to_flat(cpu_model.params).items():
        if name.endswith("lora_b") or name == "audio_head":  # zero at init
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    cuda_model = CSM(args, params=_to_device(cpu_model.params, cuda_device),
                     dtype=torch.float32)
    base = {k: v.clone() for k, v in tree_to_flat(cuda_model.params).items()
            if not lora.trainable_filter(k)}
    steps = []
    for m in (cuda_model, cpu_model):
        tr = ft.CSMTrainer(ft.TrainArgs(
            model=m, optimizer=ft.build_optimizer("sgd", 0.1),
            output_dir=tmp_path / m.device.type, ckpt_freq=0, max_norm=0.0,
            gradient_checkpointing=True, flash_min_len=64,
            trainable_filter=lora.trainable_filter))
        before = (flash_train.flash_train_fwd.launches,
                  flash_train.flash_train_bwd.launches)
        steps.append(tr.train_step(batch))
        after = (flash_train.flash_train_fwd.launches,
                 flash_train.flash_train_bwd.launches)
        if m is cuda_model:
            assert (after[0] - before[0], after[1] - before[1]) == (4, 2)
        else:
            assert after == before
    torch.cuda.synchronize()
    np.testing.assert_allclose(steps[0], steps[1], rtol=1e-4)
    flat_c, flat_p = tree_to_flat(cuda_model.params), tree_to_flat(
        cpu_model.params)
    for k, v in base.items():
        assert torch.equal(flat_c[k], v), k
    for k, v in flat_p.items():
        if lora.trainable_filter(k):
            torch.testing.assert_close(flat_c[k].cpu(), v, rtol=1e-4,
                                       atol=1e-5)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.detach().to(device).clone()


# --- kernel 5: the grouped-affine dequant matvec ----------------------------


# fp32: rows 1, 2, 3 and 8 each take their own row tile (1, 2, 4, 8), 64
# takes 8; bf16: one n8 tile per 8 rows, 16, 17 and 33 at a tile's edges.
# OUT 1000 is ragged against the 15-row tiles; IN 8192 splits IN across a
# cluster of blocks.
@pytest.mark.parametrize("rows", [1, 2, 3, 8, 16, 17, 33, 64])
@pytest.mark.parametrize("bits,group,in_dim,out_dim",
                         [(4, 64, 2048, 1000), (8, 64, 1024, 1000),
                          (4, 128, 512, 1000), (4, 48, 480, 1000),
                          (8, 16, 272, 1000), (4, 64, 8192, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_affine_kernel_matches_plain(cuda_device, dtype, bits, group, in_dim,
                                     out_dim, rows):
    rng = np.random.RandomState(rows + group)
    w = torch.from_numpy((rng.randn(out_dim, in_dim) * 0.1).astype(np.float32))
    x = torch.from_numpy(rng.randn(rows, in_dim).astype(np.float32))
    q = {k: v.to(cuda_device)
         for k, v in quant.quantize_weight(w, bits, group).items()}
    xd = x.to(cuda_device, dtype)
    before = quant.affine_matvec.launches
    got = quant.affine_matvec(xd, q["weight_q"], q["scales"], q["biases"])
    want = quant.affine_matvec_plain(xd, q["weight_q"], q["scales"],
                                     q["biases"])
    torch.cuda.synchronize()
    assert quant.affine_matvec.launches == before + 1
    assert got.dtype == dtype and got.shape == (rows, out_dim)
    # the same weights: fp32 dequantized per weight (fp32), or s * sum(q x)
    # + z * sum(x) per group with exact products (bf16); fp32 sums in
    # another order, then bf16 rounds the output
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("bits,group,in_dim,out_dim", [(4, 64, 2048, 1000),
                                                       (8, 64, 8192, 1024),
                                                       (4, 48, 480, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_affine_kernel_rows_bit_identical_across_b(cuda_device, dtype, bits,
                                                   group, in_dim, out_dim):
    """A row's output does not depend on the rows launched beside it, and
    a repeat gives the same bits: rows of a 64-row call against calls on
    their first B rows and on single rows, and 70 rows (two launch chunks).
    bf16 has two routes, split at the library's csm_affine_core_rows():
    rows agree within a route."""
    rng = np.random.RandomState(in_dim + bits)
    w = torch.from_numpy((rng.randn(out_dim, in_dim) * 0.1).astype(np.float32))
    q = {k: v.to(cuda_device)
         for k, v in quant.quantize_weight(w, bits, group).items()}
    x = torch.from_numpy(rng.randn(70, in_dim).astype(np.float32)).to(
        cuda_device, dtype)

    def run(xs):
        return quant.affine_matvec(xs, q["weight_q"], q["scales"],
                                   q["biases"])

    full = run(x[:64])
    assert torch.equal(run(x[:64]), full)
    core_rows = _build.library().csm_affine_core_rows()
    edge = core_rows if dtype == torch.bfloat16 else 0
    for b in (1, 2, 3, 8, 16, 17, 32, 33):
        if b > edge:
            assert torch.equal(run(x[:b]), full[:b]), b
    for r in (0, 9, 40, 63):
        one = run(x[r:r + 1])
        if edge:  # one and two bf16 rows both take the CUDA-core route
            assert torch.equal(one, run(x[r:r + 2])[:1]), r
        else:
            assert torch.equal(one, full[r:r + 1]), r
    assert torch.equal(run(x)[:64], full)


def test_affine_quant_linear_routes_on_card(cuda_device):
    """quant_linear on the card: kernel 5 at <= 64 rows, the dequant matmul
    above, both near the plain version."""
    w = torch.randn(256, 512, device=cuda_device) * 0.1
    q = quant.quantize_weight(w, 4, 64)
    for rows, launched in ((64, 1), (65, 0)):
        x = torch.randn(rows, 512, device=cuda_device)
        before = quant.affine_matvec.launches
        got = quant.quant_linear(q, x)
        assert quant.affine_matvec.launches - before == launched
        want = quant.affine_matvec_plain(x, q["weight_q"], q["scales"],
                                         q["biases"])
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_affine_kernel_rejects_what_it_does_not_take(cuda_device):
    q = {k: v.to(cuda_device)
         for k, v in quant.quantize_weight(torch.randn(64, 72), 8, 24).items()}
    with pytest.raises(ValueError, match="multiple of 16"):
        quant.affine_matvec(torch.randn(2, 72, device=cuda_device),
                            q["weight_q"], q["scales"], q["biases"])
    q = {k: v.to(cuda_device)
         for k, v in quant.quantize_weight(torch.randn(64, 64)).items()}
    with pytest.raises(ValueError, match="fit neither"):
        quant.affine_matvec(torch.randn(2, 96, device=cuda_device),
                            q["weight_q"], q["scales"], q["biases"])


# --- kernel 4: flash-decode attention -------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,n_kv,cap,index", [(8, 32, 8, 157, 140),
                                                (3, 8, 2, 1000, 999),
                                                (2, 8, 8, 64, 0),
                                                (4, 16, 2, 77, 30),
                                                (8, 32, 8, 2048, 255),
                                                (8, 32, 8, 2048, 256),
                                                (2, 32, 8, 2048, 1000)])
def test_flash_decode_kernel_matches_plain(cuda_device, dtype, b, h, n_kv,
                                           cap, index):
    """Per-row pads up to index (one row past it: no valid key, a uniform
    average as in the masked softmax); k/v are the layer views of a
    2-layer cache, q a transposed projection. The cache splits over
    blocks (8 chunks of 256 keys at B=8, cap 2048: index on the last slot
    of a chunk and on the first of the next; 16 of 64 at cap 1000, which
    no split count divides); at cap 2048, B=2 the first row's pad lies in
    index's chunk. A second call is bit-equal."""
    rng = np.random.RandomState(cap)
    q = torch.from_numpy(rng.randn(b, 1, h, 64).astype(np.float32))
    kc = torch.from_numpy(rng.randn(2, b, n_kv, cap, 64).astype(np.float32))
    vc = torch.from_numpy(rng.randn(2, b, n_kv, cap, 64).astype(np.float32))
    q, kc, vc = (t.to(cuda_device, dtype) for t in (q, kc, vc))
    q = q.transpose(1, 2)
    pads = rng.randint(0, index + 1, (b,))
    pads[-1] = index + 1 if index + 1 < cap else pads[-1]
    if cap == 2048 and b == 2:
        pads[0] = index - 20
    pad = torch.from_numpy(pads).to(cuda_device)
    before = attention.flash_decode_sdpa.launches
    idx = i32(index, cuda_device)
    got = attention.flash_decode_sdpa(q, kc[1], vc[1], 0.125, pad, idx)
    again = attention.flash_decode_sdpa(q, kc[1], vc[1], 0.125, pad, idx)
    want = attention.flash_decode_plain(q, kc[1], vc[1], 0.125, pad, idx)
    torch.cuda.synchronize()
    assert attention.flash_decode_sdpa.launches == before + 2
    assert got.shape == (b, h, 1, 64) and torch.isfinite(got).all()
    assert torch.equal(got, again)
    # fp32: sum order and expf; bf16: both round the normalised
    # probabilities to bf16 before P.V (as the JAX sdpa), summing in other
    # orders, and both round the output. bf16's absolute part shrinks
    # with the output's largest magnitude: averages over ~1000 keys are small
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    atol = tol if dtype == torch.float32 else \
        tol * min(1.0, want.float().abs().max().item())
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_on_a_prefix_view(cuda_device, dtype):
    """Kernel 4 over the first 768 slots of a 1,890-slot cache layer, the
    view a continuous engine's bucket graph reads (its slots rows of the
    full buffer, not contiguous), against the plain version on a
    contiguous copy of the same keys."""
    rng = np.random.RandomState(11)
    b, h, n_kv, cap, bucket, index = 8, 32, 8, 1890, 768, 700
    kc, vc = (torch.from_numpy(rng.randn(2, b, n_kv, cap, 64).astype(
        np.float32)).to(cuda_device, dtype) for _ in range(2))
    q = torch.from_numpy(rng.randn(b, h, 1, 64).astype(np.float32)).to(
        cuda_device, dtype)
    pad = torch.from_numpy(rng.randint(0, index + 1, (b,))).to(cuda_device)
    k, v = kc[1, :, :, :bucket], vc[1, :, :, :bucket]
    assert not k.is_contiguous()
    idx = i32(index, cuda_device)
    got = attention.flash_decode_sdpa(q, k, v, 0.125, pad, idx)
    want = attention.flash_decode_plain(q, k.contiguous(), v.contiguous(),
                                        0.125, pad, idx)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    atol = tol if dtype == torch.float32 else \
        tol * min(1.0, want.float().abs().max().item())
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=atol)


def test_flash_decode_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros((2, 8, 1, 32), device=cuda_device)
    k = torch.zeros((2, 2, 40, 32), device=cuda_device)
    pad = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    three = i32(3, cuda_device)
    with pytest.raises(ValueError, match="D=64"):
        attention.flash_decode_sdpa(q, k, k, 1.0, pad, three)
    q = torch.zeros((2, 6, 1, 64), device=cuda_device)
    k = torch.zeros((2, 2, 40, 64), device=cuda_device)
    with pytest.raises(ValueError, match="H/n_kv"):
        attention.flash_decode_sdpa(q, k, k, 1.0, pad, three)
    q = torch.zeros((2, 8, 1, 64), device=cuda_device)
    # the index is a device tensor, never a Python int nor a host tensor
    for index in (3, torch.tensor(3, dtype=torch.int32),
                  i32([3, 4], cuda_device), three.long()):
        with pytest.raises(ValueError, match="index"):
            attention.flash_decode_sdpa(q, k, k, 1.0, pad, index)


# --- the captured frame step (CUDA graphs) ----------------------------------


def _prompt(args, s, seed):
    rng = np.random.RandomState(seed)
    prompt = np.zeros((s, args.n_audio_codebooks + 1), dtype=np.int32)
    prompt[:, -1] = rng.randint(0, args.n_text_vocab, size=s)
    mask = np.zeros_like(prompt)
    mask[:, -1] = 1
    return prompt, mask


@pytest.mark.parametrize("decoder", ["kernel 3", "dispatched"])
def test_captured_frames_equal_eager(cuda_device, decoder):
    """Greedy frames of the replayed graph equal the eager step's, token
    for token, at B = 1 and 3; every replayed frame counts its kernel-3
    launch."""
    from csm_mlx_tpu_torch import generation

    model = resident_model("tiny", cuda_device)
    if decoder == "dispatched":
        model = CSM(model.args, params={k: v for k, v in model.params.items()
                                        if k != "_resident"},
                    dtype=model.dtype)
    prompts = [_prompt(model.args, s, s) for s in (5, 12, 30)]
    for rows in (1, 3):
        ps, ms = zip(*prompts[:rows])
        before = resident.resident_decode_frame.launches
        got, n = generation.generate_tokens_batch(model, ps, ms, 12,
                                                  temperature=0.0)
        launched = resident.resident_decode_frame.launches - before
        want, n_want = generation.generate_tokens_batch(
            model, ps, ms, 12, temperature=0.0, _eager_step=True)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(n, n_want)
        assert launched == (12 if decoder == "kernel 3" else 0)
        again, _ = generation.generate_tokens_batch(model, ps, ms, 12,
                                                    temperature=0.0)
        np.testing.assert_array_equal(again, want)  # the cached graph


def test_captured_stream_equals_eager(cuda_device, monkeypatch):
    """stream_generate with its Mimi step in the graph: the chunks equal the
    eager step's (the same kernels on the same inputs), and the batch
    decode of the same frames within 1e-4 of its largest magnitude (fp32,
    TF32 off: the ring's attention sums in another order)."""
    from csm_mlx_tpu_torch import generation, tokenizers
    from csm_mlx_tpu_torch.models.mimi import Mimi, MimiConfig

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    model = resident_model("tiny", cuda_device)
    cfg = MimiConfig(sampling_rate=240, hidden_size=16, num_filters=4,
                     upsampling_ratios=(4, 3), codebook_size=32,
                     codebook_dim=8, num_quantizers=8, upsample_groups=16,
                     num_hidden_layers=2, intermediate_size=32,
                     num_attention_heads=2, num_key_value_heads=2,
                     head_dim=8, sliding_window=6, frame_rate=10.0)
    mimi = Mimi(cfg, generator=torch.Generator(device=cuda_device)
                .manual_seed(4), device=cuda_device)
    prompt, mask = _prompt(model.args, 9, 9)
    monkeypatch.setattr(tokenizers, "tokenize_text_segment",
                        lambda *a: (prompt, mask))
    kw = dict(max_audio_length_ms=1600, temperature=0.0, mimi=mimi)
    got = torch.stack(list(generation.stream_generate(model, "t", 0, **kw)))
    want = torch.stack(list(generation.stream_generate(
        model, "t", 0, _eager_step=True, **kw)))
    assert got.shape == want.shape == (20, cfg.frame_size)
    assert torch.equal(got, want)
    frames, n = generation.generate_tokens(model, prompt, mask, 20,
                                           temperature=0.0)
    wav = mimi.decode(torch.from_numpy(frames.T[None].copy()))[0, 0].cpu()
    err = (got.flatten() - wav).abs().max().item()
    assert n == 20 and err <= 1e-4 * wav.abs().max().item(), err


def test_interleaved_captured_streams_equal_their_solo_runs(cuda_device,
                                                           monkeypatch):
    """Two streams with the same settings, consumed in turn on the card:
    the second, started while the first holds the kept frame step, builds
    its own, and each yields its solo run's chunks; the kept step is used
    again after both end."""
    from csm_mlx_tpu_torch import generation, tokenizers
    from csm_mlx_tpu_torch.models.mimi import Mimi, MimiConfig

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    model = resident_model("tiny", cuda_device)
    cfg = MimiConfig(sampling_rate=240, hidden_size=16, num_filters=4,
                     upsampling_ratios=(4, 3), codebook_size=32,
                     codebook_dim=8, num_quantizers=8, upsample_groups=16,
                     num_hidden_layers=2, intermediate_size=32,
                     num_attention_heads=2, num_key_value_heads=2,
                     head_dim=8, sliding_window=6, frame_rate=10.0)
    mimi = Mimi(cfg, generator=torch.Generator(device=cuda_device)
                .manual_seed(4), device=cuda_device)
    prompts = {"a": _prompt(model.args, 9, 9), "b": _prompt(model.args, 7, 3)}
    monkeypatch.setattr(tokenizers, "tokenize_text_segment",
                        lambda text, *a: prompts[text])

    def stream(text):
        return generation.stream_generate(
            model, text, 0, max_audio_length_ms=1200, temperature=0.0,
            mimi=mimi)

    solo = {t: torch.stack(list(stream(t))) for t in prompts}
    assert not torch.equal(solo["a"], solo["b"])
    kept = list(model.frame_steps.values())
    assert len(kept) == 1 and kept[0].graph is not None
    its = {t: stream(t) for t in prompts}
    got = {t: [] for t in prompts}
    for _ in range(15):
        for t, it in its.items():
            got[t].append(next(it))
    for t in prompts:
        assert next(its[t], None) is None
        assert torch.equal(torch.stack(got[t]), solo[t]), t
    assert len(model.frame_steps) == 1
    step = next(iter(model.frame_steps.values()))
    assert torch.equal(torch.stack(list(stream("b"))), solo["b"])
    assert next(iter(model.frame_steps.values())) is step


def test_captured_step_draws_anew_at_temperature(cuda_device):
    """T = 0.8: each replay draws new kernel-3 seeds and new c0 tokens from
    the caller's generator, registered with the graph."""
    from csm_mlx_tpu_torch import generation
    from csm_mlx_tpu_torch.ops.sampling import SamplerConfig

    model = resident_model("tiny", cuda_device)
    head = model.params["codebook0_head"]
    for key in head:  # zero logits: c0 uniform over the vocabulary
        head[key] = torch.zeros_like(head[key])
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    prompt, mask = _prompt(model.args, 6, 6)
    tokens, masks, pad, bucket = generation._pad_prompt(prompt, mask)
    step = generation.FrameStep(model, 1, bucket + 40,
                                SamplerConfig(temperature=0.8), (), gen)
    assert step.capture
    step.first(step.prefill(tokens, masks, pad))
    seeds, c0 = [], []
    for _ in range(30):
        step()
        seeds.append(int(step.seeds[0]))
        c0.append(int(step.frame[0, 0]))
    assert step.replays == 29 and step.graph is not None
    assert len(set(seeds)) == 30 and len(set(c0)) >= 10, (seeds, c0)


def test_kernels_read_their_scalars_from_device_memory(cuda_device):
    """Kernel 3's seed and kernel 4's index are read by the kernels: one
    captured launch of each, replayed after the scalar is changed in place,
    equals a direct call with the new value (bit for bit), and kernel 4
    equals its plain version at each index."""
    model = resident_model("medium", cuda_device)
    res, args = model.params["_resident"], model.args
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    proj01 = torch.randn((2, 4, args.decoder_config.hidden_size),
                         generator=gen, device=cuda_device)
    seed = torch.zeros((1,), dtype=torch.int32, device=cuda_device)
    resident.resident_decode_frame(res, args, proj01, seed, 0.8)  # warm-up
    b, n_kv, cap = 8, 8, 157
    q = torch.randn((b, 32, 1, 64), generator=gen, device=cuda_device)
    k = torch.randn((b, n_kv, cap, 64), generator=gen, device=cuda_device)
    v = torch.randn((b, n_kv, cap, 64), generator=gen, device=cuda_device)
    pad = torch.arange(b, device=cuda_device)
    index = torch.zeros((), dtype=torch.int32, device=cuda_device)
    attention.flash_decode_sdpa(q, k, v, 0.125, pad, index)  # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        toks = resident.resident_decode_frame(res, args, proj01, seed, 0.8)
        out = attention.flash_decode_sdpa(q, k, v, 0.125, pad, index)
    picks = []
    for s, i in ((11, 20), (12, 100), (11, 156)):
        seed.fill_(s)
        index.fill_(i)
        graph.replay()
        want = resident.resident_decode_frame(res, args, proj01,
                                              i32(s, cuda_device), 0.8)
        direct = attention.flash_decode_sdpa(q, k, v, 0.125, pad,
                                             i32(i, cuda_device))
        plain = attention.flash_decode_plain(q, k, v, 0.125, pad, index)
        torch.cuda.synchronize()
        assert torch.equal(toks, want) and torch.equal(out, direct)
        torch.testing.assert_close(out, plain, rtol=2e-5, atol=2e-5)
        picks.append(toks.clone())
    assert not torch.equal(picks[0], picks[1])
    assert torch.equal(picks[0], picks[2])  # the same seed, the same draw


# --- context audio: the Mimi encoder and generate(context=...) --------------


def _tiny_codec(device):
    from csm_mlx_tpu_torch.models.mimi import Mimi, MimiConfig

    cfg = MimiConfig(sampling_rate=240, hidden_size=16, num_filters=4,
                     upsampling_ratios=(4, 3), codebook_size=32,
                     codebook_dim=8, num_quantizers=8, upsample_groups=16,
                     num_hidden_layers=2, intermediate_size=32,
                     num_attention_heads=2, num_key_value_heads=2,
                     head_dim=8, sliding_window=6, frame_rate=10.0)
    return Mimi(cfg, generator=torch.Generator(device=device).manual_seed(4),
                device=device)


def test_mimi_encoder_on_card_matches_cpu(cuda_device, monkeypatch):
    """The tiny codec's encode on the card against its CPU copy (fp32, TF32
    off: sum order only): the latent within 1e-5 of its largest magnitude,
    the codes equal; the streamed encode_step equals the batch encode."""
    from csm_mlx_tpu_torch.models.mimi import Mimi
    from csm_mlx_tpu_torch.models.mimi.mimi import mimi_encode_latent

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    card = _tiny_codec(cuda_device)
    cpu = Mimi(card.cfg, params=_to_cpu(card.params))
    fs, f = card.frame_size, 20
    audio = torch.from_numpy((0.5 * np.random.RandomState(8).randn(
        2, 1, f * fs)).astype(np.float32))
    want = mimi_encode_latent(cpu.params, cpu.cfg, audio)
    got = mimi_encode_latent(card.params, card.cfg, audio.to(cuda_device))
    err = (got.cpu() - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err
    codes = card.encode(audio)
    assert codes.device.type == "cuda" and codes.shape == (2, 8, f)
    assert torch.equal(codes.cpu(), cpu.encode(audio))
    state = card.init_encode_state(batch=2)
    streamed = torch.cat([card.encode_step(audio[:, :, i * fs:(i + 1) * fs],
                                           state)[0] for i in range(f)],
                         dim=-1)
    assert torch.equal(streamed, codes)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


def test_generate_with_context_through_the_captured_step(cuda_device,
                                                         monkeypatch):
    """generate(context=...) on the card: the context's audio encoded on the
    card into the prompt, the frames through the replayed graph (one
    kernel-3 launch a frame), the waveform equal to the decode of the eager
    step's frames of the same prompt."""
    from csm_mlx_tpu_torch import generation, tokenizers
    from csm_mlx_tpu_torch.segment import Segment

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    model = resident_model("tiny", cuda_device)
    mimi = _tiny_codec(cuda_device)
    prompt, mask = _prompt(model.args, 9, 9)
    monkeypatch.setattr(tokenizers, "tokenize_text_segment",
                        lambda *a: (prompt, mask))
    audio = (0.3 * np.sin(np.arange(5 * mimi.frame_size) * 0.3)).astype(
        np.float32)
    ctx = [Segment(1, "before", audio)]
    before = resident.resident_decode_frame.launches
    wav = generation.generate(model, "t", 0, ctx, 1600, temperature=0.0,
                              mimi=mimi)
    launched = resident.resident_decode_frame.launches - before
    full, full_mask = generation._assemble_prompt(model, "t", 0, ctx, mimi)
    assert full.shape[0] == 9 + 6 + 9 and full[9:14, :-1].any()
    frames, n = generation.generate_tokens(model, full, full_mask, 20,
                                           temperature=0.0, _eager_step=True)
    want = mimi.decode(torch.from_numpy(frames.T[None].copy()))[0, 0]
    assert n >= 1 and launched == (n if n == 20 else n + 1)  # and EOS's
    assert wav.shape == (n * mimi.frame_size,) and torch.equal(wav, want)


# --- serving: the codec singleton and the continuous engine ------------------


def test_codec_singleton_cuda_and_cuda0_are_one(cuda_device, monkeypatch,
                                                tmp_path):
    """A codec installed from a path on "cuda" is the one a call on
    "cuda:0" (or with no device) gets, and no random-init codec is made
    beside it."""
    from csm_mlx_tpu_torch import tokenizers
    from csm_mlx_tpu_torch.models.mimi import mimi as mimi_module
    from csm_mlx_tpu_torch.models.mimi import weights

    path = tmp_path / "mimi.safetensors"
    path.write_bytes(b"")
    real_init = mimi_module.init_mimi_params
    loads = []

    def fake_load(p, cfg, dtype=torch.float32, device=None):
        loads.append((p, str(device)))
        return real_init(torch.Generator(device=device).manual_seed(5), cfg,
                         dtype, device)

    def no_random_init(*a, **k):
        raise AssertionError("a random-init codec beside an installed one")

    monkeypatch.delenv(tokenizers.MIMI_WEIGHTS_ENV, raising=False)
    monkeypatch.setattr(weights, "load_mimi_checkpoint", fake_load)
    tokenizers.get_audio_tokenizer.cache_clear()
    try:
        codec = tokenizers.get_audio_tokenizer(8, str(path), device="cuda")
        monkeypatch.setattr(mimi_module, "init_mimi_params", no_random_init)
        assert tokenizers.get_audio_tokenizer(8, device="cuda:0") is codec
        assert tokenizers.get_audio_tokenizer(8) is codec
        assert tokenizers.get_audio_tokenizer(8, str(path),
                                              device="cuda:0") is codec
        # another device loads the same path there
        cpu = tokenizers.get_audio_tokenizer(8, device="cpu")
        assert cpu is not codec and loads == [(str(path), "cuda:0"),
                                              (str(path), "cpu")]
    finally:
        tokenizers.get_audio_tokenizer.cache_clear()


def _engine_requests(model, n, seed=0):
    rng = np.random.RandomState(seed)
    return [(*_prompt(model.args, int(rng.randint(4, 20)), 100 + i),
             int(rng.randint(3, 16))) for i in range(n)]


def _run_engine(model, requests, **kw):
    """Every request through a fresh engine: (frames, audio) per request,
    and the engine."""
    from csm_mlx_tpu_torch.continuous import ContinuousEngine

    kw.setdefault("n_slots", 3)
    kw.setdefault("max_frames", 16)
    kw.setdefault("max_prompt_bucket", 32)
    kw.setdefault("capacity_slack", 16)
    kw.setdefault("frames_per_step", 3)
    eng = ContinuousEngine(
        model, temperature=0.0,
        generator=torch.Generator(device=model.device).manual_seed(1), **kw)
    res = [eng.submit_prompt(p, m, max_frames=mf) for p, m, mf in requests]
    eng.run_until_idle()
    return [(r.wait(0), r.audio()) for r in res], eng


def test_engine_captured_blocks_equal_eager(cuda_device):
    """The continuous engine's blocks as replayed graphs against the same
    blocks run eagerly: equal frames and equal chunks, more requests than
    slots; one kernel-3 launch a frame stepped and a row admitted."""
    from csm_mlx_tpu_torch.ops import launches

    model = resident_model("tiny", cuda_device)
    mimi = _tiny_codec(cuda_device)
    requests = _engine_requests(model, 7)
    launches.reset()
    got, eng = _run_engine(model, requests, mimi=mimi)
    k3 = resident.resident_decode_frame.launches
    want, eager = _run_engine(model, requests, mimi=mimi, eager=True)
    assert eng.stats.graph_captures == 1 and eager.stats.graph_captures == 0
    for (frames, audio), (wframes, waudio) in zip(got, want):
        np.testing.assert_array_equal(frames, wframes)
        assert audio.shape == (frames.shape[0] * mimi.frame_size,)
        np.testing.assert_array_equal(audio, waudio)
    # admissions run kernel 3 once a same-bucket group (<= 16 rows)
    blocks = eng.stats.steps * eng.frames_per_step
    assert blocks < k3 <= blocks + eng.stats.admissions


def test_engine_bucket_graphs_are_kept(cuda_device, monkeypatch):
    """A long stream grows the engine's bucket past two edges, short ones
    after it rebase and shrink it: each bucket's graph is captured once and
    kept (no capture when a bucket comes back), and the frames equal the
    eager engine's."""
    import functools

    from csm_mlx_tpu_torch import continuous

    monkeypatch.setattr(continuous, "kv_prefix_buckets", functools.partial(
        attention.kv_prefix_buckets, min_capacity=0, start=64, step=64))
    model = resident_model("tiny", cuda_device)
    requests = [(*_prompt(model.args, 6, 1), 150)] + [
        (*_prompt(model.args, 5 + i, 2 + i), 6) for i in range(3)]

    def run(eager):
        from csm_mlx_tpu_torch.continuous import ContinuousEngine

        eng = ContinuousEngine(model, n_slots=2, max_frames=200,
                               max_prompt_bucket=32, capacity_slack=16,
                               frames_per_step=3, codec=False, eager=eager,
                               generator=torch.Generator(
                                   device=cuda_device).manual_seed(1))
        eng._EAGER_REBASE_SHIFT = 48
        eng._SHRINK_HYSTERESIS = 16
        long = eng.submit_prompt(*requests[0])
        eng.run_until_idle()
        captured = eng.stats.graph_captures
        rest = [eng.submit_prompt(p, m, max_frames=mf)
                for p, m, mf in requests[1:]]
        eng.run_until_idle()
        return [r.wait(0) for r in [long] + rest], eng, captured

    got, eng, captured = run(False)
    want, _, _ = run(True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert eng.stats.cache_grows >= 2 and eng.stats.rebases >= 1
    assert eng.kv_capacity == 64  # shrunk back to a bucket used before
    graphs = [b for b, g in eng._graphs.items() if g != "warm"]
    assert captured >= 2 and eng.stats.graph_captures == len(graphs)
    assert 64 in graphs


def test_engine_pipelined_fetch_equals_depth_one(cuda_device):
    """Two blocks in flight (block k+1 replayed before block k is read,
    each flight in its own pinned buffers) give the frames and chunks of
    one in flight."""
    model = resident_model("tiny", cuda_device)
    mimi = _tiny_codec(cuda_device)
    requests = _engine_requests(model, 6, seed=3)
    got, _ = _run_engine(model, requests, mimi=mimi, pipeline_depth=2)
    want, _ = _run_engine(model, requests, mimi=mimi, pipeline_depth=1)
    for (frames, audio), (wframes, waudio) in zip(got, want):
        np.testing.assert_array_equal(frames, wframes)
        np.testing.assert_array_equal(audio, waudio)


def test_engine_with_kernel_4_equals_the_engine_without(cuda_device,
                                                        monkeypatch):
    """`flash_decode_min_b=1`: every backbone step of a block runs its
    attention through kernel 4, over a bucket's prefix view of the cache
    (buckets of 64 slots in a cache of 88); frames and chunks equal the
    same engine's without it, fp32."""
    import functools

    from csm_mlx_tpu_torch import continuous

    monkeypatch.setattr(continuous, "kv_prefix_buckets", functools.partial(
        attention.kv_prefix_buckets, min_capacity=0, start=64, step=64))
    model = resident_model("tiny", cuda_device, backbone_head_dim=64)
    mimi = _tiny_codec(cuda_device)
    requests = _engine_requests(model, 7, seed=5)
    before = attention.flash_decode_sdpa.launches
    got, eng = _run_engine(model, requests, mimi=mimi, max_frames=40,
                           flash_decode_min_b=1)
    launched = attention.flash_decode_sdpa.launches - before
    want, plain = _run_engine(model, requests, mimi=mimi, max_frames=40)
    assert eng.capacity == 88 and 64 in eng._graphs
    layers = model.args.backbone_config.num_hidden_layers
    assert launched == layers * eng.frames_per_step * eng.stats.steps > 0
    assert plain.stats.steps == eng.stats.steps
    for (frames, audio), (wframes, waudio) in zip(got, want):
        np.testing.assert_array_equal(frames, wframes)
        np.testing.assert_array_equal(audio, waudio)
