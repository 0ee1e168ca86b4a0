"""CSM training loss (port of `csm_mlx_tpu/finetune/loss.py`).

Per batch of (B, S, 33) frame tokens with input masks and loss masks:
- the backbone consumes frames 0..S-2 (masked-sum embeddings) and predicts
  codebook 0 of the next frame (shift-by-one targets), scored by
  `codebook0_head` and weighted by `first_codebook_weight_multiplier`;
- the decoder runs teacher-forced over every frame: B*(S-1) rows of
  [backbone hidden, 32 audio embeddings], codebooks 1..31 scored against
  `audio_head[i-1]`;
- each codebook's CE is mask-averaged (a safe mean: no NaN without valid
  targets), then averaged over the 32 codebooks; logits and CE are fp32.

`decoder_loss_fraction` < 1 trains the decoder on a random subset of frame
rows, drawn from `generator`. `per_sample=True` returns (B,) losses for
DPO/KTO; `cause_mismatch=True` rolls the targets by one frame (the KTO KL
proxy).

`data_group` makes the batch one rank's rows of a global batch split over
the ranks of a process group in order, equally (the trainers' "data"
axis): each masked mean then divides this rank's sum by the global count
(an all-reduce), so that the losses of the ranks add up to the global
batch's, and their gradients, summed, to its gradient; the decoder's rows
are drawn over the global rows, from the same generator state on every
rank. The backbone takes the flash-attention kernels
(`ops.flash_train`) when S - 1 >= `flash_min_len` (0 disables them): the
JAX package reads that threshold from CSM_TPU_FLASH_TRAIN, the port takes
it as an argument, with the same default.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from csm_mlx_tpu_torch.models.csm import ModelArgs, embed_tokens
from csm_mlx_tpu_torch.models.llama import llama_forward
from csm_mlx_tpu_torch.ops.attention import causal_mask_bias
from csm_mlx_tpu_torch.ops.layers import emb_table, linear
from csm_mlx_tpu_torch.ops.rope import rope_cache_for

FLASH_MIN_LEN = 512


def _cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-element CE in fp32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return logz - picked


def _masked_mean(values: torch.Tensor, mask: torch.Tensor, dim=None,
                 group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Safe masked mean; with `group`, over the group's ranks' values
    together (this rank's sum over the global count)."""
    m = mask.float()
    num = (values * m).sum() if dim is None else (values * m).sum(dim=dim)
    den = m.sum() if dim is None else m.sum(dim=dim)
    if group is not None:
        dist.all_reduce(den, group=group)
    return num / torch.clamp(den, min=1e-9)


def compute_loss(
    params: Dict[str, Any],
    args: ModelArgs,
    batch: Dict[str, torch.Tensor],
    *,
    per_sample: bool = False,
    cause_mismatch: bool = False,
    first_codebook_weight_multiplier: float | torch.Tensor = 1.0,
    decoder_loss_fraction: float = 1.0,
    remat: bool = False,
    generator: Optional[torch.Generator] = None,
    flash_min_len: int = FLASH_MIN_LEN,
    data_group: Optional[dist.ProcessGroup] = None,
) -> torch.Tensor:
    """The loss of one batch: a scalar, or (B,) with `per_sample`.

    batch: "tokens", "masks", "loss_masks", each (B, S, 33) integer tensors
    on the params' device, and optionally a per-batch
    "first_codebook_weight_multiplier". `data_group`: this rank's share of
    a global batch's loss (module docstring); per-sample losses are per
    row and take no group.
    """
    group = None if per_sample else data_group
    tokens = batch["tokens"].long()
    masks = batch["masks"]
    loss_masks = batch["loss_masks"]
    fcw = batch.get("first_codebook_weight_multiplier",
                    first_codebook_weight_multiplier)

    b, s, _ = tokens.shape
    n_cb = args.n_audio_codebooks
    bcfg, dcfg = args.backbone_config, args.decoder_config
    device = tokens.device

    shifted_audio_tokens = tokens[:, 1:, :-1]            # (B, S-1, K)
    valid = ((masks[:, 1:, :-1] != 0) & (loss_masks[:, 1:, :-1] != 0)).float()
    # cause_mismatch rolls only the CE targets; the decoder's teacher-forcing
    # inputs come from the unrolled sequence
    target_tokens = shifted_audio_tokens
    if cause_mismatch:
        target_tokens = torch.cat([shifted_audio_tokens[:, 1:],
                                   shifted_audio_tokens[:, :1]], dim=1)

    # ---- backbone over the (masked-sum) input frames -------------------
    emb = embed_tokens(params, args, tokens)
    backbone_input = (emb * masks[..., None].to(emb.dtype)).sum(-2)[:, :-1]
    cos_b, sin_b = rope_cache_for(bcfg, s, device)
    # The dataset right-pads, so pure causal masking (in the kernel) is
    # exact here.
    use_flash = flash_min_len > 0 and (s - 1) >= flash_min_len
    hidden, _ = llama_forward(
        params["backbone"], bcfg, backbone_input, cos_b, sin_b,
        torch.arange(s - 1, device=device)[None],
        None if use_flash else causal_mask_bias(s - 1, s - 1,
                                                device=device)[None, None],
        None, flash_train=use_flash, remat=remat,
    )  # (B, S-1, D)

    c0_logits = linear(params["codebook0_head"], hidden)
    c0_ce = _cross_entropy(c0_logits, target_tokens[:, :, 0])
    if per_sample:
        c0_loss = _masked_mean(c0_ce, valid[:, :, 0], dim=-1) * fcw
    else:
        c0_loss = _masked_mean(c0_ce, valid[:, :, 0], group=group) * fcw
    total = c0_loss / n_cb

    # ---- teacher-forced decoder over frame rows ------------------------
    n_rows = b * (s - 1)
    offsets = torch.arange(n_cb, device=device) * args.n_audio_vocab
    ci_emb = emb_table(params["audio_embeddings"])[
        shifted_audio_tokens + offsets]  # (B, S-1, K, D)
    dec_in = torch.cat([hidden[:, :, None, :], ci_emb.to(hidden.dtype)],
                       dim=-2).reshape(n_rows, n_cb + 1, -1)
    row_valid = valid.reshape(n_rows, n_cb)
    row_targets = target_tokens.reshape(n_rows, n_cb)

    if decoder_loss_fraction < 1.0:
        if generator is None:
            # a fixed subsample would never train the other rows
            raise ValueError(
                "decoder_loss_fraction < 1.0 requires generator= (advanced "
                "every step); a fixed subsample would never train the other "
                "rows")
        if per_sample:
            raise ValueError(
                "decoder_loss_fraction < 1.0 is incompatible with per-sample "
                "losses (DPO/KTO)")
        n_ranks, rank = (1, 0) if group is None else \
            (dist.get_world_size(group), dist.get_rank(group))
        k = max(int(n_rows * n_ranks * decoder_loss_fraction), 1)
        perm = torch.randperm(n_rows * n_ranks, generator=generator,
                              device=generator.device)[:k]
        if group is not None:  # the drawn rows that are this rank's
            perm = perm[(perm >= rank * n_rows)
                        & (perm < (rank + 1) * n_rows)] - rank * n_rows
        perm = perm.to(device)
        dec_in, row_valid, row_targets = (dec_in[perm], row_valid[perm],
                                          row_targets[perm])

    dec_proj = linear(params["projection"], dec_in)
    cos_d, sin_d = rope_cache_for(dcfg, n_cb + 1, device)
    dec_hidden, _ = llama_forward(
        params["decoder"], dcfg, dec_proj, cos_d, sin_d,
        torch.arange(n_cb + 1, device=device)[None],
        causal_mask_bias(n_cb + 1, n_cb + 1, device=device)[None, None],
        None, remat=remat,
    )  # (rows, K+1, Dd)
    # positions 1..K-1 predict codebooks 1..K-1 (drop the c0 row and the last)
    dec_hidden = dec_hidden[:, 1:-1, :]  # (rows, K-1, Dd)

    # all 31 codebooks in one batched product against audio_head, fp32
    ci_logits = torch.matmul(dec_hidden.float().transpose(0, 1),
                             params["audio_head"].float())  # (K-1, rows, V)
    ci_ce = _cross_entropy(ci_logits, row_targets[:, 1:].t())  # (K-1, rows)
    vmask = row_valid[:, 1:].t()

    if per_sample:
        per_cb = _masked_mean(ci_ce.reshape(n_cb - 1, b, s - 1),
                              vmask.reshape(n_cb - 1, b, s - 1), dim=-1)
        return total + per_cb.sum(dim=0) / n_cb  # (B,)
    per_cb = _masked_mean(ci_ce, vmask, dim=-1, group=group)  # (K-1,)
    return total + per_cb.sum() / n_cb
