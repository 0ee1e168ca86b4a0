"""Split residual vector quantizer (port of `csm_mlx_tpu/models/mimi/rvq.py`).

Codebooks are stored as running stats (embed_sum, cluster_usage); the
embedding is embed_sum / max(cluster_usage, eps). Both halves (1 semantic
and N-1 acoustic codebooks) see the same latent. Encode projects it 512 ->
256 and picks, codebook after codebook, the nearest entry to the residual;
decode is an embedding sum over the codebooks and a 1x1 projection 256 ->
512.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from csm_mlx_tpu_torch.device import resolve_device
from csm_mlx_tpu_torch.models.mimi.config import MimiConfig

Params = Dict[str, Any]
EPS = 1e-5


def codebook_embed(cb: Params) -> torch.Tensor:
    """(codebook_size, dim) embedding table from running stats."""
    if "embed" in cb:
        return cb["embed"]
    usage = torch.clamp(cb["cluster_usage"], min=EPS)
    return cb["embed_sum"] / usage[:, None]


def _proj(p: Params, x: torch.Tensor) -> torch.Tensor:
    """1x1 conv projection on (B, C, T)."""
    w = p["weight"]
    if w.dim() == 3:
        w = w[:, :, 0]
    return torch.einsum("bct,oc->bot", x, w.to(x.dtype))


def _nearest(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Nearest codebook index under L2. x: (..., D); embed: (V, D).

    The argmax of 2 x.e - |e|^2 in fp32, as the JAX package computes it:
    a distance (`torch.cdist`, an argmin of |x - e|^2) rounds otherwise,
    and on a near tie picks another index, which changes the residual of
    every later codebook."""
    xf, ef = x.float(), embed.float()
    scores = 2.0 * torch.einsum("...d,vd->...v", xf, ef) \
        - torch.sum(ef * ef, dim=-1)
    return torch.argmax(scores, dim=-1)


def rvq_encode(params: Params, x: torch.Tensor,
               num_quantizers: int) -> torch.Tensor:
    """Residual encode. x: (B, C, T) -> codes (B, K, T) int64."""
    if "input_proj" in params:
        x = _proj(params["input_proj"], x)
    residual = x.transpose(1, 2)  # (B, T, D)
    codes = []
    for layer in params["layers"][:num_quantizers]:
        embed = codebook_embed(layer["codebook"])
        idx = _nearest(residual, embed)
        codes.append(idx)
        residual = residual - embed[idx].to(residual.dtype)
    return torch.stack(codes, dim=1)


def split_rvq_encode(params: Params, x: torch.Tensor,
                     num_quantizers: int) -> torch.Tensor:
    """Split RVQ: the semantic and the acoustic half both quantize the
    latent x (B, C, T) -> (B, num_quantizers, T)."""
    n_sem = len(params["semantic"]["layers"])
    codes = [rvq_encode(params["semantic"], x, n_sem)]
    if num_quantizers > n_sem:
        codes.append(rvq_encode(params["acoustic"], x,
                                num_quantizers - n_sem))
    return torch.cat(codes, dim=1)


def rvq_decode(params: Params, codes: torch.Tensor) -> torch.Tensor:
    """codes (B, K, T) -> (B, C, T) quantized latent.

    Codes past the codebook clamp to its last entry, as the JAX gather
    does: CSM's audio vocabulary (2051) is wider than Mimi's codebooks
    (2048), so a generated frame can hold such codes."""
    total = None
    for i, layer in enumerate(params["layers"]):
        embed = codebook_embed(layer["codebook"])
        q = embed[codes[:, i].clamp(0, embed.shape[0] - 1)]  # (B, T, D)
        total = q if total is None else total + q
    out = total.transpose(1, 2)
    if "output_proj" in params:
        out = _proj(params["output_proj"], out)
    return out


def split_rvq_decode(params: Params, codes: torch.Tensor) -> torch.Tensor:
    n_sem = len(params["semantic"]["layers"])
    out = rvq_decode(params["semantic"], codes[:, :n_sem])
    if codes.shape[1] > n_sem:
        acoustic = dict(params["acoustic"])
        acoustic["layers"] = params["acoustic"]["layers"][:codes.shape[1] - n_sem]
        out = out + rvq_decode(acoustic, codes[:, n_sem:])
    return out


def init_rvq_params(generator: torch.Generator, cfg: MimiConfig,
                    n_layers: int, dtype=torch.float32,
                    device: torch.device | str | None = None) -> Params:
    device = resolve_device(device)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32)

    layers = [{"codebook": {
        "embed_sum": normal(cfg.codebook_size, cfg.codebook_dim).to(dtype),
        "cluster_usage": torch.ones((cfg.codebook_size,), dtype=dtype,
                                    device=device),
    }} for _ in range(n_layers)]
    p: Params = {"layers": layers}
    if cfg.codebook_dim != cfg.hidden_size:
        p["input_proj"] = {"weight": (
            normal(cfg.codebook_dim, cfg.hidden_size)
            * cfg.hidden_size ** -0.5).to(dtype)}
        p["output_proj"] = {"weight": (
            normal(cfg.hidden_size, cfg.codebook_dim)
            * cfg.codebook_dim ** -0.5).to(dtype)}
    return p


def init_split_rvq_params(generator: torch.Generator, cfg: MimiConfig,
                          dtype=torch.float32,
                          device: torch.device | str | None = None) -> Params:
    device = resolve_device(device)
    return {
        "semantic": init_rvq_params(generator, cfg,
                                    cfg.num_semantic_quantizers, dtype, device),
        "acoustic": init_rvq_params(generator, cfg,
                                    cfg.num_acoustic_quantizers, dtype, device),
    }
