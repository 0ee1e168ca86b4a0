"""Mimi checkpoint loading (port of `csm_mlx_tpu/models/mimi/weights.py`):
the HF (`kyutai/mimi`) and moshi (`kyutai/moshiko-pytorch-bf16`,
`tokenizer-e351c8d8-checkpoint125.safetensors`) naming schemes.

Both map onto the same parameter tree (see seanet.py / transformer.py /
rvq.py). Differences handled here:
- moshi nests convs as `*.conv.conv.*` / `*.convtr.convtr.*`; HF uses
  `*.conv.*`.
- moshi fuses attention qkv as `in_proj_weight`; HF splits q/k/v. Moshi
  applies *interleaved* RoPE while this implementation (like HF) uses the
  half-split convention, so moshi q/k rows are permuted per head:
  (head, pair, 2) -> (head, 2, pair) — the standard Llama-conversion
  permutation.
- codebooks are running stats (`embed_sum`/`embedding_sum` + cluster_usage).

Files are read from a local path with the port's own `safetensors_io`;
nothing is downloaded.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from csm_mlx_tpu_torch import safetensors_io
from csm_mlx_tpu_torch.device import resolve_device
from csm_mlx_tpu_torch.models.mimi.config import MimiConfig

_HF_TRANSFORMER_LEAVES = {
    "self_attn.out_proj.weight": ("self_attn", "o_proj", "weight"),
    "self_attn.q_proj.weight": ("self_attn", "q_proj", "weight"),
    "self_attn.k_proj.weight": ("self_attn", "k_proj", "weight"),
    "self_attn.v_proj.weight": ("self_attn", "v_proj", "weight"),
    "self_attn.o_proj.weight": ("self_attn", "o_proj", "weight"),
    "norm1.weight": ("input_layernorm", "weight"),
    "norm1.bias": ("input_layernorm", "bias"),
    "norm2.weight": ("post_attention_layernorm", "weight"),
    "norm2.bias": ("post_attention_layernorm", "bias"),
    "input_layernorm.weight": ("input_layernorm", "weight"),
    "input_layernorm.bias": ("input_layernorm", "bias"),
    "post_attention_layernorm.weight": ("post_attention_layernorm", "weight"),
    "post_attention_layernorm.bias": ("post_attention_layernorm", "bias"),
    "linear1.weight": ("mlp", "fc1", "weight"),
    "linear2.weight": ("mlp", "fc2", "weight"),
    "mlp.fc1.weight": ("mlp", "fc1", "weight"),
    "mlp.fc2.weight": ("mlp", "fc2", "weight"),
    "layer_scale_1.scale": ("self_attn_layer_scale", "scale"),
    "layer_scale_2.scale": ("mlp_layer_scale", "scale"),
    "self_attn_layer_scale.scale": ("self_attn_layer_scale", "scale"),
    "mlp_layer_scale.scale": ("mlp_layer_scale", "scale"),
}


def _set(tree: Dict[str, Any], path, value) -> None:
    cur = tree
    for p in path[:-1]:
        cur = cur.setdefault(p, {}) if isinstance(p, str) else cur[p]
    cur[path[-1]] = value


def _seanet_index_maps(cfg: MimiConfig, is_encoder: bool):
    """layer-list index -> tree path, for the flattened nn.ModuleList layout
    (ELUs occupy indices; R = num_residual_layers)."""
    r = cfg.num_residual_layers
    paths = {0: ("init",)}
    idx = 1
    for s in range(len(cfg.upsampling_ratios)):
        if is_encoder:
            for j in range(r):
                paths[idx] = ("stages", s, "residual", j)
                idx += 1
            idx += 1  # ELU
            paths[idx] = ("stages", s, "down")
            idx += 1
        else:
            idx += 1  # ELU
            paths[idx] = ("stages", s, "up")
            idx += 1
            for j in range(r):
                paths[idx] = ("stages", s, "residual", j)
                idx += 1
    idx += 1  # ELU
    paths[idx] = ("final",)
    return paths


def _permute_rope_rows(w: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Interleaved -> half-split RoPE row permutation for q/k projections."""
    out_dim, in_dim = w.shape
    head_dim = out_dim // n_heads
    return (w.reshape(n_heads, head_dim // 2, 2, in_dim)
            .permute(0, 2, 1, 3).reshape(out_dim, in_dim))


def _empty_tree(cfg: MimiConfig) -> Dict[str, Any]:
    def stages():
        return {"stages": [
            {"residual": [{} for _ in range(cfg.num_residual_layers)]}
            for _ in cfg.upsampling_ratios]}

    def layers(n):
        return {"layers": [{} for _ in range(n)]}

    return {
        "encoder": stages(),
        "decoder": stages(),
        "encoder_transformer": layers(cfg.num_hidden_layers),
        "decoder_transformer": layers(cfg.num_hidden_layers),
        "quantizer": {"semantic": layers(cfg.num_semantic_quantizers),
                      "acoustic": layers(cfg.num_acoustic_quantizers)},
        "downsample": {},
        "upsample": {},
    }


def map_mimi_state_dict(state: Mapping[str, Any], cfg: MimiConfig,
                        dtype=torch.float32,
                        device: torch.device | str | None = None
                        ) -> Dict[str, Any]:
    """Map a raw checkpoint dict (HF or moshi naming; tensors or numpy
    arrays) to the parameter tree, every leaf cast to `dtype` on `device`
    (by default where the state's tensors are; `cuda` for numpy arrays)."""
    state = {k: v if isinstance(v, torch.Tensor)
             else torch.from_numpy(np.array(v)) for k, v in state.items()}
    device = resolve_device(device, state)
    tree = _empty_tree(cfg)
    enc_map = _seanet_index_maps(cfg, True)
    dec_map = _seanet_index_maps(cfg, False)

    def put(path, value):
        _set(tree, path, value.detach().to(device=device, dtype=dtype))

    unused = []
    for name, v in state.items():
        # ---- SEANet convs -------------------------------------------------
        m = re.match(
            r"(encoder|decoder)\.(?:model|layers)\.(\d+)"
            r"(?:\.block\.(\d+))?\.(?:conv|convtr)(?:\.(?:conv|convtr))?"
            r"\.(weight|bias)$", name)
        if m:
            part, idx, block_idx, leaf = m.groups()
            base = (part,) + (enc_map if part == "encoder"
                              else dec_map)[int(idx)]
            if block_idx is not None:
                base += ("conv1" if int(block_idx) == 1 else "conv2",)
            put(base + (leaf,), v)
            continue
        # ---- down/upsample ------------------------------------------------
        m = re.match(r"(downsample|upsample)\.(?:conv|convtr)"
                     r"(?:\.(?:conv|convtr))?\.(weight|bias)$", name)
        if m:
            put((m.group(1), m.group(2)), v)
            continue
        # ---- transformers -------------------------------------------------
        m = re.match(r"(encoder_transformer|decoder_transformer)\."
                     r"(?:transformer\.)?layers\.(\d+)\.(.+)$", name)
        if m:
            base = (m.group(1), "layers", int(m.group(2)))
            rest = m.group(3)
            if rest == "self_attn.in_proj_weight":  # moshi fused qkv
                # the equal-thirds split is MHA-only: a GQA config would
                # assign q rows to k
                if cfg.num_key_value_heads != cfg.num_attention_heads:
                    raise ValueError(
                        "moshi fused in_proj_weight requires MHA (kv heads "
                        f"== heads); got {cfg.num_key_value_heads} != "
                        f"{cfg.num_attention_heads}")
                d = cfg.hidden_size
                put(base + ("self_attn", "q_proj", "weight"),
                    _permute_rope_rows(v[:d], cfg.num_attention_heads))
                put(base + ("self_attn", "k_proj", "weight"),
                    _permute_rope_rows(v[d:2 * d], cfg.num_key_value_heads))
                put(base + ("self_attn", "v_proj", "weight"), v[2 * d:])
            elif rest in _HF_TRANSFORMER_LEAVES:
                put(base + _HF_TRANSFORMER_LEAVES[rest], v)
            else:
                unused.append(name)
            continue
        # ---- quantizer ----------------------------------------------------
        m = re.match(r"quantizer\.(rvq_first|rvq_rest|"
                     r"semantic_residual_vector_quantizer|"
                     r"acoustic_residual_vector_quantizer)\.(.+)$", name)
        if m:
            which = "semantic" if m.group(1) in (
                "rvq_first", "semantic_residual_vector_quantizer") \
                else "acoustic"
            rest = m.group(2)
            mm = re.match(r"(input_proj|output_proj)(?:\.conv)?\.weight$",
                          rest)
            if mm:
                put(("quantizer", which, mm.group(1), "weight"), v)
                continue
            mm = re.match(r"(?:vq\.)?layers\.(\d+)\.(?:_codebook|codebook)\."
                          r"(embedding_sum|embed_sum|cluster_usage|embed|"
                          r"initialized|cluster_size)$", rest)
            if mm:
                leaf = mm.group(2)
                if leaf != "initialized":
                    leaf = {"embedding_sum": "embed_sum",
                            "cluster_size": "cluster_usage"}.get(leaf, leaf)
                    put(("quantizer", which, "layers", int(mm.group(1)),
                         "codebook", leaf), v)
                continue
        unused.append(name)

    if unused:
        # benign extras (masks, buffers); surfaced for debugging
        logging.getLogger(__name__).info(
            "mimi loader: %d unused checkpoint keys (e.g. %s)",
            len(unused), unused[:5])
    return tree


def load_mimi_checkpoint(path: str, cfg: MimiConfig, dtype=torch.float32,
                         device: torch.device | str | None = None
                         ) -> Dict[str, Any]:
    """The parameter tree of a local safetensors checkpoint, on `device`
    (`cuda` unless it says otherwise). A missing file raises
    FileNotFoundError, one the reader cannot parse its ValueError."""
    device = resolve_device(device)
    return map_mimi_state_dict(safetensors_io.load_file(str(path)), cfg,
                               dtype=dtype, device=device)
