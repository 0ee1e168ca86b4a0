"""The port's Llama stack (`csm_mlx_tpu_torch/models/llama.py::
llama_forward`) against a random-init `transformers.LlamaModel`: the four
cases of `tests/test_hf_llama_parity.py` (prefill, positions past the
llama3 rope-scaling knee, prefill then single-token steps through the
port's KV cache, and the fused qkv / gate-up layout), fp32 on the CPU at
JAX's tolerances (2e-5; 3e-5 a decode step).

HF rotates the pairs (i, i + d/2) of a head, the port (2i, 2i + 1); both
at angle theta_i, so each head's q/k rows reordered as [hf_0, hf_{d/2},
hf_1, hf_{d/2+1}, ...] make the two stacks the same function.
transformers is not installed on every machine: the cases skip without
it."""

import copy

import numpy as np
import pytest
import torch

from csm_mlx_tpu_torch.config import LlamaConfig, RopeScalingConfig
from csm_mlx_tpu_torch.models.llama import fuse_layer_weights, llama_forward
from csm_mlx_tpu_torch.ops.attention import causal_mask_bias
from csm_mlx_tpu_torch.ops.kv_cache import KVCache
from csm_mlx_tpu_torch.ops.rope import rope_cache_for

HIDDEN, HEADS, KV_HEADS, HEAD_DIM, FFN, LAYERS = 64, 4, 2, 16, 128, 2

CFG = LlamaConfig(
    num_hidden_layers=LAYERS, num_attention_heads=HEADS,
    num_key_value_heads=KV_HEADS, head_dim=HEAD_DIM, intermediate_size=FFN,
    hidden_size=HIDDEN, rope_theta=500000.0,
    rope_scaling=RopeScalingConfig(),  # llama3 factor 32, orig 8192
    max_position_embeddings=256,
)


def _hf_model(seed=0):
    pytest.importorskip("transformers")
    from transformers.models.llama import LlamaConfig as HFConfig
    from transformers.models.llama import LlamaModel

    torch.manual_seed(seed)
    cfg = HFConfig(
        hidden_size=HIDDEN, num_attention_heads=HEADS,
        num_key_value_heads=KV_HEADS, head_dim=HEAD_DIM,
        intermediate_size=FFN, num_hidden_layers=LAYERS, vocab_size=256,
        rope_theta=500000.0, max_position_embeddings=16384,
        rms_norm_eps=1e-5, attention_bias=False, mlp_bias=False,
        rope_scaling={"rope_type": "llama3", "factor": 32.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 8192},
    )
    return LlamaModel(cfg).eval()


def _interleave_rows(w: torch.Tensor) -> torch.Tensor:
    """Per-head row reorder: half-split (HF) -> pair-interleaved (port)."""
    out_dim, in_dim = w.shape
    w = w.reshape(out_dim // HEAD_DIM, 2, HEAD_DIM // 2, in_dim)
    return w.transpose(1, 2).reshape(out_dim, in_dim).contiguous()


def _to_params(hf) -> dict:
    sd = {k: v.detach().clone() for k, v in hf.state_dict().items()}
    layers = []
    for i in range(LAYERS):
        p = f"layers.{i}."

        def w(name, rotate=False):
            t = sd[p + name + ".weight"]
            return {"weight": _interleave_rows(t) if rotate else t}

        layers.append({
            "self_attn": {"q_proj": w("self_attn.q_proj", True),
                          "k_proj": w("self_attn.k_proj", True),
                          "v_proj": w("self_attn.v_proj"),
                          "o_proj": w("self_attn.o_proj")},
            "mlp": {"gate_proj": w("mlp.gate_proj"),
                    "up_proj": w("mlp.up_proj"),
                    "down_proj": w("mlp.down_proj")},
            "input_layernorm": w("input_layernorm"),
            "post_attention_layernorm": w("post_attention_layernorm"),
        })
    return {"layers": layers, "norm": {"weight": sd["norm.weight"]}}


@pytest.fixture(scope="module")
def oracle():
    hf = _hf_model()
    return hf, _to_params(hf)


def _hf(hf, x, **kw):
    with torch.no_grad():
        return hf(inputs_embeds=torch.from_numpy(x),
                  **kw).last_hidden_state.numpy()


@torch.no_grad()
def _port(params, x, positions, bias, cache=None, table=32):
    cos, sin = rope_cache_for(CFG, table, device="cpu")
    out, cache = llama_forward(params, CFG, torch.from_numpy(x), cos, sin,
                               positions, bias, cache)
    return out.numpy(), cache


def test_prefill_hidden_parity(oracle):
    hf, params = oracle
    x = np.random.RandomState(0).randn(2, 7, HIDDEN).astype(np.float32) * 0.3
    got, _ = _port(params, x, torch.arange(7)[None],
                   causal_mask_bias(7, 7)[None, None])
    np.testing.assert_allclose(got, _hf(hf, x), atol=2e-5, rtol=2e-5)


def test_long_position_rope_scaling_parity(oracle):
    """Positions past the llama3 low-frequency knee exercise the scaling."""
    hf, params = oracle
    s, start = 9, 900  # deep enough that scaled and unscaled differ
    x = np.random.RandomState(1).randn(1, s, HIDDEN).astype(np.float32) * 0.3
    pos = torch.arange(start, start + s)[None]
    got, _ = _port(params, x, pos, causal_mask_bias(s, s)[None, None],
                   table=1024)
    np.testing.assert_allclose(got, _hf(hf, x, position_ids=pos), atol=2e-5,
                               rtol=2e-5)


def test_decode_step_kv_cache_parity(oracle):
    """A prefill, then single-token steps through the port's KV cache (in
    place), equal the HF full-sequence forward at every position."""
    hf, params = oracle
    s_total, s_prefill, cap = 10, 6, 16
    x = np.random.RandomState(2).randn(1, s_total, HIDDEN).astype(
        np.float32) * 0.3
    want = _hf(hf, x)
    cache = KVCache.init(CFG, 1, cap, dtype=torch.float32, device="cpu")
    k_idx = torch.arange(cap)
    prefill_bias = torch.where(k_idx[None, :] <= torch.arange(s_prefill)[:, None],
                               0.0, -1e30).float()[None, None]
    got, cache = _port(params, x[:, :s_prefill], torch.arange(s_prefill)[None],
                       prefill_bias, cache)
    np.testing.assert_allclose(got, want[:, :s_prefill], atol=2e-5, rtol=2e-5)
    for t in range(s_prefill, s_total):
        step_bias = torch.where(k_idx <= t, 0.0, -1e30).float()[
            None, None, None, :]
        got, cache = _port(params, x[:, t:t + 1], torch.tensor([[t]]),
                           step_bias, cache)
        np.testing.assert_allclose(got[:, 0], want[:, t], atol=3e-5,
                                   rtol=3e-5, err_msg=f"step {t}")


def test_fused_layout_matches_hf(oracle):
    """The qkv / gate-up fusion does not change the function."""
    hf, params = oracle
    params = copy.deepcopy(params)
    fuse_layer_weights(params)
    assert "qkv_proj" in params["layers"][0]["self_attn"]
    x = np.random.RandomState(3).randn(1, 5, HIDDEN).astype(np.float32) * 0.3
    got, _ = _port(params, x, torch.arange(5)[None],
                   causal_mask_bias(5, 5)[None, None])
    np.testing.assert_allclose(got, _hf(hf, x), atol=2e-5, rtol=2e-5)
