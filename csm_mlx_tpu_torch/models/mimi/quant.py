"""W8A8 quantization of the Mimi DECODE path (port of
`csm_mlx_tpu/models/mimi/quant.py`), for the serving engine's codec step.

- The SEANet decoder convs (init, residual, final, and the transposed
  upsamplers of the stages): SYMMETRIC per-out-channel int8 weights
  (w ~ s_o * q), so no zero-point term ever appears; the activations are
  quantized per batch row at run time and the conv sums int8 x int8 in
  int32 (`models/mimi/conv.py`: one `torch._int_mm` on the card).
- The codec transformer's linears (q/k/v/o, fc1/fc2): per-channel affine
  int8 through `ops.quant.quantize_weight_w8`; `ops.layers.linear` sends
  such a dict through kernel 1 (`w8a8_matvec`) at every row count.

The grouped upsample (groups == channels) and the RVQ stay fp32, and the
ENCODE path is never quantized: context encodes and training read it. The
error is quantization error alone; `tests/test_torch_mimi_quant.py` bounds
it against the fp32 decode, and `chip_smoke.py::run_int8_codec` times the
engine's block with and without it on the card.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable

import torch

Params = Dict[str, Any]


def _quant_conv_sym(p: Params, out_axis: int) -> Params:
    """Symmetric per-out-channel int8 codes of a conv weight: conv weights
    are (C_out, C_in, K) (out_axis 0), transposed-conv weights (C_in,
    C_out, K) (out_axis 1). The bias stays fp32."""
    w = p["weight"].float()
    red = tuple(i for i in range(w.ndim) if i != out_axis)
    s = torch.clamp(w.abs().amax(dim=red, keepdim=True) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    out = {"weight_q": q, "scales": s.reshape(-1).float()}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def _walk_seanet_decoder(dec: Params) -> Iterable[tuple]:
    """(container, key, out_axis) of every quantizable decoder conv."""
    yield dec, "init", 0
    for stage in dec["stages"]:
        yield stage, "up", 1            # transposed conv: (C_in, C_out, K)
        for block in stage["residual"]:
            yield block, "conv1", 0
            yield block, "conv2", 0
    yield dec, "final", 0


@torch.no_grad()
def quantize_mimi_decoder(mimi, targets=("seanet", "transformer")) -> None:
    """Quantize the decode path of a `Mimi` in place.

    `targets`: any of "seanet" (the decoder convs -> symmetric W8A8) and
    "transformer" (the decoder transformer's linears -> per-channel affine
    int8). The encoder, the quantizer and the grouped upsample are left as
    they are. Idempotent: quantized leaves are skipped."""
    from csm_mlx_tpu_torch.ops.quant import quantize_weight_w8

    params = mimi.params
    if "seanet" in targets:
        for holder, key, out_axis in _walk_seanet_decoder(params["decoder"]):
            if "weight_q" not in holder[key]:
                holder[key] = _quant_conv_sym(holder[key], out_axis)
    if "transformer" in targets:
        for lp in params["decoder_transformer"]["layers"]:
            at, mlp = lp["self_attn"], lp["mlp"]
            for h, k in ((at, "q_proj"), (at, "k_proj"), (at, "v_proj"),
                         (at, "o_proj"), (mlp, "fc1"), (mlp, "fc2")):
                if "weight_q" not in h[k]:
                    bias = h[k].get("bias")
                    h[k] = quantize_weight_w8(h[k]["weight"])
                    if bias is not None:
                        h[k]["bias"] = bias


def mimi_decoder_is_quantized(params: Params) -> bool:
    return "weight_q" in params.get("decoder", {}).get("init", {})
