"""The yardstick's arithmetic: the H100's peaks and, from a configuration's
shapes, the bytes and operations of each kernel launch and of the model's
work.

Frozen here from `chip_smoke.py` (`bound_ms`, kernel 1's byte count in
`check_w8a8`, `resident_bound`, `flash_train_bounds`), rewritten to take
shapes instead of tensors. A bound is the larger of the bytes (inputs read
once, outputs written once) over the HBM rate and the operations over the
peak of their type.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Tuple

from gpubench import arch
from gpubench.arch import llama

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "fp32": 67e12}


def bound_s(n_bytes: float, n_ops: float, kind: str) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS_PER_S[kind])


def k1_bytes_ops(rows: int, in_dim: int, out_dim: int
                 ) -> Tuple[float, float]:
    """Kernel 1 (W8A8 linear) on `rows` rows: int8 codes, fp32 scale and
    midpoint per output row, bf16 activations in and out."""
    n_bytes = in_dim * out_dim + 8 * out_dim + 2 * rows * (in_dim + out_dim)
    return n_bytes, 2.0 * rows * in_dim * out_dim


def k1_bound_s(rows: int, in_dim: int, out_dim: int) -> float:
    return bound_s(*k1_bytes_ops(rows, in_dim, out_dim), "int8")


def decoder_linears(config: dict) -> List[Tuple[str, int, int]]:
    """(name, IN, OUT) of one decoder layer's quantized linears."""
    return llama.linears(config["decoder"])[0]


def k1_frame_bound_s(config: dict, rows: int) -> Tuple[float, int]:
    """Kernel 1's launches of one backbone step (each layer's linears,
    `arch.load(config).linears`) and its projection at `rows` rows (the
    projection takes 2 rows a row: hidden and c0): (summed bound,
    launches). Layers of one kind are summed once and counted."""
    b = config["backbone"]
    layers = arch.load(config).linears(b)
    kinds = Counter(tuple(layer) for layer in layers)
    bound = sum(n * sum(k1_bound_s(rows, i, o) for _, i, o in kind)
                for kind, n in kinds.items())
    proj = k1_bound_s(2 * rows, b["hidden_size"],
                      config["decoder"]["hidden_size"])
    return bound + proj, sum(map(len, layers)) + 1


def k3_bytes_ops(config: dict, rows: int) -> Tuple[float, float]:
    """Kernel 3 (the whole-frame decoder) on `rows` rows: every table read
    once (the layers' int8 codes, fp32 scale/midpoint rows and norms, the
    RoPE rows, the int8 audio head and its fp32 column scales), the 30
    projected embedding rows each row gathers and its 2 primed rows (fp32),
    the tokens written; against the int8 operations of its decoder steps
    and its heads."""
    c = config["decoder"]
    d, hd = c["hidden_size"], c["head_dim"]
    n_cb, v = config["audio_num_codebooks"], config["audio_vocab_size"]
    v_pad = -(-v // 128) * 128
    codes = sum(i * o for _, i, o in decoder_linears(config))
    rows_sz = sum(8 * o for _, _, o in decoder_linears(config))
    layer_bytes = codes + rows_sz + 2 * 4 * d
    n_layers = c["num_hidden_layers"]
    head = (n_cb - 1) * v_pad * d
    n_bytes = (n_layers * layer_bytes + 4 * d + n_cb * 3 * hd * 4
               + head + (n_cb - 1) * v_pad * 4
               + (n_cb - 2) * rows * d * 4 + 2 * rows * d * 4
               + n_cb * rows * 4)
    n_ops = 2.0 * rows * (n_cb * n_layers * codes + head)
    return n_bytes, n_ops


def k3_bound_s(config: dict, rows: int) -> float:
    return bound_s(*k3_bytes_ops(config, rows), "int8")


def flash_train_bounds_s(b: int, s: int, h: int, n_kv: int, d: int,
                         kind: str = "bf16") -> Dict[str, float]:
    """Kernels 6 and 7: causal FLOPs 2*B*H*S^2*D forward and 2.5x that
    backward, against the bytes each moves."""
    e = 2 if kind == "bf16" else 4
    qb, kb = b * h * s * d * e, b * n_kv * s * d * e
    lse = b * h * s * 4
    flops = 2.0 * b * h * s * s * d
    return dict(fwd=bound_s(2 * qb + 2 * kb + lse, flops, kind),
                bwd=bound_s(4 * qb + 4 * kb + lse, 2.5 * flops, kind))


def frame_ops(config: dict, context: float) -> float:
    """The model's operations for one frame of one row whose backbone step
    attends over `context` positions: the backbone step
    (`arch.load(config).decode_ops`), the codebook-0 head, the projection
    of the primed rows and of 30 embeddings, the decoder's 32 positions and
    the 31 audio heads. Mimi is left out."""
    b, c = config["backbone"], config["decoder"]
    n_cb, v = config["audio_num_codebooks"], config["audio_vocab_size"]
    d_b, d_d = b["hidden_size"], c["hidden_size"]
    ops = arch.load(config).decode_ops(b, context) + 2.0 * d_b * v
    ops += 2.0 * n_cb * d_b * d_d
    ops += llama.prefill_ops(c, n_cb)
    ops += 2.0 * (n_cb - 1) * d_d * v
    return ops


def prefill_ops(config: dict, rows: int) -> float:
    """The backbone's operations over a prompt of `rows` positions
    (`arch.load(config).prefill_ops`) and the codebook-0 head of its last
    row."""
    b = config["backbone"]
    return arch.load(config).prefill_ops(b, rows) \
        + 2.0 * b["hidden_size"] * config["audio_vocab_size"]
