"""A backbone architecture is one file, `arch/<arch>.py`, found by the name
in a configuration's `backbone.arch` ("llama" where the key is missing),
as a driver or a reader is found by its name.

The file gives these functions, each taking the configuration's `backbone`
dict; the harness reaches the backbone's layers through them alone:

- `spec(prefix, cfg)`: the seeded backbone leaves under `prefix` as a
  `weights.Spec`, in the checkpoint layout the port reads, made with the
  four kinds of `weights.make`;
- `port_config(cfg)`: the object `system.model_args` registers in the
  port's `BACKBONE_CONFIGURATION`; a key it cannot take is refused;
- `reference(params, cfg, bits)`: the plain fp32 backbone, a callable from
  (N, S, D) embeddings to the normed hidden state (N, S, D): causal, with
  no cache and no kernel, its linears quantized as `reference.quant`
  does, importing nothing of the port;
- `linears(cfg)`: each layer's kernel-1 linears, [(name, IN, OUT)] a
  layer, in launch order and fused as `quantize_model(fuse=True)` runs
  them: kernel 1's bound and its launches a frame (`roofline`), which
  decide the replays every kernel share and busy time reads;
- `attention_layers(cfg)`: how many layers hold a KV cache, each one
  kernel-4 call a backbone step (`metrics/k4_ms.serve.py`);
- `decode_ops(cfg, context)`, `prefill_ops(cfg, rows)`: the backbone's
  operations for one position attending over `context` positions, and for
  a causal prompt of `rows` rows (`roofline.frame_ops`, `prefill_ops`).

CSM's decoder is always the Llama stack kernel 3 runs: its spec, port
config, reference and linears come from `arch.llama`, imported directly.
"""

from __future__ import annotations

import functools
import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load(config: dict):
    """The architecture module of a configuration's backbone."""
    name = config["backbone"].get("arch", "llama")
    path = os.path.join(HERE, f"{name}.py")
    if not os.path.isfile(path):
        raise SystemExit(f"backbone arch {name!r}: no file {path}")
    return _module(path, name)


@functools.lru_cache(maxsize=None)
def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(f"gpubench_arch_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
