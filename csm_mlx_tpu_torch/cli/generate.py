"""Weight and adapter arguments of the CLI (the local-path halves of
`csm_mlx_tpu/cli/generate.py`'s parsers). The `generate` subcommand
itself is not ported yet (ROADMAP queue 1, item 8)."""

from __future__ import annotations

from pathlib import Path
from typing import Optional


def parse_weight_argument(value: str) -> str:
    """A local weight file or directory -> the checkpoint file
    (`loaders.resolve_weight_path`); a failure exits with its message. A
    hub repo id is not fetched: it exits naming the local-path rule."""
    from csm_mlx_tpu_torch.loaders import resolve_weight_path

    try:
        return resolve_weight_path(value)
    except FileNotFoundError as e:
        raise SystemExit(f"Error: {e}")


def parse_adapter_argument(value: Optional[str]) -> Optional[str]:
    """A local LoRA adapter directory (adapter_config.json +
    adapters.safetensors) -> its resolved path; None passes through."""
    if value is None:
        return None
    required = ["adapter_config.json", "adapters.safetensors"]
    path = Path(value)
    if path.is_dir() and all((path / f).exists() for f in required):
        return str(path.resolve())
    raise SystemExit(
        f"Error: No required adapter files ({required}) found in {value} "
        f"(adapters are read from local directories only)")
