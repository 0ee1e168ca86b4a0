"""CLI root of the port: `python -m csm_mlx_tpu_torch.cli.application
serve [...]` (JAX's `csm-tpu serve`). The `generate` and `finetune`
subcommands are not ported yet (ROADMAP queue 1, item 8)."""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="csm-torch",
        description="CSM (Conversational Speech Model) on an NVIDIA GPU: "
                    "text-to-speech serving.")
    sub = parser.add_subparsers(dest="command", required=True)

    from csm_mlx_tpu_torch.cli import serve as serve_cli

    serve_cli.add_parser(sub)
    return parser


def app(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    app()
