"""CLI root of the port (JAX's `csm-tpu`), as `csm-torch` or
`python -m csm_mlx_tpu_torch`:

  csm-torch generate TEXT -o out.wav [...]
  csm-torch serve --port 8080 [...]
  csm-torch finetune full {sft,dpo,kto} [...]
  csm-torch finetune lora {sft,dpo,kto} [...]
  csm-torch finetune convert INPUT_DIR OUTPUT_JSON
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="csm-torch",
        description="CSM (Conversational Speech Model) on an NVIDIA GPU, "
                    "with generation and finetuning support.")
    sub = parser.add_subparsers(dest="command", required=True)

    from csm_mlx_tpu_torch.cli import generate as generate_cli
    from csm_mlx_tpu_torch.cli import serve as serve_cli

    generate_cli.add_parser(sub)
    serve_cli.add_parser(sub)

    ft = sub.add_parser("finetune", help="Finetune CSM models.")
    ft_sub = ft.add_subparsers(dest="finetune_command", required=True)

    from csm_mlx_tpu_torch.cli.finetune import dataset as convert_cli
    from csm_mlx_tpu_torch.cli.finetune import full_finetune, lora_finetune

    full_finetune.add_parser(ft_sub)
    lora_finetune.add_parser(ft_sub)
    convert_cli.add_parser(ft_sub)
    return parser


def app(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    app()
