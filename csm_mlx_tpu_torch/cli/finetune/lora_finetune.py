"""`finetune lora {sft,dpo,kto}` (port of
`csm_mlx_tpu/cli/finetune/lora_finetune.py`), with the JAX CLI's flags and
defaults: LoRA (or DoRA) layers on the targets, `adapter_config.json` and,
after training, `adapters.safetensors` in `--output-dir`, which
`load_adapters` reads back (rank 0 writes them, under --data-parallel /
--fsdp). `run` loads the model (and KTO's frozen reference, a second
load, before the adapters); `train` trains a model in hand."""

from __future__ import annotations

import argparse
import json
import os

from csm_mlx_tpu_torch.cli.finetune.common import (
    add_mode_parsers,
    common_train_args,
    load_dataset,
    mode_trainer,
    run_mode,
)


def _add_lora_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--lora-rank", type=int, default=8)
    p.add_argument("--lora-alpha", type=float, default=16.0)
    p.add_argument("--target-modules", nargs="*",
                   default=["attn", "codebook0_head", "projection"],
                   help="Module names to apply LoRA to")
    p.add_argument("--train-embeddings", action="store_true", default=False,
                   help="Train embedding layers directly (not via LoRA)")
    p.add_argument("--use-dora", action="store_true", default=False)


def add_parser(subparsers) -> None:
    p = subparsers.add_parser("lora", help="LoRA/DoRA finetuning")
    add_mode_parsers(p, "LoRA", _add_lora_flags, run)


def _apply_lora(args, model):
    from csm_mlx_tpu_torch.finetune.lora import (linear_to_lora_layers,
                                                 trainable_filter)

    target_modules = list(args.target_modules)
    embedding_targets = [t for t in target_modules if "embeddings" in t]
    if args.train_embeddings and embedding_targets:
        print("Warning: Both --train-embeddings and embedding modules in "
              "--target-modules detected; removing embedding modules from "
              "target_modules")
        target_modules = [t for t in target_modules if "embeddings" not in t]

    if args.lora_rank < 1:
        raise SystemExit(
            f"Error: --lora-rank must be >= 1, got {args.lora_rank}")
    print(f"Applying LoRA with rank={args.lora_rank}, alpha={args.lora_alpha}")
    print(f"Target modules: {target_modules}")
    lora_config = {
        "rank": args.lora_rank,
        "scale": args.lora_alpha / args.lora_rank,
        "dropout": 0.0,
        "keys": target_modules,
    }
    linear_to_lora_layers(model, config=lora_config, use_dora=args.use_dora)

    if args.train_embeddings:
        def flt(path: str) -> bool:
            return trainable_filter(path) or path in (
                "text_embeddings.weight", "audio_embeddings.weight")
        return flt, lora_config
    return trainable_filter, lora_config


def _write_adapter_config(args, lora_config: dict) -> None:
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "adapter_config.json"), "w") as f:
        json.dump({"lora_parameters": lora_config,
                   "fine_tune_type": "dora" if args.use_dora else "lora"},
                  f, indent=2)


def run(args: argparse.Namespace) -> None:
    run_mode(args, train)


def train(args: argparse.Namespace, model, reference=None,
          mesh=None) -> None:
    """`args.mode` on `model` with adapters on its targets; `reference`:
    KTO's frozen model from before the adapters; `mesh`: the run's
    (`make_mesh_if_requested`). Only the adapters are checkpointed and
    saved."""
    from csm_mlx_tpu_torch.finetune.lora import save_adapter_weights

    flt, lora_config = _apply_lora(args, model)
    trainer = mode_trainer(
        args, dict(common_train_args(args, model, flt, mesh),
                   only_save_trainable_params=True), reference)
    if trainer.is_writer:
        _write_adapter_config(args, lora_config)
    trainer.train(dataset=load_dataset(args, model),
                  batch_size=args.batch_size, epochs=args.epochs)
    model.params = trainer.full_params()  # FSDP: every rank gathers
    if not trainer.is_writer:
        return
    print("\nTraining complete!")
    final = args.output_dir / "adapters.safetensors"
    print(f"Saving final adapter weights to {final}...")
    save_adapter_weights(model, final, weight_filter=flt)
    print("Final adapters saved.")
