"""`finetune full {sft,dpo,kto}` (port of
`csm_mlx_tpu/cli/finetune/full_finetune.py`), with the JAX CLI's flags and
defaults. `run` loads the model (and KTO's frozen reference, a second
load); `train` trains a model in hand and saves
`final_model.safetensors` (rank 0, under --data-parallel / --fsdp)."""

from __future__ import annotations

import argparse
import os

from csm_mlx_tpu_torch.cli.finetune.common import (
    add_mode_parsers,
    common_train_args,
    load_dataset,
    mode_trainer,
    run_mode,
)


def _add_freeze_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--freeze-backbone", action="store_true", default=False)
    p.add_argument("--freeze-decoder", action="store_true", default=False)


def add_parser(subparsers) -> None:
    p = subparsers.add_parser("full", help="Full-parameter finetuning")
    add_mode_parsers(p, "Full", _add_freeze_flags, run)


def _freeze_filter(args):
    """Trainable-path predicate implementing --freeze-backbone/decoder."""
    fb = getattr(args, "freeze_backbone", False)
    fd = getattr(args, "freeze_decoder", False)
    if not (fb or fd):
        return None

    def flt(path: str) -> bool:
        if fb and path.startswith("backbone."):
            return False
        if fd and path.startswith("decoder."):
            return False
        return True

    return flt


def run(args: argparse.Namespace) -> None:
    run_mode(args, train)


def train(args: argparse.Namespace, model, reference=None,
          mesh=None) -> None:
    """`args.mode` on `model`; `reference`: KTO's frozen model the policy
    is scored against; `mesh`: the run's (`make_mesh_if_requested`)."""
    os.makedirs(args.output_dir, exist_ok=True)
    trainer = mode_trainer(
        args, common_train_args(args, model, _freeze_filter(args), mesh),
        reference)
    dataset = load_dataset(args, model)
    print(f"Starting training for {args.epochs} epochs, batch size "
          f"{args.batch_size}")
    trainer.train(dataset=dataset, batch_size=args.batch_size,
                  epochs=args.epochs)
    model.params = trainer.full_params()  # FSDP: every rank gathers
    if not trainer.is_writer:
        return
    print("\nTraining complete!")
    final = args.output_dir / "final_model.safetensors"
    print(f"Saving final model weights to {final}...")
    model.save_weights(str(final))
    print("Final model saved.")
