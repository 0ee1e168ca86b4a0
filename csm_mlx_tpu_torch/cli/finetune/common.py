"""Shared plumbing of the `finetune full` and `finetune lora` commands (port
of `csm_mlx_tpu/cli/finetune/common.py`), with the JAX CLI's flags and
defaults.

- `MODES` gives each of `sft`, `dpo` and `kto` its dataset, trainer and
  flags; `add_mode_parsers`, `run_mode`, `mode_trainer` and
  `load_dataset` serve both commands from it.
- The optimizer is `finetune.trainer.build_optimizer`'s torch one; the
  two commands' `TrainArgs` fields come from `common_train_args`.
- Weights come from `--pretrained-path` only: without it the command exits
  naming the flag (nothing is downloaded).
- `--data-parallel` and `--fsdp` train over every rank of a `torchrun`
  launch (`make_mesh_if_requested`: one process a GPU, NCCL); `--fsdp`
  also shards the parameters and AdamW state. Rank 0 writes the
  checkpoints and the final weights.
- The dataset's audio is encoded by the codec singleton on the model's
  device (`CSM_TPU_MIMI_WEIGHTS`).
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

from csm_mlx_tpu_torch.cli.config import MODEL

# mode -> (its dataset class, trainer class and args class, by name, and
# the float flags that args class takes beyond the common ones, with
# their defaults)
MODES = {
    "sft": ("CSMDataset", "CSMTrainer", "TrainArgs", {}),
    "dpo": ("CSMPairwiseDataset", "DPOTrainer", "DPOArgs", {"beta": 0.1}),
    "kto": ("CSMPointwiseDataset", "KTOTrainer", "KTOArgs",
            {"beta": 0.1, "desirable_weight": 1.0,
             "undesirable_weight": 1.0}),
}


def add_common_train_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data-path", required=True, type=Path,
                   help="Path to JSON dataset file")
    p.add_argument("--output-dir", "-o", required=True, type=Path,
                   help="Directory to save checkpoints and logs")
    p.add_argument("--model", "-m", choices=list(MODEL), default="1b")
    p.add_argument("--pretrained-path", type=Path, default=None,
                   help="Path to pretrained weights (required: nothing is "
                        "downloaded)")
    p.add_argument("--max-audio-length-ms", type=int, default=None)
    p.add_argument("--mask-speaker-ids", type=int, nargs="*", default=None)
    p.add_argument("--batch-size", "-b", type=int, default=4)
    p.add_argument("--epochs", "-e", type=int, default=5)
    p.add_argument("--learning-rate", "--lr", type=float, default=1e-5)
    p.add_argument("--weight-decay", "--wd", type=float, default=1e-4)
    p.add_argument("--max-norm", type=float, default=0.0,
                   help="Max norm for gradient clipping (0.0 to disable)")
    p.add_argument("--first-codebook-weight-multiplier", "--fcw",
                   type=float, default=1.0)
    p.add_argument("--ckpt-freq", "--ckpt_freq", type=int, default=100)
    p.add_argument("--log-freq", type=int, default=10)
    p.add_argument("--gradient-ckpt", action="store_true", default=False)
    p.add_argument("--optimizer", choices=["adam", "sgd", "adamw"],
                   default="adamw")
    p.add_argument("--decoder-loss-fraction", type=float, default=1.0,
                   help="Fraction of frame positions for the decoder loss "
                        "(Sesame compute amortization; 1.0 = full)")
    p.add_argument("--data-parallel", action="store_true", default=False,
                   help="Shard the batch over all local devices")
    p.add_argument("--fsdp", action="store_true", default=False,
                   help="Also shard parameter + optimizer-state storage "
                        "over the devices (ZeRO-3; implies --data-parallel)")


def add_mode_parsers(p: argparse.ArgumentParser, kind: str, add_flags,
                     run) -> None:
    """The `sft`, `dpo` and `kto` subcommands of `p`: the common flags,
    `add_flags`' and the mode's own, each running `run`."""
    sub = p.add_subparsers(dest="mode", required=True)
    for mode, (*_, extra) in MODES.items():
        m = sub.add_parser(
            mode, help=f"{kind} {mode.upper()} finetuning for CSM models.")
        add_common_train_flags(m)
        add_flags(m)
        for name, default in extra.items():
            m.add_argument(f"--{name.replace('_', '-')}", type=float,
                           default=default)
        m.set_defaults(func=run)


def run_mode(args: argparse.Namespace, train) -> None:
    """Load the model (and, for KTO, its frozen reference, a second load)
    and `train(args, model, reference, mesh)`. With a parallel flag the
    mesh comes first: its process group selects this rank's GPU, where the
    weights load."""
    mesh = make_mesh_if_requested(args)
    model = load_model(args)
    reference = None
    if args.mode == "kto":
        print("Building frozen reference model...")
        reference = load_model(args)
    train(args, model, reference, mesh)


def mode_trainer(args: argparse.Namespace, fields: dict, reference=None):
    """The trainer of `args.mode` over the `TrainArgs` fields `fields`,
    the mode's own flags and, for KTO, the reference model."""
    from csm_mlx_tpu_torch.finetune import trainer

    _, trainer_cls, args_cls, extra = MODES[args.mode]
    fields = dict(fields, **{k: getattr(args, k) for k in extra})
    if reference is not None:
        fields["reference_model"] = reference
    return getattr(trainer, trainer_cls)(getattr(trainer, args_cls)(**fields))


def make_mesh_if_requested(args: argparse.Namespace,
                           devices: Optional[str] = None):
    """A "data" mesh over every rank when --data-parallel or --fsdp is set,
    else None (JAX's). On the card (`devices` None) this initialises the
    process group from `torchrun`'s environment (NCCL, this rank's GPU: a
    run without `torchrun` is one rank); `devices="cpu"` makes it a mesh
    of CPU ranks over gloo (`parallel.create_mesh`)."""
    if not (getattr(args, "data_parallel", False)
            or getattr(args, "fsdp", False)):
        return None
    from csm_mlx_tpu_torch.parallel import create_mesh

    return create_mesh(devices=devices)


def param_sharding_mode(args: argparse.Namespace) -> str:
    return "fsdp" if getattr(args, "fsdp", False) else "replicated"


def load_model(args: argparse.Namespace):
    """The CSM of `--model` with the weights of `--pretrained-path`, on
    `cuda` (`device.resolve_device`)."""
    from csm_mlx_tpu_torch.device import resolve_device
    from csm_mlx_tpu_torch.loaders import load_csm_weights
    from csm_mlx_tpu_torch.models.csm import CSM

    print("Initializing model...")
    if not args.pretrained_path:
        raise SystemExit(
            "Error: pass --pretrained-path to fine-tune from a local "
            "checkpoint (pretrained weights are not downloaded)")
    print(f"Loading pretrained weights from {args.pretrained_path}")
    return CSM(MODEL[args.model]["config"],
               params=load_csm_weights(str(args.pretrained_path),
                                       device=resolve_device()))


def common_train_args(args: argparse.Namespace, model, trainable_filter,
                      mesh=None) -> dict:
    """The `TrainArgs` fields the flags set, over `model`: the optimizer
    of `--optimizer`, `--lr` and `--wd` (`finetune.trainer.build_optimizer`)
    and the given trainable-path filter; the run's mesh
    (`make_mesh_if_requested`, None for one process) and the parameter
    sharding of the parallel flags."""
    from csm_mlx_tpu_torch.finetune.trainer import build_optimizer

    return dict(
        model=model,
        optimizer=build_optimizer(args.optimizer, args.learning_rate,
                                  args.weight_decay),
        output_dir=args.output_dir,
        max_norm=args.max_norm,
        first_codebook_weight_multiplier=args.first_codebook_weight_multiplier,
        gradient_checkpointing=args.gradient_ckpt,
        ckpt_freq=args.ckpt_freq,
        log_freq=args.log_freq,
        learning_rate=args.learning_rate,
        decoder_loss_fraction=args.decoder_loss_fraction,
        mesh=mesh,
        param_sharding=param_sharding_mode(args),
        trainable_filter=trainable_filter,
    )


def load_dataset(args: argparse.Namespace, model):
    """The dataset of `args.mode` from `--data-path`, for `model`: its
    codebook count, and its audio encoded by the codec singleton on the
    model's device."""
    from csm_mlx_tpu_torch.finetune import dataset as datasets
    from csm_mlx_tpu_torch.tokenizers import get_audio_tokenizer

    print(f"Loading dataset from {args.data_path}")
    cls = getattr(datasets, MODES[args.mode][0])
    dataset = cls.from_json(
        str(args.data_path),
        n_audio_codebooks=model.n_audio_codebooks,
        max_audio_length_ms=args.max_audio_length_ms,
        mask_speaker_ids=args.mask_speaker_ids,
        mimi=get_audio_tokenizer(model.n_audio_codebooks,
                                 device=model.device),
    )
    print(f"Loaded {len(dataset)} samples")
    if len(dataset) == 0:
        raise SystemExit("Error: Dataset is empty. Please check the data "
                         "path and format.")
    if len(dataset) < args.batch_size:
        print(f"Warning: Dataset size ({len(dataset)}) is smaller than batch "
              f"size ({args.batch_size}). Consider reducing batch size.")
    return dataset
