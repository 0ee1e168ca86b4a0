"""Trainers: SFT (`CSMTrainer`), DPO and KTO, with checkpoints and resume
(port of `csm_mlx_tpu/finetune/trainer.py`).

- `train_step` runs the loss, the gradients of the trainable leaves (those
  that carry `requires_grad`), global-norm clipping
  min(1, max_norm / (gnorm + 1e-6)) and a torch optimizer step. Only the
  trainable tensors go to the optimizer.
- Clipping takes the norm over the trainable leaves' gradients. The JAX
  step takes it over every parameter's gradient, frozen ones included,
  and then zeroes the frozen updates; the two agree whenever every
  parameter trains (full SFT) or clipping is off (`max_norm=0`).
- `TrainerState` / `History` / `TrainingRecord` keep the
  `trainer_state.json` schema and the resume arithmetic of the JAX `train`
  (per-epoch `RandomState(1234 + epoch)` shuffles, the exact-epoch-boundary
  case).
- `CheckpointManager` writes `latest.safetensors` (reference names,
  trainable-only on request), `optimizer_state.safetensors` (the port's own
  entry names) and `trainer_state.json` to `step_N/` and to the run root,
  and resumes from the root when the trainer is built.
- `gradient_checkpointing` recomputes every layer in the backward pass
  (`torch.utils.checkpoint`).

Not ported: the orbax backend and the mesh / FSDP options (ROADMAP queue
1, items 9 and 12).
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from csm_mlx_tpu_torch import safetensors_io
from csm_mlx_tpu_torch.finetune.dataset import (
    CSMDataset,
    CSMPairwiseDataset,
    CSMPointwiseDataset,
)
from csm_mlx_tpu_torch.finetune.loss import FLASH_MIN_LEN, compute_loss
from csm_mlx_tpu_torch.loaders import params_to_reference_flat, tree_to_flat
from csm_mlx_tpu_torch.models.csm import CSM
from csm_mlx_tpu_torch.ops.layers import lora_dropout_rng

OptimizerFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


def build_optimizer(name: str, learning_rate: float,
                    weight_decay: float = 0.0) -> OptimizerFactory:
    """The optimizer of `cli/finetune/common.py::build_optimizer`, as a
    factory over the trainable tensors: adam, adamw with its weight decay
    passed explicitly (optax's default is 1e-4, torch's 1e-2), or sgd with
    coupled decay (optax's add_decayed_weights before sgd)."""
    if name == "adam":
        if weight_decay > 0:
            print(f"Warning: Weight decay {weight_decay} requested for Adam "
                  f"optimizer; Adam does not support it. Ignoring.")
        return lambda params: torch.optim.Adam(params, lr=learning_rate)
    if name == "sgd":
        return lambda params: torch.optim.SGD(params, lr=learning_rate,
                                              weight_decay=weight_decay)
    if name == "adamw":
        return lambda params: torch.optim.AdamW(params, lr=learning_rate,
                                                weight_decay=weight_decay)
    raise ValueError(f"Invalid optimizer choice {name}")


@dataclass
class TrainArgs:
    model: CSM
    optimizer: OptimizerFactory  # e.g. build_optimizer("adamw", 1e-5, 0.0)
    output_dir: Path
    first_codebook_weight_multiplier: float = 1.0
    max_norm: float = 1.0
    gradient_checkpointing: bool = False
    log_freq: int = 1
    ckpt_freq: int = 1
    only_save_trainable_params: bool = False
    decoder_loss_fraction: float = 1.0
    learning_rate: Optional[float] = None  # for state reporting only
    trainable_filter: Optional[Callable[[str], bool]] = None  # LoRA
    flash_min_len: int = FLASH_MIN_LEN  # see finetune.loss


@dataclass
class DPOArgs(TrainArgs):
    beta: float = 0.1


@dataclass
class KTOArgs(TrainArgs):
    reference_model: Optional[CSM] = None
    beta: float = 0.1
    desirable_weight: float = 1.0
    undesirable_weight: float = 1.0


@dataclass
class TrainerState:
    step: int = 0
    epoch: int = 0
    learning_rate: float = 0.0


@dataclass
class TrainingRecord:
    step: int
    epoch: int
    loss: float
    learning_rate: float


class History:
    def __init__(self):
        self.records: List[TrainingRecord] = []

    def log(self, step: int, epoch: int, loss: float, lr: float):
        self.records.append(TrainingRecord(step, epoch, loss, lr))

    @property
    def state(self):
        return [asdict(r) for r in self.records]

    @state.setter
    def state(self, records: List[Dict]):
        self.records = [TrainingRecord(**r) for r in records]


# ---------------------------------------------------------------------------
# Checkpointing
# ---------------------------------------------------------------------------

_JAX_OPT_KEY = re.compile(r"^opt\.\d+$")


class CheckpointManager:
    """Safetensors checkpoints in the JAX package's directory layout.

    `load()` resumes weights and trainer state from the run root and reads
    the optimizer file; the trainer then builds its optimizer over the
    resumed tensors and `attach`es it, which restores the optimizer state.
    Optimizer entries are named `state.<param name>.<state key>`; a file of
    the JAX package (optax leaves `opt.{i}`) is refused."""

    def __init__(self, model: CSM, state: TrainerState, history: History,
                 checkpoint_dir: Path, only_save_trainable_params: bool = False,
                 trainable_filter: Optional[Callable[[str], bool]] = None):
        self.model = model
        self.state = state
        self.history = history
        self.dir = Path(checkpoint_dir)
        self.only_save_trainable_params = only_save_trainable_params
        self.trainable_filter = trainable_filter
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.named: List[Tuple[str, torch.Tensor]] = []
        self._pending_opt: Optional[Dict[str, torch.Tensor]] = None
        os.makedirs(self.dir, exist_ok=True)

    def attach(self, optimizer: torch.optim.Optimizer,
               named: List[Tuple[str, torch.Tensor]]) -> None:
        """Register the optimizer and its (name, tensor) parameters; apply
        the optimizer state `load()` read, if any."""
        self.optimizer, self.named = optimizer, named
        if self._pending_opt is not None:
            self._restore_opt(self._pending_opt)
            self._pending_opt = None

    def _weights_flat(self) -> Dict[str, torch.Tensor]:
        flat = params_to_reference_flat(self.model.params)
        if self.only_save_trainable_params and self.trainable_filter:
            flat = {k: v for k, v in flat.items() if self.trainable_filter(k)}
        return {k: v.detach() for k, v in flat.items()}

    def _opt_flat(self) -> Dict[str, torch.Tensor]:
        flat = {}
        if self.optimizer is None:
            return flat
        for name, t in self.named:
            for key, val in self.optimizer.state.get(t, {}).items():
                if isinstance(val, torch.Tensor):
                    flat[f"state.{name}.{key}"] = val.detach()
        return flat

    def _restore_opt(self, flat: Dict[str, torch.Tensor]) -> None:
        for name, t in self.named:
            prefix = f"state.{name}."
            entries = {k[len(prefix):]: v for k, v in flat.items()
                       if k.startswith(prefix) and "." not in k[len(prefix):]}
            if not entries:
                continue
            state = {}
            for key, val in entries.items():
                # torch keeps the step count as an fp32 tensor on the CPU
                state[key] = (val.float().cpu() if key == "step"
                              else val.to(device=t.device, dtype=t.dtype))
            self.optimizer.state[t] = state

    def save(self):
        suffix = f"step_{self.state.step}"
        trainer_state = {"trainer_state": asdict(self.state),
                         "history": self.history.state}
        weights = self._weights_flat()
        opt = self._opt_flat()
        for root in (self.dir / suffix, self.dir):
            os.makedirs(root, exist_ok=True)
            safetensors_io.save_file(weights, str(root / "latest.safetensors"))
            if opt:
                safetensors_io.save_file(
                    opt, str(root / "optimizer_state.safetensors"))
            with open(root / "trainer_state.json", "w") as f:
                json.dump(trainer_state, f, indent=2)
        print(f"Saved checkpoint (step {self.state.step})")

    def load(self):
        weights_path = self.dir / "latest.safetensors"
        state_path = self.dir / "trainer_state.json"
        opt_path = self.dir / "optimizer_state.safetensors"
        if weights_path.exists():
            self.model.load_weights(str(weights_path), strict=False)
            print(f"Loaded latest run weights from {weights_path}")
        if opt_path.exists():
            flat = safetensors_io.load_file(str(opt_path))
            jax_keys = [k for k in flat if _JAX_OPT_KEY.match(k)]
            if jax_keys:
                raise ValueError(
                    f"{opt_path} holds optax leaves ({jax_keys[0]}, ...) "
                    f"written by the JAX package; the port cannot resume that "
                    f"optimizer state. Remove the file to resume the weights "
                    f"alone, or continue with the JAX trainer.")
            self._pending_opt = flat  # applied by attach()
            print(f"Loaded optimizer state from {opt_path}")
        if not state_path.exists():
            print("Trainer state not found. Starting fresh training.")
            return
        with open(state_path) as f:
            trainer_state = json.load(f)
        ts = trainer_state["trainer_state"]
        self.state.step = ts["step"]
        self.state.epoch = ts["epoch"]
        self.state.learning_rate = ts["learning_rate"]
        self.history.state = trainer_state["history"]
        print(f"Loaded trainer state (step {self.state.step})")


# ---------------------------------------------------------------------------
# SFT trainer
# ---------------------------------------------------------------------------


class CSMTrainer:
    """CSM SFT trainer."""

    loss_requires: type = CSMDataset

    def __init__(self, args: TrainArgs):
        self.model = args.model
        self.args = args
        # Derived "_" entries (kernel 3's tables) go stale as soon as the
        # weights move: training drops them.
        for k in [k for k in self.model.params
                  if isinstance(k, str) and k.startswith("_")]:
            del self.model.params[k]
        self.state = TrainerState(learning_rate=float(args.learning_rate or 0.0))
        self.history = History()
        self.checkpointer = CheckpointManager(
            self.model, self.state, self.history, args.output_dir,
            args.only_save_trainable_params, args.trainable_filter)
        self.checkpointer.load()
        self.trainable = self._mark_trainable()
        self.optimizer = args.optimizer([t for _, t in self.trainable])
        self.checkpointer.attach(self.optimizer, self.trainable)
        self._generator = torch.Generator()  # dropout seeds, decoder rows
        self._generator.manual_seed(0)

    def _mark_trainable(self) -> List[Tuple[str, torch.Tensor]]:
        """Set `requires_grad` on the floating leaves that train (all, or
        those `trainable_filter` selects) and clear it on the rest."""
        flt = self.args.trainable_filter
        named = []
        for name, t in tree_to_flat(self.model.params).items():
            train = t.is_floating_point() and (flt is None or flt(name))
            t.requires_grad_(train)
            if train:
                named.append((name, t))
        if not named:
            raise ValueError("no parameter is trainable")
        return named

    # -- loss (overridden by DPO/KTO) -----------------------------------
    def _loss_fn(self, params, batch, generator):
        # LoRA dropout is live only inside this scope
        with lora_dropout_rng(generator):
            return compute_loss(
                params, self.model.args, batch,
                first_codebook_weight_multiplier=
                    self.args.first_codebook_weight_multiplier,
                decoder_loss_fraction=self.args.decoder_loss_fraction,
                remat=self.args.gradient_checkpointing,
                generator=generator,
                flash_min_len=self.args.flash_min_len,
            )

    def _prepare_batch(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v)).to(self.model.device)
                for k, v in batch.items()}

    def train_step(self, batch: Dict[str, np.ndarray]) -> float:
        """One step: loss, gradients of the trainable leaves, clipping,
        optimizer update. Returns the loss."""
        loss = self._loss_fn(self.model.params, self._prepare_batch(batch),
                             self._generator)
        tensors = [t for _, t in self.trainable]
        grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(tensors, grads)]
        if self.args.max_norm > 0:
            gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
            scale = torch.clamp(self.args.max_norm / (gnorm + 1e-6), max=1.0)
            for g in grads:
                g.mul_(scale.to(g.dtype))
        for t, g in zip(tensors, grads):
            t.grad = g
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        return float(loss.detach())

    # -- epoch loop -------------------------------------------------------
    def train(self, dataset, batch_size: int, epochs: int,
              shuffle: bool = True) -> History:
        if not isinstance(dataset, self.loss_requires):
            raise TypeError(
                f"Please use `{self.loss_requires.__name__}` instead of other "
                f"dataset types.")
        num_samples = len(dataset)
        steps_per_epoch = (num_samples + batch_size - 1) // batch_size

        start_epoch = self.state.epoch
        start_step = self.state.step
        resume_batch_idx = 0
        if start_epoch < epochs and start_step > 0:
            completed = start_epoch * steps_per_epoch
            if start_step > completed:
                # start_step - completed, not start_step % steps_per_epoch: a
                # checkpoint at exactly the last step of an epoch resumes as
                # "epoch done"
                resume_batch_idx = min(start_step - completed,
                                       steps_per_epoch)
        if start_epoch > 0 or resume_batch_idx > 0:
            print(f"Resuming from Epoch {start_epoch + 1}, Step {start_step + 1}")

        for epoch in range(start_epoch, epochs):
            indices = np.arange(num_samples)
            if shuffle:
                # per-epoch seed: a mid-epoch resume recreates the same order
                indices = np.random.RandomState(1234 + epoch).permutation(
                    indices)
            batch_indices = [indices[i: i + batch_size].tolist()
                             for i in range(0, num_samples, batch_size)]
            start_idx = resume_batch_idx if epoch == start_epoch else 0
            remaining = batch_indices[start_idx:]
            if not remaining:
                print(f"Epoch {epoch + 1} already fully completed in previous "
                      f"run. Skipping.")
                self.state.epoch = epoch + 1
                continue

            epoch_loss, n_batches = 0.0, 0
            for batch_idx_list in remaining:
                loss = self.train_step(dataset.get_batch(batch_idx_list))
                self.state.step += 1
                if self.args.learning_rate is not None:
                    self.state.learning_rate = float(self.args.learning_rate)
                epoch_loss += loss
                n_batches += 1
                if self.args.log_freq > 0 and \
                        self.state.step % self.args.log_freq == 0:
                    self.history.log(self.state.step, epoch, loss,
                                     self.state.learning_rate)
                    print(f"Epoch {epoch + 1}/{epochs} step {self.state.step}"
                          f" loss {loss:.4f}")
                if self.args.ckpt_freq > 0 and \
                        self.state.step % self.args.ckpt_freq == 0:
                    self.checkpointer.save()

            print(f"Epoch {epoch + 1} average loss: "
                  f"{epoch_loss / n_batches:.4f}")
            self.state.epoch = epoch + 1
            print(f"Completed Epoch {epoch + 1}. Saving checkpoint.")
            self.checkpointer.save()
        return self.history


# ---------------------------------------------------------------------------
# DPO
# ---------------------------------------------------------------------------

_PREFERENCE_DLF = ("decoder_loss_fraction is not supported by preference "
                   "trainers (per-sample losses must score the same decoder "
                   "positions).")


class DPOTrainer(CSMTrainer):
    """Sigmoid-margin preference trainer."""

    loss_requires = CSMPairwiseDataset

    def __init__(self, args: DPOArgs):
        if not isinstance(args, DPOArgs):
            raise TypeError("Please use `DPOArgs` instead of other trainer's "
                            "arguments.")
        if args.decoder_loss_fraction != 1.0:
            raise ValueError(_PREFERENCE_DLF)
        super().__init__(args)
        self.beta = args.beta

    def _loss_fn(self, params, batch, generator):
        def part(prefix):
            return {k: batch[f"{prefix}_{k}"]
                    for k in ("tokens", "masks", "loss_masks")}

        kw = dict(per_sample=True, remat=self.args.gradient_checkpointing,
                  first_codebook_weight_multiplier=
                      self.args.first_codebook_weight_multiplier,
                  flash_min_len=self.args.flash_min_len)
        args = self.model.args
        with lora_dropout_rng(generator):
            chosen = compute_loss(params, args, part("chosen"), **kw)
            rejected = compute_loss(params, args, part("rejected"), **kw)
        margin = -(chosen - rejected) * self.beta
        return torch.mean(-F.logsigmoid(margin))


# ---------------------------------------------------------------------------
# KTO
# ---------------------------------------------------------------------------


class KTOTrainer(CSMTrainer):
    """KTO trainer with a frozen reference model."""

    loss_requires = CSMPointwiseDataset

    def __init__(self, args: KTOArgs):
        if not isinstance(args, KTOArgs):
            raise TypeError("Please use `KTOArgs` instead of other trainer's "
                            "arguments.")
        if args.reference_model is None:
            raise ValueError("Reference model must be provided.")
        if args.decoder_loss_fraction != 1.0:
            raise ValueError(_PREFERENCE_DLF)
        super().__init__(args)
        self.beta = args.beta
        self.desirable_weight = args.desirable_weight
        self.undesirable_weight = args.undesirable_weight
        self.reference_model = args.reference_model

    def _loss_fn(self, params, batch, generator):
        args = self.model.args
        core = {k: batch[k] for k in ("tokens", "masks", "loss_masks")}
        kw = dict(per_sample=True,
                  first_codebook_weight_multiplier=
                      self.args.first_codebook_weight_multiplier,
                  flash_min_len=self.args.flash_min_len)
        ref_params = self.reference_model.params
        with torch.no_grad():  # the frozen reference, deterministic
            kl_reference = compute_loss(ref_params, args, core,
                                        cause_mismatch=True, **kw)
            reference = compute_loss(ref_params, args, core, **kw)
        remat = self.args.gradient_checkpointing
        with lora_dropout_rng(generator):
            # the KL proxy is a detached baseline: no gradient flows
            # through it, so it runs without one
            with torch.no_grad():
                kl_policy = compute_loss(params, args, core,
                                         cause_mismatch=True, remat=remat,
                                         **kw)
            policy = compute_loss(params, args, core, remat=remat, **kw)

        reward = policy - reference
        kl = torch.clamp(torch.mean(kl_policy - kl_reference), min=0.0)
        penalized_reward = reward - kl

        preferences = batch["preferences"]
        desirable = (preferences > 0).float()
        undesirable = (preferences < 0).float()
        losses = (
            self.desirable_weight * desirable
            * (1.0 - torch.sigmoid(self.beta * penalized_reward))
            + self.undesirable_weight * undesirable
            * (1.0 - torch.sigmoid(-self.beta * penalized_reward))
        )
        return losses.mean()
