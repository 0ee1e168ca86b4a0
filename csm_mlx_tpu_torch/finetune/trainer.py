"""Trainers: SFT (`CSMTrainer`), DPO and KTO, with checkpoints and resume
(port of `csm_mlx_tpu/finetune/trainer.py`).

- `train_step` runs the loss, the gradients of the trainable leaves,
  global-norm clipping min(1, max_norm / (gnorm + 1e-6)) and a torch
  optimizer step. Only the trainable tensors go to the optimizer. As in
  JAX, the clipping norm is taken over the gradients of every floating
  parameter, frozen ones included: with `max_norm > 0` the frozen leaves
  take gradients for the norm alone, freed after it.
- `TrainerState` / `History` / `TrainingRecord` keep the
  `trainer_state.json` schema and the resume arithmetic of the JAX `train`
  (per-epoch `RandomState(1234 + epoch)` shuffles, the exact-epoch-boundary
  case).
- `CheckpointManager` writes `latest.safetensors` (reference names,
  trainable-only on request), `optimizer_state.safetensors` (the port's own
  entry names) and `trainer_state.json` to `step_N/` and to the run root,
  and resumes from the root when the trainer is built. With
  `checkpoint_backend="orbax"` (JAX's name for its asynchronous saves) a
  save copies the tensors to host buffers and a background thread writes
  them once, to `step_N/orbax`, committed by a rename; resume takes the
  newest committed step.
- `gradient_checkpointing` recomputes every layer in the backward pass
  (`torch.utils.checkpoint`).
- `mesh` (a `parallel.create_mesh` DeviceMesh; JAX's `TrainArgs.mesh`)
  trains data-parallel, one process per rank: every rank gets the same
  global batch, pads a ragged one by cycling rows as JAX does, and runs
  its own rows (`_DataAxis`). Each masked mean of the loss, and DPO's and
  KTO's batch means, divide by the global count, so the ranks' gradients
  sum to the global batch's; they are all-reduced by sum
  (`param_sharding="replicated"`), or, with "fsdp", reduce-scattered to
  the shards in which parameters and optimizer state are stored
  (`parallel.mesh.fsdp_leaf_spec`), gathered whole for each step. The
  clipping norm is global. Checkpoints hold the whole tensors, written by
  rank 0 alone, so a run resumes at any world size; logs come from rank
  0. Only the "data" axis may exceed 1.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import threading
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
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
from csm_mlx_tpu_torch.parallel.mesh import (P, all_gather_leaf, axis_sizes,
                                             fsdp_leaf_spec,
                                             is_main_rank, local_shard,
                                             map_tree, reduce_scatter_leaf)

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
    mesh: Optional[Any] = None  # parallel.create_mesh: data parallelism
    # "replicated": parameters and optimizer state whole on every rank,
    # gradients all-reduced; "fsdp": both stored as this rank's shard
    # (ZeRO-3), gathered for a step, gradients reduce-scattered
    param_sharding: str = "replicated"
    trainable_filter: Optional[Callable[[str], bool]] = None  # LoRA
    flash_min_len: int = FLASH_MIN_LEN  # see finetune.loss
    checkpoint_backend: str = "safetensors"  # or "orbax" (async saves)


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
# The data axis
# ---------------------------------------------------------------------------


class _DataAxis:
    """A trainer's share of the mesh's "data" axis: this rank's rows of the
    global batch, the sums across ranks, and under FSDP the shards (specs
    by flat parameter name, `fsdp_leaf_spec` of the whole tensor)."""

    def __init__(self, mesh, param_sharding: str):
        if param_sharding not in ("replicated", "fsdp"):
            raise ValueError(f"param_sharding must be 'replicated' or "
                             f"'fsdp', not {param_sharding!r}")
        sizes = axis_sizes(mesh)
        others = {a: n for a, n in sizes.items() if a != "data" and n > 1}
        if "data" not in sizes or others:
            raise ValueError(
                f"the trainers shard the batch over a mesh's 'data' axis "
                f"only (JAX's trainer replicates parameters over the "
                f"others); got {sizes}")
        self.mesh = mesh
        self.group = mesh.get_group("data")
        self.n = sizes["data"]
        self.rank = mesh.get_local_rank("data")
        self.fsdp = param_sharding == "fsdp"
        self.specs: Dict[str, P] = {}

    def rows(self, batch: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """This rank's rows of the global batch. A batch that the axis
        does not divide (an epoch's ragged last one) is padded by cycling
        its rows, as JAX pads it: <= n - 1 samples count twice."""
        batch = {k: np.asarray(v) for k, v in batch.items()}
        b = next(iter(batch.values())).shape[0]
        if b % self.n:
            idx = np.resize(np.arange(b), b + self.n - b % self.n)
            batch = {k: v[idx] for k, v in batch.items()}
            b = len(idx)
        step = b // self.n
        return {k: v[self.rank * step:(self.rank + 1) * step]
                for k, v in batch.items()}

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the ranks, in place."""
        dist.all_reduce(t, group=self.group)
        return t

    def spec(self, name: str) -> P:
        return self.specs.get(name, P())

    def shard(self, params: Any) -> Any:
        """Under FSDP this rank's shards of a params tree (specs recorded
        by name); else the tree itself."""
        if not self.fsdp:
            return params

        def one(name, x):
            if not torch.is_tensor(x):
                return x
            self.specs[name] = fsdp_leaf_spec(x, self.mesh)
            return local_shard(x, self.specs[name], self.mesh)

        return map_tree(one, params)

    def gather(self, params: Any) -> Any:
        """The whole tensors of a tree of this rank's shards, as new tensors
        (a collective under FSDP); else the tree itself."""
        if not self.fsdp:
            return params
        return map_tree(lambda name, x: all_gather_leaf(
            x.detach(), self.spec(name), self.mesh)
            if torch.is_tensor(x) else x, params)

    def whole(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor of one shard of parameter `name`, or of its
        optimizer state (the shard's shape)."""
        return all_gather_leaf(local, self.spec(name), self.mesh)

    def local(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a whole tensor of parameter `name`."""
        return local_shard(whole, self.spec(name), self.mesh)

    def reduce_grads(self, names: List[str], grads: List[torch.Tensor]
                     ) -> List[torch.Tensor]:
        """The sum over the ranks of each gradient: whole (replicated), or
        this rank's shard of it (FSDP)."""
        if not self.fsdp:
            return [self.sum(g.contiguous()) for g in grads]
        return [reduce_scatter_leaf(g, self.spec(n), self.mesh)
                for n, g in zip(names, grads)]

    def square_sums(self, names: List[str], sq: List[torch.Tensor]
                    ) -> List[torch.Tensor]:
        """Per-leaf sums of squared gradients made global: a shard's sum
        is added over the ranks (one all-reduce), a whole leaf's is
        already the global one."""
        idx = [i for i, n in enumerate(names)
               if self.fsdp and self.spec(n) != P()]
        if idx:
            vec = self.sum(torch.stack([sq[i] for i in idx]))
            sq = list(sq)
            for j, i in enumerate(idx):
                sq[i] = vec[j]
        return sq


# ---------------------------------------------------------------------------
# Checkpointing
# ---------------------------------------------------------------------------

_JAX_OPT_KEY = re.compile(r"^opt\.\d+$")


class CheckpointManager:
    """Safetensors checkpoints in the JAX package's directory layout.

    `load()` resumes weights and trainer state and reads the optimizer
    file; the trainer then builds its optimizer over the resumed tensors
    and `attach`es it, which restores the optimizer state. Optimizer
    entries are named `state.<param name>.<state key>`; a file of the JAX
    package (optax leaves `opt.{i}`) is refused.

    `backend="safetensors"` writes every save to `step_N/` and to the run
    root, and resumes from the root. `backend="orbax"` saves
    asynchronously, as JAX's orbax backend does: `save()` copies the
    tensors into pinned host buffers on a side stream (the next step's
    optimizer update waits for the copies, `fence`) and a background
    thread waits for the copies and writes them once, to a
    temporary directory renamed to `step_N/orbax`, so a step directory is
    committed whole or not at all. Resume takes the newest committed step,
    its trainer state from the same directory. One save is in flight at a
    time; `wait()` blocks until it has committed.

    With `parallel` (a trainer's data axis) every rank resumes from the
    files; a save gathers FSDP shards into whole tensors (every rank takes
    part) and rank 0 alone writes and logs. Resume shards the whole
    optimizer state again (`attach`)."""

    def __init__(self, model: CSM, state: TrainerState, history: History,
                 checkpoint_dir: Path, only_save_trainable_params: bool = False,
                 trainable_filter: Optional[Callable[[str], bool]] = None,
                 backend: str = "safetensors",
                 parallel: Optional[_DataAxis] = None):
        if backend not in ("safetensors", "orbax"):
            raise ValueError(f"unknown checkpoint backend {backend!r}")
        self.model = model
        self.state = state
        self.history = history
        self.dir = Path(checkpoint_dir)
        self.only_save_trainable_params = only_save_trainable_params
        self.trainable_filter = trainable_filter
        self.backend = backend
        self.parallel = parallel
        self.writer = parallel is None or is_main_rank()
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.named: List[Tuple[str, torch.Tensor]] = []
        self._pending_opt: Optional[Dict[str, torch.Tensor]] = None
        self._writer: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None
        self._host: Dict[str, torch.Tensor] = {}  # reused snapshot buffers
        self._copy_stream: Optional[torch.cuda.Stream] = None
        self._copied: Optional[torch.cuda.Event] = None
        os.makedirs(self.dir, exist_ok=True)

    def attach(self, optimizer: torch.optim.Optimizer,
               named: List[Tuple[str, torch.Tensor]]) -> None:
        """Register the optimizer and its (name, tensor) parameters; apply
        the optimizer state `load()` read, if any."""
        self.optimizer, self.named = optimizer, named
        if self._pending_opt is not None:
            self._restore_opt(self._pending_opt)
            self._pending_opt = None

    def _log(self, msg: str) -> None:
        if self.writer:
            print(msg)

    def _whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of a parameter's (or its state's) shard."""
        t = t.detach()
        if self.parallel is None or t.ndim == 0:
            return t
        return self.parallel.whole(name, t)

    def _weights_flat(self) -> Dict[str, torch.Tensor]:
        flat = params_to_reference_flat(self.model.params)
        if self.only_save_trainable_params and self.trainable_filter:
            flat = {k: v for k, v in flat.items() if self.trainable_filter(k)}
        return {k: self._whole(k, v) for k, v in flat.items()}

    def _opt_flat(self) -> Dict[str, torch.Tensor]:
        flat = {}
        if self.optimizer is None:
            return flat
        for name, t in self.named:
            for key, val in self.optimizer.state.get(t, {}).items():
                if isinstance(val, torch.Tensor):
                    flat[f"state.{name}.{key}"] = self._whole(name, val)
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
                if key == "step":
                    state[key] = val.float().cpu()
                    continue
                val = val.to(device=t.device, dtype=t.dtype)
                if self.parallel is not None and val.ndim:
                    val = self.parallel.local(name, val)
                state[key] = val
            self.optimizer.state[t] = state

    def _trainer_state(self) -> dict:
        return {"trainer_state": asdict(self.state),
                "history": self.history.state}

    def save(self):
        if self.backend == "orbax":
            self._save_async()
            return
        suffix = f"step_{self.state.step}"
        trainer_state = self._trainer_state()
        weights = self._weights_flat()
        opt = self._opt_flat()
        if not self.writer:
            return
        for root in (self.dir / suffix, self.dir):
            os.makedirs(root, exist_ok=True)
            safetensors_io.save_file(weights, str(root / "latest.safetensors"))
            if opt:
                safetensors_io.save_file(
                    opt, str(root / "optimizer_state.safetensors"))
            with open(root / "trainer_state.json", "w") as f:
                json.dump(trainer_state, f, indent=2)
        self._log(f"Saved checkpoint (step {self.state.step})")

    def _snapshot(self, flat: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """Host copies of `flat`, into buffers kept across saves. Copies of
        CUDA tensors run on a side stream, behind the work that made them
        (`self._copied` marks their end): the next step's forward and
        backward overlap them, its optimizer update waits for them
        (`fence`), and the writer reads only after them."""
        out = {}
        cuda = [t for t in flat.values() if t.is_cuda]
        stream = None
        if cuda:
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(device=cuda[0].device)
            stream = self._copy_stream
            stream.wait_stream(torch.cuda.current_stream(cuda[0].device))
        with torch.cuda.stream(stream) if stream is not None \
                else contextlib.nullcontext():
            for name, t in flat.items():
                buf = self._host.get(name)
                if buf is None or buf.shape != t.shape \
                        or buf.dtype != t.dtype:
                    buf = torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=t.is_cuda)
                    self._host[name] = buf
                buf.copy_(t, non_blocking=t.is_cuda)
                out[name] = buf
            if stream is not None:
                self._copied = torch.cuda.Event()
                self._copied.record(stream)
        return out

    def fence(self) -> None:
        """Make the current stream wait for the last snapshot's copies: the
        trainer calls it before an optimizer update changes the tensors in
        place."""
        if self._copied is not None:
            torch.cuda.current_stream(self._copy_stream.device).wait_event(
                self._copied)
            self._copied = None

    def _save_async(self):
        self.wait()  # one save in flight at a time
        # every rank takes part in the gathers of FSDP shards
        weights, opt = self._weights_flat(), self._opt_flat()
        if not self.writer:
            return
        step_root = self.dir / f"step_{self.state.step}"
        os.makedirs(step_root, exist_ok=True)
        # the step's json first: a crash before the tensors commit leaves a
        # json-only step directory, which resume skips; the run root's json
        # shows progress only
        trainer_state = self._trainer_state()
        for root in (step_root, self.dir):
            with open(root / "trainer_state.json", "w") as f:
                json.dump(trainer_state, f, indent=2)
        if (step_root / "orbax").exists():
            # a same-step save (the end of an epoch right after a periodic
            # save) would write the same tensors
            self._log(f"Checkpoint step {self.state.step} already "
                      f"committed; refreshed trainer state only")
            return
        weights = self._snapshot(weights)
        opt = self._snapshot(opt)
        copied = self._copied  # the later one: one stream, in order

        def write():
            try:
                if copied is not None:
                    copied.synchronize()
                tmp = step_root / f".orbax-tmp-{os.getpid()}"
                os.makedirs(tmp, exist_ok=True)
                safetensors_io.save_file(weights,
                                         str(tmp / "latest.safetensors"))
                if opt:
                    safetensors_io.save_file(
                        opt, str(tmp / "optimizer_state.safetensors"))
                os.rename(tmp, step_root / "orbax")
            except BaseException as exc:  # re-raised by wait()
                self._write_error = exc

        self._writer = threading.Thread(target=write, daemon=True,
                                        name="checkpoint-writer")
        self._writer.start()
        self._log(f"Saved checkpoint (step {self.state.step}, orbax async)")

    def wait(self):
        """Block until the in-flight asynchronous save has committed; raise
        its error if it failed."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._write_error is not None:
            exc, self._write_error = self._write_error, None
            raise RuntimeError("asynchronous checkpoint save failed") from exc

    def _committed_steps(self) -> List[Path]:
        """step_N directories whose async save committed, newest first."""
        out = []
        for d in self.dir.glob("step_*"):
            if (d / "orbax").exists() and (d / "trainer_state.json").exists():
                try:
                    out.append((int(d.name.split("_", 1)[1]), d))
                except ValueError:
                    continue
        return [d for _, d in sorted(out, reverse=True)]

    def _check_backend_mismatch(self):
        """A run directory written by the other backend fails loudly. One
        of the async backend shows committed step_*/orbax directories, or
        (a run that crashed before its first commit) step directories with
        a trainer_state.json and no latest.safetensors, which the
        safetensors backend always writes there."""
        has_async = bool(list(self.dir.glob("step_*/orbax"))) or any(
            (d / "trainer_state.json").exists()
            and not (d / "latest.safetensors").exists()
            for d in self.dir.glob("step_*"))
        has_st = (self.dir / "latest.safetensors").exists()
        if self.backend == "safetensors" and has_async and not has_st:
            raise ValueError(
                f"{self.dir} holds an orbax checkpoint but the trainer was "
                f"built with checkpoint_backend='safetensors'; pass "
                f"checkpoint_backend='orbax' to resume it.")
        if self.backend == "orbax" and has_st and not has_async:
            raise ValueError(
                f"{self.dir} holds a safetensors checkpoint but the trainer "
                f"was built with checkpoint_backend='orbax'; pass "
                f"checkpoint_backend='safetensors' to resume it.")

    def _read_opt(self, opt_path: Path) -> None:
        flat = safetensors_io.load_file(str(opt_path))
        jax_keys = [k for k in flat if _JAX_OPT_KEY.match(k)]
        if jax_keys:
            raise ValueError(
                f"{opt_path} holds optax leaves ({jax_keys[0]}, ...) "
                f"written by the JAX package; the port cannot resume that "
                f"optimizer state. Remove the file to resume the weights "
                f"alone, or continue with the JAX trainer.")
        self._pending_opt = flat  # applied by attach()
        self._log(f"Loaded optimizer state from {opt_path}")

    def _apply_trainer_state(self, state_path: Path) -> bool:
        if not state_path.exists():
            return False
        with open(state_path) as f:
            trainer_state = json.load(f)
        ts = trainer_state["trainer_state"]
        self.state.step = ts["step"]
        self.state.epoch = ts["epoch"]
        self.state.learning_rate = ts["learning_rate"]
        self.history.state = trainer_state["history"]
        self._log(f"Loaded trainer state (step {self.state.step})")
        return True

    def _load_async(self) -> bool:
        for step_dir in self._committed_steps():
            data = step_dir / "orbax"
            try:
                self.model.load_weights(str(data / "latest.safetensors"),
                                        strict=False)
            except (OSError, ValueError, KeyError) as exc:
                self._log(f"[WARN] could not resume from {step_dir}: {exc}; "
                          f"trying an older checkpoint")
                continue
            self._log(f"Loaded latest run weights from {data}")
            if (data / "optimizer_state.safetensors").exists():
                self._read_opt(data / "optimizer_state.safetensors")
            # the step counter of the same committed step: the run root's
            # json may be a step ahead of the newest commit
            self._apply_trainer_state(step_dir / "trainer_state.json")
            return True
        return False

    def load(self):
        self._check_backend_mismatch()
        if self.backend == "orbax":
            if not self._load_async():
                self._log("Trainer state not found. Starting fresh training.")
            return
        weights_path = self.dir / "latest.safetensors"
        opt_path = self.dir / "optimizer_state.safetensors"
        if weights_path.exists():
            self.model.load_weights(str(weights_path), strict=False)
            self._log(f"Loaded latest run weights from {weights_path}")
        if opt_path.exists():
            self._read_opt(opt_path)
        if not self._apply_trainer_state(self.dir / "trainer_state.json"):
            self._log("Trainer state not found. Starting fresh training.")


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
        # every rank must hold the same parameters (the same checkpoint or
        # seed): each builds its own copy
        self.parallel = (_DataAxis(args.mesh, args.param_sharding)
                         if args.mesh is not None else None)
        self.checkpointer = CheckpointManager(
            self.model, self.state, self.history, args.output_dir,
            args.only_save_trainable_params, args.trainable_filter,
            backend=args.checkpoint_backend, parallel=self.parallel)
        self.is_writer = self.checkpointer.writer
        self.checkpointer.load()
        if self.parallel is not None:
            self.model.params = self.parallel.shard(self.model.params)
        self.trainable = self._mark_trainable()
        self.optimizer = args.optimizer([t for _, t in self.trainable])
        self.checkpointer.attach(self.optimizer, self.trainable)
        # dropout seeds and decoder rows: the same state on every rank
        self._generator = torch.Generator()
        self._generator.manual_seed(0)

    def _mark_trainable(self) -> List[Tuple[str, torch.Tensor]]:
        """Set `requires_grad` on the floating leaves that train (all, or
        those `trainable_filter` selects) and clear it on the rest."""
        flt = self.args.trainable_filter
        named = []
        # the frozen floating leaves: their gradients enter the clipping
        # norm (train_step), as in JAX
        self.frozen: List[Tuple[str, torch.Tensor]] = []
        for name, t in tree_to_flat(self.model.params).items():
            train = t.is_floating_point() and (flt is None or flt(name))
            t.requires_grad_(train)
            if train:
                named.append((name, t))
            elif t.is_floating_point():
                self.frozen.append((name, t))
        if not named:
            raise ValueError("no parameter is trainable")
        return named

    # -- loss (overridden by DPO/KTO) -----------------------------------
    def _dropout_rng(self, generator):
        """LoRA dropout is live only inside this scope; each rank of a mesh
        draws its own rows' masks."""
        return lora_dropout_rng(generator, stream=self.parallel.rank
                                if self.parallel is not None else 0)

    def _data_group(self):
        return self.parallel.group if self.parallel is not None else None

    def _batch_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the global batch of per-row values (this rank's
        share, under a mesh: its sum over the global row count)."""
        if self.parallel is None:
            return x.mean()
        return x.sum() / (x.shape[0] * self.parallel.n)

    def _loss_fn(self, params, batch, generator):
        with self._dropout_rng(generator):
            return compute_loss(
                params, self.model.args, batch,
                first_codebook_weight_multiplier=
                    self.args.first_codebook_weight_multiplier,
                decoder_loss_fraction=self.args.decoder_loss_fraction,
                remat=self.args.gradient_checkpointing,
                generator=generator,
                flash_min_len=self.args.flash_min_len,
                data_group=self._data_group(),
            )

    def _prepare_batch(self, batch) -> Dict[str, torch.Tensor]:
        """The step's batch on the model's device: under a mesh, this
        rank's rows of the global batch."""
        if self.parallel is not None:
            batch = self.parallel.rows(batch)
        return {k: torch.as_tensor(np.asarray(v)).to(self.model.device)
                for k, v in batch.items()}

    def full_params(self) -> Dict[str, Any]:
        """The model's whole parameters: under FSDP gathered from every
        rank's shards (a collective: every rank calls it), else the
        model's own."""
        if self.parallel is None:
            return self.model.params
        return self.parallel.gather(self.model.params)

    def train_step(self, batch: Dict[str, np.ndarray]) -> float:
        """One step: loss, gradients of the trainable leaves, clipping,
        optimizer update. Returns the loss.

        The clipping norm is JAX's `optax.global_norm` over the gradients
        of every floating parameter: with `max_norm > 0` the frozen leaves
        take gradients for the norm only (never the optimizer), freed once
        it is taken.

        Under a mesh the step takes this rank's rows of `batch` (the global
        batch, the same on every rank); the gradients are summed over the
        ranks (under FSDP into this rank's shards, after a step on the
        gathered whole tensors) and the norm is the global one. Returns the
        global batch's loss on every rank."""
        dp = self.parallel
        n_train = len(self.trainable)
        named = self.trainable + (self.frozen if self.args.max_norm > 0
                                  else [])
        names = [n for n, _ in named]
        batch = self._prepare_batch(batch)
        if dp is not None and dp.fsdp:
            params = dp.gather(self.model.params)
            flat = tree_to_flat(params)
            leaves = [flat[n].requires_grad_(True) for n in names]
            del flat
            toggled = []
        else:
            params = self.model.params
            leaves = [t for _, t in named]
            toggled = leaves[n_train:]
        for t in toggled:
            t.requires_grad_(True)
        try:
            loss = self._loss_fn(params, batch, self._generator)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for t in toggled:
                t.requires_grad_(False)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        del params, leaves
        if dp is not None:
            grads = dp.reduce_grads(names, grads)
        if self.args.max_norm > 0:
            sq = [g.float().square().sum() for g in grads]
            if dp is not None:
                sq = dp.square_sums(names, sq)
            gnorm = torch.sqrt(sum(sq))
            scale = torch.clamp(self.args.max_norm / (gnorm + 1e-6), max=1.0)
            for g in grads[:n_train]:
                g.mul_(scale.to(g.dtype))
        for (_, t), g in zip(self.trainable, grads):
            t.grad = g
        del grads  # the frozen leaves' gradients
        self.checkpointer.fence()  # an async save's copies read them first
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        loss = loss.detach()
        if dp is not None:
            loss = dp.sum(loss.clone())
        return float(loss)

    def _log(self, msg: str) -> None:
        self.checkpointer._log(msg)

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
            self._log(f"Resuming from Epoch {start_epoch + 1}, Step "
                      f"{start_step + 1}")

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
                self._log(f"Epoch {epoch + 1} already fully completed in "
                          f"previous run. Skipping.")
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
                    self._log(f"Epoch {epoch + 1}/{epochs} step "
                              f"{self.state.step} loss {loss:.4f}")
                if self.args.ckpt_freq > 0 and \
                        self.state.step % self.args.ckpt_freq == 0:
                    self.checkpointer.save()

            self._log(f"Epoch {epoch + 1} average loss: "
                  f"{epoch_loss / n_batches:.4f}")
            self.state.epoch = epoch + 1
            self._log(f"Completed Epoch {epoch + 1}. Saving checkpoint.")
            self.checkpointer.save()
        self.checkpointer.wait()  # commit an in-flight async save
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
        with self._dropout_rng(generator):
            chosen = compute_loss(params, args, part("chosen"), **kw)
            rejected = compute_loss(params, args, part("rejected"), **kw)
        margin = -(chosen - rejected) * self.beta
        return self._batch_mean(-F.logsigmoid(margin))


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
        # the frozen reference takes the policy's placement (JAX
        # trainer.py:726-736): under FSDP each rank stores its shards, and
        # the loss gathers them. The caller's model is re-placed in place.
        if self.parallel is not None:
            self.reference_model.params = self.parallel.shard(
                self.reference_model.params)

    def _loss_fn(self, params, batch, generator):
        args = self.model.args
        core = {k: batch[k] for k in ("tokens", "masks", "loss_masks")}
        kw = dict(per_sample=True,
                  first_codebook_weight_multiplier=
                      self.args.first_codebook_weight_multiplier,
                  flash_min_len=self.args.flash_min_len)
        with torch.no_grad():  # the frozen reference, deterministic
            ref_params = (self.reference_model.params if self.parallel is None
                          else self.parallel.gather(
                              self.reference_model.params))
            kl_reference = compute_loss(ref_params, args, core,
                                        cause_mismatch=True, **kw)
            reference = compute_loss(ref_params, args, core, **kw)
            del ref_params
        remat = self.args.gradient_checkpointing
        with self._dropout_rng(generator):
            # the KL proxy is a detached baseline: no gradient flows
            # through it, so it runs without one
            with torch.no_grad():
                kl_policy = compute_loss(params, args, core,
                                         cause_mismatch=True, remat=remat,
                                         **kw)
            policy = compute_loss(params, args, core, remat=remat, **kw)

        reward = policy - reference
        kl = self._batch_mean(kl_policy - kl_reference)
        if self.parallel is not None:
            kl = self.parallel.sum(kl)
        kl = torch.clamp(kl, min=0.0)
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
        return self._batch_mean(losses)
