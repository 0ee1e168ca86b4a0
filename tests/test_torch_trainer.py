"""The port's trainers against the JAX package's on the tiny config, fp32:
parameters after each SFT step (adam, adamw, sgd; clipping active), LoRA
steps (clipping off, and one step that clips), the DPO and KTO losses, and
checkpoints (save, resume, the exact-epoch boundary, the shuffle order,
files read by the other package, the asynchronous backend)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conftest import tiny_args
from csm_mlx_tpu.finetune import lora as jax_lora
from csm_mlx_tpu.finetune import trainer as jax_trainer
from csm_mlx_tpu.finetune.dataset import CSMDataset as JaxDataset
from csm_mlx_tpu.loaders import tree_to_flat as jax_flat
from csm_mlx_tpu.models.csm import CSM as JaxCSM
from csm_mlx_tpu_torch.finetune import lora, trainer
from csm_mlx_tpu_torch.finetune.dataset import CSMDataset
from csm_mlx_tpu_torch.finetune.trainer import build_optimizer
from csm_mlx_tpu_torch.loaders import tree_to_flat
from test_torch_loss import make_batch
from torch_helpers import torch_model_from_jax

# Parameters after each step: fp32, gradients equal up to sum order; the
# optimizers' arithmetic is the same formula in another order. Each leaf is
# held to rtol 1e-5 of its largest magnitude, and to 1e-4 of one step's
# size (LR) for leaves that start at zero (lora_b).
RTOL = 1e-5
LR = 1e-3


def jax_model(seed):
    model = JaxCSM(tiny_args(), dtype=jnp.float32, rng=jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed + 100)
    head = model.params["audio_head"]
    model.params["audio_head"] = jnp.asarray(
        rng.randn(*head.shape).astype(np.float32) * 0.5)
    return model


def assert_params_close(port_params, jax_params, rtol=RTOL):
    got, want = tree_to_flat(port_params), jax_flat(jax_params)
    assert set(got) == set(want)
    for k, v in got.items():
        w = np.asarray(want[k])
        np.testing.assert_allclose(
            v.detach().numpy(), w, rtol=rtol,
            atol=max(rtol * np.abs(w).max(), 10 * rtol * LR), err_msg=k)


class Items:
    """Pre-tokenized items (the Mimi encoder is not ported); records the
    batches it hands out."""

    def __init__(self, args, n=4):
        self.items = [make_batch(args, b=1, s=6, seed=20 + i)
                      for i in range(n)]
        self.seen = []

    def __len__(self):
        return len(self.items)

    def get_batch(self, indices):
        self.seen.append(list(indices))
        parts = [self.items[i] for i in indices]
        return {k: np.concatenate([p[k] for p in parts], axis=0)
                for k in parts[0]}


class PortItems(Items, CSMDataset):
    pass


class JaxItems(Items, JaxDataset):
    pass


# Adam divides each element by |g| + eps: where |g| is below the default
# eps of 1e-8, sum-order noise in g becomes a visible share of the update.
# eps = 1e-4 on both sides keeps the update a smooth function of g, so the
# parameters can be held to rtol 1e-5 (build_optimizer's own choices are
# checked in test_build_optimizer_matches_the_cli).
EPS = 1e-4
OPTIMIZERS = {
    "adam": (lambda: optax.adam(LR, eps=EPS),
             lambda: lambda ps: torch.optim.Adam(ps, lr=LR, eps=EPS)),
    "adamw": (lambda: optax.adamw(LR, eps=EPS, weight_decay=0.05),
              lambda: lambda ps: torch.optim.AdamW(ps, lr=LR, eps=EPS,
                                                   weight_decay=0.05)),
    "sgd": (lambda: optax.chain(optax.add_decayed_weights(0.05),
                                optax.sgd(0.1)),
            lambda: build_optimizer("sgd", 0.1, 0.05)),
}


def test_build_optimizer_matches_the_cli():
    """adam, adamw with the weight decay passed explicitly (optax's default
    is 1e-4, torch's 1e-2), sgd with coupled decay."""
    p = [torch.zeros(3, requires_grad=True)]
    adam = build_optimizer("adam", 0.5, 0.1)(p)
    adamw = build_optimizer("adamw", 0.5, 0.02)(p)
    sgd = build_optimizer("sgd", 0.5, 0.03)(p)
    assert type(adam) is torch.optim.Adam
    assert adam.defaults["weight_decay"] == 0
    assert type(adamw) is torch.optim.AdamW
    assert adamw.defaults["weight_decay"] == 0.02
    assert type(sgd) is torch.optim.SGD and sgd.defaults["weight_decay"] == 0.03
    assert all(o.defaults["lr"] == 0.5 for o in (adam, adamw, sgd))
    with pytest.raises(ValueError, match="Invalid optimizer"):
        build_optimizer("lion", 0.5)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_sft_steps_match_jax(tmp_path, name):
    """Three full-SFT train_steps with clipping active (max_norm 1): the
    loss and every parameter after each step, rtol 1e-5."""
    jm = jax_model(1)
    pm = torch_model_from_jax(jm)
    make_jax, make_port = OPTIMIZERS[name]
    jt = jax_trainer.CSMTrainer(jax_trainer.TrainArgs(
        model=jm, optimizer=make_jax(), output_dir=tmp_path / "jax",
        ckpt_freq=0, max_norm=1.0))
    pt = trainer.CSMTrainer(trainer.TrainArgs(
        model=pm, optimizer=make_port(), output_dir=tmp_path / "port",
        ckpt_freq=0, max_norm=1.0))
    for step in range(3):
        batch = make_batch(jm.args, seed=step, partial=step == 1)
        want = jt.train_step(batch)
        got = pt.train_step(batch)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert_params_close(pm.params, jm.params)


@pytest.mark.parametrize("use_dora", [False, True])
def test_lora_steps_match_jax(tmp_path, use_dora):
    """LoRA/DoRA steps with clipping off (max_norm 0; the JAX step clips by
    the norm over frozen leaves too), SGD: adapters move as in JAX, the
    base weights do not move at all. (lora_b starts at zero with gradients
    near Adam's eps; SGD keeps the update linear in the gradient.)"""
    cfg = {"rank": 2, "scale": 2.0, "dropout": 0.0, "keys": ["attn"]}
    jm = jax_model(2)
    jax_lora.linear_to_lora_layers(jm, cfg, use_dora=use_dora)
    pm = torch_model_from_jax(jm)
    base = {k: v.clone() for k, v in tree_to_flat(pm.params).items()
            if not lora.trainable_filter(k)}
    jt = jax_trainer.CSMTrainer(jax_trainer.TrainArgs(
        model=jm, optimizer=OPTIMIZERS["sgd"][0](),
        output_dir=tmp_path / "jax", ckpt_freq=0, max_norm=0.0,
        trainable_filter=jax_lora.trainable_filter))
    pt = trainer.CSMTrainer(trainer.TrainArgs(
        model=pm, optimizer=OPTIMIZERS["sgd"][1](),
        output_dir=tmp_path / "port", ckpt_freq=0, max_norm=0.0,
        trainable_filter=lora.trainable_filter))
    assert {n for n, _ in pt.trainable} == {
        k for k in tree_to_flat(pm.params) if lora.trainable_filter(k)}
    for step in range(2):
        batch = make_batch(jm.args, seed=10 + step)
        np.testing.assert_allclose(pt.train_step(batch), jt.train_step(batch),
                                   rtol=1e-5)
        assert_params_close(pm.params, jm.params)
    for k, v in tree_to_flat(pm.params).items():
        if k in base:
            assert torch.equal(v, base[k]), k


def preference_batch(args, seed):
    chosen = make_batch(args, seed=seed)
    rejected = make_batch(args, seed=seed + 1, partial=True)
    batch = {f"chosen_{k}": v for k, v in chosen.items()}
    batch.update({f"rejected_{k}": v for k, v in rejected.items()})
    return batch


def test_dpo_and_kto_losses_match_jax(tmp_path):
    jm, jref = jax_model(3), jax_model(4)
    pm, pref = torch_model_from_jax(jm), torch_model_from_jax(jref)
    jdpo = jax_trainer.DPOTrainer(jax_trainer.DPOArgs(
        model=jm, optimizer=optax.sgd(LR), output_dir=tmp_path / "jd",
        ckpt_freq=0, beta=0.3))
    pdpo = trainer.DPOTrainer(trainer.DPOArgs(
        model=pm, optimizer=build_optimizer("sgd", LR),
        output_dir=tmp_path / "pd", ckpt_freq=0, beta=0.3))
    batch = preference_batch(jm.args, 30)
    want = jdpo._loss_fn(jm.params, {k: jnp.asarray(v)
                                     for k, v in batch.items()},
                         jax.random.PRNGKey(0))
    got = pdpo._loss_fn(pm.params, pdpo._prepare_batch(batch),
                        torch.Generator())
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)

    jkto = jax_trainer.KTOTrainer(jax_trainer.KTOArgs(
        model=jm, optimizer=optax.sgd(LR), output_dir=tmp_path / "jk",
        ckpt_freq=0, reference_model=jref, beta=0.7, desirable_weight=1.3))
    pkto = trainer.KTOTrainer(trainer.KTOArgs(
        model=pm, optimizer=build_optimizer("sgd", LR),
        output_dir=tmp_path / "pk", ckpt_freq=0, reference_model=pref,
        beta=0.7, desirable_weight=1.3))
    batch = make_batch(jm.args, seed=40, partial=True)
    batch["preferences"] = np.asarray([1, -1], dtype=np.int32)
    want = jkto._loss_fn(jm.params, {k: jnp.asarray(v)
                                     for k, v in batch.items()},
                         jax.random.PRNGKey(0), jref.params)
    got = pkto._loss_fn(pm.params, pkto._prepare_batch(batch),
                        torch.Generator())
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(pdpo.train_step(preference_batch(jm.args, 31)),
                               jdpo.train_step(preference_batch(jm.args, 31)),
                               rtol=1e-5)


def test_kto_with_reference_equal_to_policy_is_one_half(tmp_path):
    pm = torch_model_from_jax(jax_model(5))
    ref = torch_model_from_jax(jax_model(5))
    kto = trainer.KTOTrainer(trainer.KTOArgs(
        model=pm, optimizer=build_optimizer("sgd", LR),
        output_dir=tmp_path / "k", ckpt_freq=0, reference_model=ref,
        gradient_checkpointing=True))
    batch = make_batch(pm.args, seed=50)
    batch["preferences"] = np.asarray([1, -1], dtype=np.int32)
    assert kto.train_step(batch) == 0.5
    with pytest.raises(ValueError, match="Reference model"):
        trainer.KTOTrainer(trainer.KTOArgs(
            model=pm, optimizer=build_optimizer("sgd", LR),
            output_dir=tmp_path / "k2"))
    with pytest.raises(ValueError, match="decoder_loss_fraction"):
        trainer.DPOTrainer(trainer.DPOArgs(
            model=pm, optimizer=build_optimizer("sgd", LR),
            output_dir=tmp_path / "d2", decoder_loss_fraction=0.5))


def test_train_checkpoints_resume_and_shuffle_like_jax(tmp_path):
    """train() over 4 items, batch 2, 2 epochs, ckpt_freq 1: the same
    RandomState(1234 + epoch) batch order as the JAX trainer, the same
    parameters at the end; a new trainer on the run directory resumes the
    step, the epoch, the weights and the optimizer state bit-equal; each
    package's latest.safetensors loads in the other."""
    jm = jax_model(6)
    pm = torch_model_from_jax(jm)
    jds, pds = JaxItems(jm.args), PortItems(pm.args)
    jt = jax_trainer.CSMTrainer(jax_trainer.TrainArgs(
        model=jm, optimizer=optax.adam(LR, eps=EPS),
        output_dir=tmp_path / "jax", ckpt_freq=1, learning_rate=LR))
    out = tmp_path / "port"
    pt = trainer.CSMTrainer(trainer.TrainArgs(
        model=pm, optimizer=OPTIMIZERS["adam"][1](), output_dir=out,
        ckpt_freq=1, learning_rate=LR))
    jt.train(jds, batch_size=2, epochs=2)
    pt.train(pds, batch_size=2, epochs=2)
    assert pds.seen == jds.seen and len(pds.seen) == 4
    assert pds.seen[0] != pds.seen[2]  # epochs shuffle differently
    assert_params_close(pm.params, jm.params)
    for f in ("latest.safetensors", "optimizer_state.safetensors",
              "trainer_state.json"):
        assert (out / f).exists() and (out / "step_4" / f).exists()
    assert [r.step for r in pt.history.records] == [1, 2, 3, 4]

    pm2 = torch_model_from_jax(jax_model(7))
    pt2 = trainer.CSMTrainer(trainer.TrainArgs(
        model=pm2, optimizer=OPTIMIZERS["adam"][1](), output_dir=out,
        learning_rate=LR))
    assert (pt2.state.step, pt2.state.epoch) == (4, 2)
    assert pt2.history.state == pt.history.state
    for k, v in tree_to_flat(pm.params).items():
        assert torch.equal(tree_to_flat(pm2.params)[k], v), k
    for (n, t), (n2, t2) in zip(pt.trainable, pt2.trainable):
        assert n == n2
        for key, val in pt.optimizer.state[t].items():
            assert torch.equal(pt2.optimizer.state[t2][key], val), (n, key)
    pt2.train(pds, batch_size=2, epochs=2)  # both epochs done: no step
    assert pt2.state.step == 4

    # latest.safetensors across the packages
    jx = JaxCSM(tiny_args(), dtype=jnp.float32, rng=jax.random.PRNGKey(8))
    jx.load_weights(str(out / "latest.safetensors"))
    assert_params_close(pm.params, jx.params, rtol=0)
    pm3 = torch_model_from_jax(jax_model(9))
    pm3.load_weights(str(tmp_path / "jax" / "latest.safetensors"))
    assert_params_close(pm3.params, jm.params, rtol=0)


def test_resume_at_exact_epoch_boundary_skips_the_epoch(tmp_path):
    """A checkpoint taken at the last step of an epoch, before the epoch's
    own save, resumes as "epoch done": no batch runs again."""
    out = tmp_path / "boundary"
    pm = torch_model_from_jax(jax_model(10))
    pt = trainer.CSMTrainer(trainer.TrainArgs(
        model=pm, optimizer=build_optimizer("adam", LR), output_dir=out,
        ckpt_freq=2))
    ds = PortItems(pm.args)
    pt.train_step(ds.get_batch([0, 1]))
    pt.train_step(ds.get_batch([2, 3]))
    pt.state.step, pt.state.epoch = 2, 0
    pt.checkpointer.save()
    pt2 = trainer.CSMTrainer(trainer.TrainArgs(
        model=torch_model_from_jax(jax_model(11)),
        optimizer=build_optimizer("adam", LR), output_dir=out))
    assert (pt2.state.step, pt2.state.epoch) == (2, 0)
    ds.seen.clear()
    pt2.train(ds, batch_size=2, epochs=1, shuffle=False)
    assert (pt2.state.step, pt2.state.epoch, ds.seen) == (2, 1, [])


def test_trainer_drops_derived_params_and_refuses_jax_optimizer_state(
        tmp_path):
    """Derived "_" params (kernel 3's tables) are dropped; a run directory
    whose optimizer file holds the JAX package's optax leaves is refused,
    and trainable-only checkpoints hold the adapters alone."""
    jm = jax_model(12)
    jax_lora.linear_to_lora_layers(jm, {"rank": 2, "keys": ["attn"]})
    jt = jax_trainer.CSMTrainer(jax_trainer.TrainArgs(
        model=jm, optimizer=optax.adam(LR), output_dir=tmp_path / "jax",
        trainable_filter=jax_lora.trainable_filter,
        only_save_trainable_params=True))
    jt.train_step(make_batch(jm.args, seed=60))
    jt.checkpointer.save()
    pm = torch_model_from_jax(jm)
    pm.params["_resident"] = {"norm": torch.zeros(3)}
    with pytest.raises(ValueError, match="optax"):
        trainer.CSMTrainer(trainer.TrainArgs(
            model=pm, optimizer=build_optimizer("adam", LR),
            output_dir=tmp_path / "jax", trainable_filter=lora.trainable_filter))
    assert "_resident" not in pm.params
    pt = trainer.CSMTrainer(trainer.TrainArgs(
        model=pm, optimizer=build_optimizer("adam", LR),
        output_dir=tmp_path / "port", trainable_filter=lora.trainable_filter,
        only_save_trainable_params=True))
    pt.train_step(make_batch(pm.args, seed=61))
    pt.checkpointer.save()
    from csm_mlx_tpu_torch import safetensors_io

    saved = safetensors_io.load_file(str(tmp_path / "port" / "latest.safetensors"))
    assert saved and all(lora.trainable_filter(k) for k in saved)


def test_lora_step_clips_by_every_leaf_like_jax(tmp_path):
    """One LoRA step (rank 4) whose max_norm clips: JAX takes the clipping
    norm over every parameter's gradient, frozen ones included, so the
    adapters after the step equal JAX's only when the port does too; the
    base weights do not move."""
    cfg = {"rank": 4, "scale": 2.0, "dropout": 0.0, "keys": ["attn"]}
    jm = jax_model(13)
    jax_lora.linear_to_lora_layers(jm, cfg)
    pm = torch_model_from_jax(jm)
    base = {k: v.clone() for k, v in tree_to_flat(pm.params).items()
            if not lora.trainable_filter(k)}
    jt = jax_trainer.CSMTrainer(jax_trainer.TrainArgs(
        model=jm, optimizer=OPTIMIZERS["sgd"][0](),
        output_dir=tmp_path / "jax", ckpt_freq=0, max_norm=0.05,
        trainable_filter=jax_lora.trainable_filter))
    pt = trainer.CSMTrainer(trainer.TrainArgs(
        model=pm, optimizer=OPTIMIZERS["sgd"][1](),
        output_dir=tmp_path / "port", ckpt_freq=0, max_norm=0.05,
        trainable_filter=lora.trainable_filter))
    batch = make_batch(jm.args, seed=70)
    np.testing.assert_allclose(pt.train_step(batch), jt.train_step(batch),
                               rtol=1e-5)
    assert_params_close(pm.params, jm.params)
    for k, v in tree_to_flat(pm.params).items():
        if k in base:
            assert torch.equal(v, base[k]), k
            assert not v.requires_grad, k


def _async_run(tmp_path, name, seed, backend="orbax", epochs=1):
    pm = torch_model_from_jax(jax_model(seed))
    pt = trainer.CSMTrainer(trainer.TrainArgs(
        model=pm, optimizer=OPTIMIZERS["adam"][1](),
        output_dir=tmp_path / name, ckpt_freq=1, learning_rate=LR,
        checkpoint_backend=backend))
    pt.train(PortItems(pm.args), batch_size=2, epochs=epochs)
    return pm, pt


def test_async_checkpoints_commit_each_step_and_resume(tmp_path):
    """checkpoint_backend="orbax": train() saves each step from a
    background thread into step_N/orbax (committed by a rename) and has
    committed the last save when it returns; the weights are those of the
    synchronous backend's run; a new trainer resumes the newest committed
    step's weights, optimizer state and trainer state bit-equal."""
    pm, pt = _async_run(tmp_path, "async", 14)
    sync_pm, _ = _async_run(tmp_path, "sync", 14, backend="safetensors")
    out = tmp_path / "async"
    for step in (1, 2):
        data = out / f"step_{step}" / "orbax"
        assert (data / "latest.safetensors").exists()
        assert (data / "optimizer_state.safetensors").exists()
        assert not list((out / f"step_{step}").glob(".orbax-tmp-*"))
    assert not (out / "latest.safetensors").exists()
    assert (out / "trainer_state.json").exists()
    for k, v in tree_to_flat(pm.params).items():
        assert torch.equal(tree_to_flat(sync_pm.params)[k], v), k

    pm2 = torch_model_from_jax(jax_model(15))
    pt2 = trainer.CSMTrainer(trainer.TrainArgs(
        model=pm2, optimizer=OPTIMIZERS["adam"][1](), output_dir=out,
        checkpoint_backend="orbax"))
    assert (pt2.state.step, pt2.state.epoch) == (2, 1)
    assert pt2.history.state == pt.history.state
    for k, v in tree_to_flat(pm.params).items():
        assert torch.equal(tree_to_flat(pm2.params)[k], v), k
    for (n, t), (n2, t2) in zip(pt.trainable, pt2.trainable):
        for key, val in pt.optimizer.state[t].items():
            assert torch.equal(pt2.optimizer.state[t2][key], val), (n, key)


def test_async_resume_skips_a_step_that_never_committed(tmp_path):
    """A step directory with its trainer state but no committed tensors (a
    crash inside the write: a json and a temporary directory only) is
    skipped: resume takes the newest committed step, its own trainer
    state, though the run root's json is a step ahead."""
    pm, pt = _async_run(tmp_path, "crash", 16)
    out = tmp_path / "crash"
    ahead = {"trainer_state": {"step": 3, "epoch": 1, "learning_rate": LR},
             "history": []}
    os_dir = out / "step_3"
    (os_dir / ".orbax-tmp-1").mkdir(parents=True)
    for root in (os_dir, out):
        (root / "trainer_state.json").write_text(json.dumps(ahead))
    (out / "step_x").mkdir()
    pm2 = torch_model_from_jax(jax_model(17))
    pt2 = trainer.CSMTrainer(trainer.TrainArgs(
        model=pm2, optimizer=OPTIMIZERS["adam"][1](), output_dir=out,
        checkpoint_backend="orbax"))
    assert pt2.state.step == 2
    for k, v in tree_to_flat(pm.params).items():
        assert torch.equal(tree_to_flat(pm2.params)[k], v), k


@pytest.mark.parametrize("written,resumed,match", [
    ("orbax", "safetensors", "holds an orbax checkpoint"),
    ("safetensors", "orbax", "holds a safetensors checkpoint"),
])
def test_checkpoint_backend_mismatch_is_refused_as_jax_refuses_it(
        tmp_path, written, resumed, match):
    """A run directory of one backend is refused by a trainer of the other,
    with the JAX trainer's message (its own trainer refuses the same
    directory the same way); an unknown backend raises."""
    _async_run(tmp_path, "run", 18, backend=written)
    out = tmp_path / "run"
    with pytest.raises(ValueError, match=match) as port_err:
        trainer.CSMTrainer(trainer.TrainArgs(
            model=torch_model_from_jax(jax_model(19)),
            optimizer=OPTIMIZERS["adam"][1](), output_dir=out,
            checkpoint_backend=resumed))
    with pytest.raises(ValueError, match=match) as jax_err:
        jax_trainer.CSMTrainer(jax_trainer.TrainArgs(
            model=jax_model(19), optimizer=optax.adam(LR), output_dir=out,
            checkpoint_backend=resumed))
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        trainer.CSMTrainer(trainer.TrainArgs(
            model=torch_model_from_jax(jax_model(19)),
            optimizer=OPTIMIZERS["adam"][1](), output_dir=tmp_path / "x",
            checkpoint_backend="zarr"))
