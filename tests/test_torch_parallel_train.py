"""The port's trainers under a mesh on CPU ranks over gloo
(`torch_dist_helpers.train_world`), against the JAX package's trainers on
a `{"data": n}` mesh of the conftest's virtual devices: data-parallel
Adam steps at 2 and 4 ranks (a full and a ragged batch of 3 rows), FSDP
against replicated with the stored shards' sizes, the KTO reference
sharded too, DPO, `decoder_loss_fraction` 0.5 at 2 ranks against 1, and a
checkpoint written by 2 FSDP ranks resumed by one trainer. Tiny config,
fp32, dropout 0; each world is spawned once."""

import jax
import numpy as np
import optax
import pytest

import csm_mlx_tpu.parallel.mesh as jmesh
import torch_dist_helpers as dh
from conftest import TINY_BACKBONE, TINY_DECODER
from csm_mlx_tpu.finetune import trainer as jax_trainer
from csm_mlx_tpu.parallel import create_mesh
from csm_mlx_tpu_torch import bridge
from csm_mlx_tpu_torch.finetune import trainer
from csm_mlx_tpu_torch.loaders import tree_to_flat
from test_torch_loss import make_batch
from test_torch_trainer import EPS, LR, assert_params_close, jax_model

LOSS_RTOL = 2e-5
FSDP_MIN_BYTES = 1024  # every tiny weight matrix shards (JAX test's 1024)


def _batches(args):
    full = make_batch(args, b=4, s=7, seed=11, partial=True)
    ragged = {k: v[:3] for k, v in make_batch(args, b=4, s=7,
                                              seed=12).items()}
    return [full, ragged]


def _payload(jm, ref, tmp, n):
    args = jm.args
    kto = dict(make_batch(args, b=4, s=7, seed=13),
               preferences=np.asarray([1, -1, -1, 1], np.int32))
    dpo = {f"{side}_{k}": v for side, seed in (("chosen", 14),
                                               ("rejected", 15))
           for k, v in make_batch(args, b=4, s=7, seed=seed).items()}
    return dict(
        backbones={"tiny": bridge.llama_config_from(TINY_BACKBONE)},
        decoders={"tiny": bridge.llama_config_from(TINY_DECODER)},
        model_args=(args.backbone_name, args.decoder_name, args.n_text_vocab,
                    args.n_audio_vocab, args.n_audio_codebooks),
        params=jax.device_get(jm.params), ref_params=jax.device_get(ref.params),
        lr=LR, eps=EPS, batches=_batches(args), kto_batches=[kto],
        dpo_batches=[dpo], fsdp_min_bytes=FSDP_MIN_BYTES, tmp=str(tmp),
        ckpt_dir=str(tmp / "ckpt"), more=n == 2)


def _jax_run(n, kind, steps, tmp, seed=1, ref_seed=2, **kw):
    """JAX's trainer on a {"data": n} mesh: the losses and the model."""
    jm = jax_model(seed)
    mesh = create_mesh({"data": n}, devices=jax.devices()[:n])
    common = dict(model=jm, optimizer=optax.adam(LR, eps=EPS),
                  output_dir=tmp / f"jax-{kind}-{n}", ckpt_freq=0,
                  max_norm=1.0, mesh=mesh, **kw)
    if kind == "kto":
        tr = jax_trainer.KTOTrainer(jax_trainer.KTOArgs(
            reference_model=jax_model(ref_seed), **common))
    elif kind == "dpo":
        tr = jax_trainer.DPOTrainer(jax_trainer.DPOArgs(**common))
    else:
        tr = jax_trainer.CSMTrainer(jax_trainer.TrainArgs(**common))
    return [tr.train_step(b) for b in steps], jm


def _world(n, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"train{n}")
    payload = _payload(jax_model(1), jax_model(2), tmp, n)
    return n, payload, dh.run_world(n, dh.train_world, payload, tmp), tmp


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """2 ranks: every case."""
    return _world(2, tmp_path_factory)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """4 ranks: the data-parallel steps."""
    return _world(4, tmp_path_factory)


@pytest.fixture(params=[2, 4], ids=lambda n: f"{n} ranks")
def world(request):
    return request.getfixturevalue(f"world{request.param}")


def test_data_parallel_steps_match_jax(world):
    """Two Adam steps, the second on a ragged batch of 3 rows (padded by
    cycling rows on both sides): every rank's losses and parameters equal
    JAX's data-parallel run."""
    n, payload, ranks, tmp = world
    want, jm = _jax_run(n, "sft", payload["batches"], tmp)
    for r in ranks:
        np.testing.assert_allclose(r["dp"]["losses"], want, rtol=LOSS_RTOL)
        assert_params_close(dh.torch_tree(r["dp"]["params"]), jm.params)


def test_fsdp_matches_replicated_with_sharded_storage(world2, monkeypatch):
    """FSDP's losses and parameters equal replicated DP's; parameters and
    Adam moments are stored as 1/n shards by JAX's shape rule."""
    _, payload, ranks, _ = world2
    monkeypatch.setattr(jmesh, "_FSDP_MIN_BYTES", FSDP_MIN_BYTES)
    mesh = create_mesh({"data": 2}, devices=jax.devices()[:2])
    full = tree_to_flat(dh.torch_tree(payload["params"]))
    sharded = 0
    for r in ranks:
        np.testing.assert_allclose(r["fsdp"]["losses"], r["dp"]["losses"],
                                   rtol=LOSS_RTOL)
        assert_params_close(dh.torch_tree(r["fsdp"]["params"]),
                            dh.torch_tree(r["dp"]["params"]))
        for name, (shape, moment) in r["fsdp"]["stored"].items():
            spec = tuple(jmesh.fsdp_leaf_spec(
                np.zeros(full[name].shape, np.float32), mesh))
            assert r["fsdp"]["specs"][name] == spec, name
            assert moment == shape, name
            if "data" in spec:
                sharded += 1
                assert np.prod(shape) * 2 == full[name].numel(), name
            else:
                assert shape == tuple(full[name].shape), name
    assert sharded > 20


def test_kto_reference_is_sharded_and_loss_matches_jax(world2, monkeypatch,
                                                       tmp_path):
    _, payload, ranks, _ = world2
    monkeypatch.setattr(jmesh, "_FSDP_MIN_BYTES", FSDP_MIN_BYTES)
    want, _ = _jax_run(2, "kto", payload["kto_batches"], tmp_path,
                       param_sharding="fsdp")
    full = tree_to_flat(dh.torch_tree(payload["ref_params"]))
    for r in ranks:
        np.testing.assert_allclose(r["kto"]["losses"], want, rtol=LOSS_RTOL)
        gate = r["kto"]["ref_shapes"][
            "backbone.layers.0.mlp.gate_proj.weight"]
        assert np.prod(gate) * 2 == full[
            "backbone.layers.0.mlp.gate_proj.weight"].numel()


def test_dpo_loss_matches_jax(world2, tmp_path):
    _, payload, ranks, _ = world2
    want, _ = _jax_run(2, "dpo", payload["dpo_batches"], tmp_path)
    for r in ranks:
        np.testing.assert_allclose(r["dpo"]["losses"], want, rtol=LOSS_RTOL)


def _port_run(payload, out_dir, **kw):
    model = dh.port_model(payload)
    tr = trainer.CSMTrainer(trainer.TrainArgs(
        model=model, optimizer=dh.adam(LR, EPS), output_dir=out_dir,
        ckpt_freq=0, max_norm=1.0, **kw))
    return [tr.train_step(b) for b in payload["batches"]], model


def test_decoder_loss_fraction_two_ranks_match_one(world2, tmp_path):
    """The decoder's rows are drawn over the global rows from one
    generator state: 2 ranks give the 1-rank trainer's steps (the ragged
    batch padded as the ranks pad it)."""
    _, payload, ranks, _ = world2
    batches = payload["batches"]
    padded = dict(payload, batches=[batches[0], {
        k: v[[0, 1, 2, 0]] for k, v in batches[1].items()}])
    want, model = _port_run(padded, tmp_path, decoder_loss_fraction=0.5)
    for r in ranks:
        np.testing.assert_allclose(r["dlf"]["losses"], want, rtol=LOSS_RTOL)
        assert_params_close(dh.torch_tree(r["dlf"]["params"]),
                            dh.numpy_tree(model.params))


@pytest.mark.parametrize("backend,files", [
    ("safetensors", ["latest.safetensors", "optimizer_state.safetensors",
                     "step_2", "trainer_state.json"]),
    ("orbax", ["step_2", "trainer_state.json"]),
])
def test_fsdp_checkpoint_resumes_in_one_rank(world2, backend, files):
    """Rank 0 wrote whole tensors (the asynchronous backend too); a trainer
    without a mesh resumes the step, the parameters and the Adam state
    bit-equal to the 2 ranks'."""
    _, payload, ranks, _ = world2
    saved = ranks[1][f"ckpt {backend}"]
    model = dh.port_model(payload)
    tr = trainer.CSMTrainer(trainer.TrainArgs(
        model=model, optimizer=dh.adam(LR, EPS),
        output_dir=f"{payload['ckpt_dir']}/{backend}", ckpt_freq=0,
        checkpoint_backend=backend))
    assert tr.state.step == 2
    assert ranks[0][f"ckpt {backend}"]["files"] == files
    got = tree_to_flat(model.params)
    for name, want in tree_to_flat(saved["params"]).items():
        np.testing.assert_array_equal(got[name].detach().numpy(), want,
                                      err_msg=name)
    opt = {k: v.numpy() for k, v in tr.checkpointer._opt_flat().items()}
    assert set(opt) == set(saved["opt"])
    for key, want in saved["opt"].items():
        np.testing.assert_array_equal(opt[key], want, err_msg=key)


@pytest.mark.parametrize("shape,mode,match", [
    ({"data": 1, "model": 2}, "replicated", "'data' axis"),
    ({"model": 1}, "fsdp", "'data' axis"),
    ({"data": 2}, "zero2", "param_sharding"),
])
def test_train_args_refuse_other_axes_and_modes(shape, mode, match):
    """Only the "data" axis may exceed 1, and param_sharding is one of
    JAX's two modes (checked before anything runs)."""
    with pytest.raises(ValueError, match=match):
        trainer._DataAxis(_FakeMesh(shape), mode)


class _FakeMesh:
    """The two attributes `axis_sizes` reads."""

    def __init__(self, shape):
        self.mesh_dim_names, self.shape = tuple(shape), tuple(shape.values())
