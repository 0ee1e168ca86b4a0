"""The port's meshes and placement rules (`parallel/mesh.py`) against the
JAX package's (tests/test_sharding.py's cases): `create_mesh`'s shapes and
errors, the CSM tensor-parallel specs, rank r's `shard_params` shard equal
to JAX's shard on device r of a {data: 2, model: 4} mesh, the
indivisible-vocab and data-only-mesh fallbacks, the FSDP specs and shards,
`shard_batch`, `shard_model`, and the 2-D pipe x data pipeline. One world
of 8 CPU ranks over gloo (`torch_dist_helpers.mesh_world`) against the
conftest's 8 virtual devices."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import csm_mlx_tpu.parallel.mesh as jmesh
import torch_dist_helpers as dh
from conftest import tiny_args
from csm_mlx_tpu.models.csm import CSM
from csm_mlx_tpu.parallel import (create_mesh, csm_param_spec,
                                  data_parallel_spec, fsdp_param_spec,
                                  shard_batch, shard_params, shard_params_fsdp)
from csm_mlx_tpu_torch.parallel import create_mesh as port_create_mesh
from csm_mlx_tpu_torch.parallel.mesh import P, map_tree
from test_torch_parallel_ops import _case, _setup

N = 8
FSDP_MIN_BYTES = 1024


def _model(seed, **kw):
    args = dataclasses.replace(tiny_args(), **kw)
    return CSM(args, dtype=jnp.float32, rng=jax.random.PRNGKey(seed))


def _device_shards(tree):
    """{path: [the block on device r for r in 0..7]} of placed arrays."""
    devices = jax.devices()
    out = {}

    def one(path, x):
        by = {s.device: np.asarray(s.data) for s in x.addressable_shards}
        out[path] = [by[d] for d in devices[:N]]

    map_tree(one, tree)
    return out


def _specs(tree):
    flat = {}
    map_tree(lambda path, s: flat.__setitem__(path, tuple(s)), tree)
    return flat


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX's placements and the 8 ranks' results."""
    params = _model(0).params
    odd = _model(5, n_audio_vocab=51).params  # divides no model axis
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(0, 60, (16, 6, 9)).astype(np.int32),
             "masks": np.ones((16, 6, 9), np.int32)}
    cfg, pparams, x, cos, sin, pos, bias = _setup(b=8, s=6)
    m24 = create_mesh({"data": 2, "model": 4})
    m8 = create_mesh({"data": N})
    jmesh_pp = create_mesh({"pipe": 2, "data": 4})
    from csm_mlx_tpu.parallel.pipeline import (pipeline_forward,
                                               shard_pipeline_params,
                                               stack_pipeline_params)

    jax_out = dict(
        tp=_device_shards(shard_params(params, m24, tensor_parallel=True)),
        tp_specs=_specs(csm_param_spec(params)),
        dataonly=_device_shards(shard_params(params, m8)),
        odd=_device_shards(shard_params(odd, m24)),
        batch=_device_shards(shard_batch(batch, m8)),
        batch_specs=_specs(data_parallel_spec(batch)),
        pp_dp=np.asarray(pipeline_forward(
            shard_pipeline_params(stack_pipeline_params(pparams["layers"], 2),
                                  jmesh_pp), cfg, x, cos, sin, pos, bias,
            jmesh_pp, n_micro=2, norm=pparams["norm"], data_axis="data")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmesh, "_FSDP_MIN_BYTES", FSDP_MIN_BYTES)
        jax_out["fsdp_specs"] = _specs(fsdp_param_spec(params, m8))
        jax_out["fsdp"] = _device_shards(shard_params_fsdp(params, m8))
    try:
        create_mesh({"data": 3})
    except ValueError as e:
        jax_out["bad_shape"] = str(e)
    payload = dict(params=jax.device_get(params), odd_params=jax.device_get(odd),
                   batch=batch, fsdp_min_bytes=FSDP_MIN_BYTES,
                   pp_dp=_case(cfg, pparams, x, cos, sin, pos, bias,
                               n_micro=2, data_axis="data"))
    ranks = dh.run_world(N, dh.mesh_world, payload,
                         tmp_path_factory.mktemp("mesh"))
    return jax_out, ranks


def _check_shards(ranks, key, want):
    for r, got in enumerate(ranks):
        map_tree(lambda path, g: np.testing.assert_array_equal(
            g, want[path][r], err_msg=f"rank {r} {path}"), got[key])


def test_create_mesh_shapes_and_errors(world):
    jax_out, ranks = world
    for r in ranks:
        assert r["shapes"] == [{"data": 2, "model": 4}, {"data": N},
                               {"pipe": 2, "data": 4}]
        assert r["bad_shape"] == jax_out["bad_shape"]


def test_create_mesh_refuses_without_a_gpu(monkeypatch):
    """No fallback: the card is the default, and without a visible GPU
    the CPU has to be asked for (a device list means nothing to a rank)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='devices="cpu"'):
        port_create_mesh()
    with pytest.raises(ValueError, match="its own device"):
        port_create_mesh(devices=jax.devices())


def test_param_spec_rules_match_jax(world):
    jax_out, ranks = world
    assert ranks[0]["tp_specs"] == jax_out["tp_specs"]
    specs = ranks[0]["tp_specs"]
    assert specs["backbone.layers.0.self_attn.q_proj.weight"] == \
        ("model", None)
    assert specs["backbone.layers.0.self_attn.o_proj.weight"] == \
        (None, "model")
    assert specs["backbone.layers.0.input_layernorm.weight"] == ()
    assert P("model", None) == ("model", None) and repr(P()) == "P()"


def test_shard_params_rank_shards_match_jax_devices(world):
    """Rank r keeps exactly the block JAX places on device r."""
    jax_out, ranks = world
    _check_shards(ranks, "tp", jax_out["tp"])
    q = ranks[5]["tp"]["backbone"]["layers"][0]["self_attn"]["q_proj"]
    assert q["weight"].shape == (64 // 4, 64)


def test_indivisible_vocab_replicates(world):
    """n_audio_vocab 51 divides no model axis: codebook0_head stays whole
    on every rank, q_proj still shards."""
    jax_out, ranks = world
    _check_shards(ranks, "odd", jax_out["odd"])
    for r in ranks:
        assert r["odd"]["codebook0_head"]["weight"].shape[0] == 51
        assert r["odd"]["backbone"]["layers"][0]["self_attn"]["q_proj"][
            "weight"].shape[0] == 64 // 4


def test_tp_spec_on_dataonly_mesh_replicates(world):
    jax_out, ranks = world
    _check_shards(ranks, "dataonly", jax_out["dataonly"])
    full = jax_out["dataonly"]["backbone.layers.0.self_attn.q_proj.weight"]
    assert all(s.shape == full[0].shape for s in full)


def test_fsdp_specs_and_shards_match_jax(world):
    jax_out, ranks = world
    assert ranks[0]["fsdp_specs"] == jax_out["fsdp_specs"]
    _check_shards(ranks, "fsdp", jax_out["fsdp"])
    assert sum("data" in s for s in jax_out["fsdp_specs"].values()) > 20


def test_shard_batch_and_spec_match_jax(world):
    jax_out, ranks = world
    _check_shards(ranks, "batch", jax_out["batch"])
    _check_shards(ranks, "batch_np", jax_out["batch"])
    assert ranks[0]["batch_specs"] == jax_out["batch_specs"] == \
        {"tokens": ("data",), "masks": ("data",)}


def test_shard_model_drops_derived_tables(world):
    _, ranks = world
    keys = ranks[0]["model_keys"]
    assert "_resident" not in keys and "backbone" in keys


def test_pipeline_2d_pipe_x_data_matches_jax(world):
    """{pipe: 2, data: 4}: rank r at (pipe r // 4, data r % 4) holds its
    data coordinate's rows of each microbatch."""
    jax_out, ranks = world
    want = jax_out["pp_dp"]
    mb, step = 4, 1
    for r, got in enumerate(ranks):
        d = r % 4
        rows = [m * mb + d * step for m in range(2)]
        np.testing.assert_allclose(got["pp_dp"]["h"], want[rows],
                                   rtol=2e-4, atol=2e-5)


def test_pipeline_microbatch_indivisible_over_data_raises(world):
    """JAX's case: a microbatch of 4 rows over data=8."""
    _, ranks = world
    for r in ranks:
        assert r["pp_bad"] == "microbatch 4 not divisible over data=8"
