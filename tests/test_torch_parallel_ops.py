"""The port's pipeline and ring attention (`parallel/pipeline.py`,
`parallel/sequence.py`) on CPU ranks over gloo against the JAX package's
on the conftest's virtual devices: the cases of tests/test_pipeline.py and
tests/test_ring_attention.py, one spawned world of 2 ranks and one of 4
(`torch_dist_helpers.ops_world`), each JAX result paired with the ranks'
blocks of the port's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_helpers as dh
from csm_mlx_tpu.config import LlamaConfig
from csm_mlx_tpu.models.llama import init_llama_params, llama_forward
from csm_mlx_tpu.ops.attention import (NEG_INF, causal_mask_bias,
                                       key_validity_bias, sdpa)
from csm_mlx_tpu.ops.rope import rope_cache_for
from csm_mlx_tpu.parallel import create_mesh
from csm_mlx_tpu.parallel.pipeline import (pipeline_forward,
                                           shard_pipeline_params,
                                           stack_pipeline_params)
from csm_mlx_tpu.parallel.sequence import ring_sdpa, shard_sequence
from csm_mlx_tpu_torch import bridge
from csm_mlx_tpu_torch.parallel import pipeline as tpipe
from csm_mlx_tpu_torch.parallel.mesh import map_tree

# tests/test_pipeline.py's and tests/test_ring_attention.py's tolerances
PIPE_FWD = dict(rtol=2e-4, atol=2e-5)
PIPE_DX = dict(rtol=2e-3, atol=1e-4)
PIPE_DW = dict(rtol=5e-3, atol=5e-4)
RING_FWD = dict(rtol=2e-5, atol=2e-6)
RING_GRAD = dict(rtol=5e-4, atol=1e-5)
RING_BF16 = dict(rtol=2e-2, atol=2e-2)


def _cfg(n_layers=4):
    return LlamaConfig(
        vocab_size=64, num_hidden_layers=n_layers, num_attention_heads=4,
        num_key_value_heads=2, head_dim=16, intermediate_size=128,
        hidden_size=64, max_position_embeddings=64)


def _setup(b=4, s=10, seed=0):
    cfg = _cfg()
    params = init_llama_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(seed + 1),
                          (b, s, cfg.hidden_size), jnp.float32)
    cos, sin = rope_cache_for(cfg, s)
    return cfg, params, x, cos, sin, jnp.arange(s)[None], \
        causal_mask_bias(s, s)[None, None]


def _case(cfg, params, x, cos, sin, positions, bias, **kw):
    """A pipeline case for the ranks: numpy inputs, the port's config."""
    return dict(cfg="pp", backbones={"pp": bridge.llama_config_from(cfg)},
                params=jax.device_get(params), x=np.asarray(x),
                cos=np.asarray(cos), sin=np.asarray(sin),
                positions=np.asarray(positions).astype(np.int64),
                bias=np.asarray(bias), **kw)


def _jax_pipe(n_stages, params, cfg, x, cos, sin, positions, bias, n_micro,
              layers=None, **kw):
    mesh = create_mesh({"pipe": n_stages},
                       devices=jax.devices()[:n_stages])
    stacked = shard_pipeline_params(
        stack_pipeline_params(layers or params["layers"], n_stages), mesh)
    return np.asarray(pipeline_forward(stacked, cfg, x, cos, sin, positions,
                                       bias, mesh, n_micro,
                                       norm=params["norm"], **kw))


def _pipeline_cases(n):
    """{name: (case for the ranks, what JAX gives, the check)}."""
    out = {}
    if n == 2:
        cfg, params, x, cos, sin, pos, bias = _setup(b=4, s=10)
        out["forward 2 stages 4 micro"] = (
            _case(cfg, params, x, cos, sin, pos, bias, stages=2, n_micro=4),
            _jax_pipe(2, params, cfg, x, cos, sin, pos, bias, 4))
        # left-padded rows: per-row positions and masks
        cfg, params, x, cos, sin, _, _ = _setup(b=4, s=6)
        pad = jnp.asarray([0, 2, 1, 3], jnp.int32)
        positions = jnp.arange(6)[None] - pad[:, None]
        key_valid = jnp.arange(6)[None, :] >= pad[:, None]
        bias_b = jnp.maximum(causal_mask_bias(6, 6)[None, None]
                             + key_validity_bias(key_valid)[:, None], NEG_INF)
        out["per-row positions and mask"] = (
            _case(cfg, params, x, cos, sin, positions, bias_b, stages=2,
                  n_micro=2, pad=np.asarray(pad)),
            _jax_pipe(2, params, cfg, x, cos, sin, positions, bias_b, 2))
        # the fused qkv / gate-up layout against JAX's unfused forward
        cfg, params, x, cos, sin, pos, bias = _setup(b=2, s=6)
        ref, _ = llama_forward(params, cfg, x, cos, sin, pos, bias, None)
        out["fused qkv"] = (
            _case(cfg, params, x, cos, sin, pos, bias, stages=2, n_micro=2,
                  fused=True), np.asarray(ref))
    else:
        cfg, params, x, cos, sin, pos, bias = _setup(b=8, s=10)
        out["forward 4 stages 8 micro"] = (
            _case(cfg, params, x, cos, sin, pos, bias, stages=4, n_micro=8),
            _jax_pipe(4, params, cfg, x, cos, sin, pos, bias, 8))
        cfg, params, x, cos, sin, pos, bias = _setup(b=4, s=6)
        mesh = create_mesh({"pipe": 4}, devices=jax.devices()[:4])
        stacked = shard_pipeline_params(
            stack_pipeline_params(params["layers"], 4), mesh)

        def pp_loss(xx):
            h = pipeline_forward(stacked, cfg, xx, cos, sin, pos, bias, mesh,
                                 n_micro=2, norm=params["norm"], remat=True)
            return jnp.sum(h ** 2)

        out["embeds gradient"] = (
            _case(cfg, params, x, cos, sin, pos, bias, stages=4, n_micro=2,
                  remat=True, grad="x"),
            np.asarray(jax.jit(jax.grad(pp_loss))(x)))

        def pp_w_loss(st):
            h = pipeline_forward(
                shard_pipeline_params(st, mesh), cfg, x, cos, sin, pos, bias,
                mesh, n_micro=2, norm=params["norm"], remat=True)
            return jnp.sum(h ** 2)

        out["weight gradients"] = (
            _case(cfg, params, x, cos, sin, pos, bias, stages=4, n_micro=2,
                  remat=True, grad="weights"),
            jax.device_get(jax.jit(jax.grad(pp_w_loss))(
                stack_pipeline_params(params["layers"], 4))))
    return out


def _qkv(b=2, n_heads=4, n_kv=2, s=32, d=16, seed=0, dtype=jnp.float32):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return (jax.random.normal(ks[0], (b, n_heads, s, d), dtype),
            jax.random.normal(ks[1], (b, n_kv, s, d), dtype),
            jax.random.normal(ks[2], (b, n_kv, s, d), dtype))


def _f32(*xs):
    return [np.asarray(x, dtype=np.float32) for x in xs]


def _ring_cases(n):
    mesh = create_mesh({"seq": n}, devices=jax.devices()[:n])
    out = {}
    q, k, v = _qkv()
    scale = q.shape[-1] ** -0.5
    want = ring_sdpa(shard_sequence(q, mesh), shard_sequence(k, mesh),
                     shard_sequence(v, mesh), scale, mesh)
    out["forward"] = (dict(zip("qkv", _f32(q, k, v)), scale=scale),
                      np.asarray(want))
    q, k, v = _qkv(s=16)

    def ring_loss(q, k, v):
        return jnp.sum(ring_sdpa(q, k, v, scale, mesh) ** 2)

    grads = jax.jit(jax.grad(ring_loss, argnums=(0, 1, 2)))(q, k, v)
    out["gradients"] = (dict(zip("qkv", _f32(q, k, v)), scale=scale,
                             grad=True), [np.asarray(g) for g in grads])
    q, k, v = _qkv(s=24, dtype=jnp.bfloat16)
    ref = sdpa(q, k, v, scale, causal_mask_bias(24, 24))
    out["bf16"] = (dict(zip("qkv", _f32(q, k, v)), scale=scale, bf16=True),
                   np.asarray(ref, dtype=np.float32))
    return out


def _world(n, tmp_path_factory):
    """JAX's results and the ranks' of one world size."""
    pipes, rings = _pipeline_cases(n), _ring_cases(n)
    payload = dict(pipe={k: c for k, (c, _) in pipes.items()},
                   ring={k: c for k, (c, _) in rings.items()},
                   odd_len=ODD_LEN[n])
    if n == 2:
        payload["pipe_dropout"] = _case(*_setup(b=4, s=6), n_micro=2,
                                        lora_dropout=0.3, seed=7)
    ranks = dh.run_world(n, dh.ops_world, payload,
                         tmp_path_factory.mktemp(f"ops{n}"))
    return n, pipes, rings, ranks


ODD_LEN = {2: 23, 4: 22}  # a sequence the axis does not divide


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _world(2, tmp_path_factory)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _world(4, tmp_path_factory)


@pytest.fixture(params=[2, 4], ids=lambda n: f"{n} ranks")
def world(request):
    return request.getfixturevalue(f"world{request.param}")


def _seq(ranks, name, key, i=None):
    """The ranks' blocks of a ring result, along the sequence."""
    blocks = [r["ring"][name][key] if i is None else r["ring"][name][key][i]
              for r in ranks]
    return np.concatenate(blocks, axis=2)


def test_ring_forward_matches_jax(world):
    _, _, rings, ranks = world
    np.testing.assert_allclose(_seq(ranks, "forward", "o"),
                               rings["forward"][1], **RING_FWD)


def test_ring_gradients_match_jax(world):
    """dq on its rank, dk and dv carried home around the ring."""
    _, _, rings, ranks = world
    for i, want in enumerate(rings["gradients"][1]):
        np.testing.assert_allclose(_seq(ranks, "gradients", "grads", i),
                                   want, **RING_GRAD, err_msg="qkv"[i])


def test_ring_bf16_matches_sdpa(world):
    _, _, rings, ranks = world
    assert {r["ring"]["bf16"]["dtype"] for r in ranks} == {"torch.bfloat16"}
    np.testing.assert_allclose(_seq(ranks, "bf16", "o"), rings["bf16"][1],
                               **RING_BF16)


def test_indivisible_sequence_raises_like_jax(world):
    """JAX's ring_sdpa refuses the length; the port's shard_sequence, which
    makes the ranks' blocks, refuses it with JAX's message."""
    n, _, _, ranks = world
    q, k, v = _qkv(s=ODD_LEN[n])
    with pytest.raises(ValueError) as e:
        ring_sdpa(q, k, v, 1.0, create_mesh({"seq": n},
                                            devices=jax.devices()[:n]))
    assert {r["odd_len"] for r in ranks} == {str(e.value)}


def _check_forward(ranks, pipes, name):
    """Every pipe rank holds the whole output."""
    case, want = pipes[name]
    for r in ranks:
        got = r["pipe"][name]["h"]
        if "pad" in case:  # rows behind a left pad matter past the pad
            for row, p in enumerate(case["pad"]):
                np.testing.assert_allclose(got[row, p:], want[row, p:],
                                           **PIPE_FWD)
        else:
            np.testing.assert_allclose(got, want, **PIPE_FWD)


@pytest.mark.parametrize("name", ["forward 2 stages 4 micro",
                                  "per-row positions and mask", "fused qkv"])
def test_pipeline_two_stages_match_jax(world2, name):
    _check_forward(world2[3], world2[1], name)


def test_pipeline_four_stages_eight_micro_match_jax(world4):
    _check_forward(world4[3], world4[1], "forward 4 stages 8 micro")


def test_pipeline_embeds_gradient_matches_jax(world4):
    """With remat; the gradient lands on the first stage."""
    _, pipes, _, ranks = world4
    _, want = pipes["embeds gradient"]
    np.testing.assert_allclose(ranks[0]["pipe"]["embeds gradient"]["dx"],
                               want, **PIPE_DX)
    assert all(r["pipe"]["embeds gradient"]["dx"] is None
               for r in ranks[1:])


def test_pipeline_weight_gradients_match_jax(world4):
    """Each stage's gradient of its stacked weights, against JAX's gradient
    of the whole stack at that stage."""
    _, pipes, _, ranks = world4
    _, want = pipes["weight gradients"]
    for stage, r in enumerate(ranks):
        map_tree(lambda path, g: np.testing.assert_allclose(
            g, np.asarray(_at(want, path))[stage], **PIPE_DW, err_msg=path),
            r["pipe"]["weight gradients"]["dw"])


def test_pipeline_remat_replays_lora_dropout(world2):
    """With LoRA dropout live, remat recomputes each layer with the masks
    of its forward: the output and every gradient equal the pipeline's
    without remat under the same generator (JAX replays its keys the same
    way under jax.checkpoint; the two frameworks' masks differ, so the
    reference is the port's own forward)."""
    for stage, r in enumerate(world2[3]):
        plain, remat = r["pipe_dropout"]["plain"], r["pipe_dropout"]["remat"]
        np.testing.assert_array_equal(remat["h"], plain["h"])
        if stage == 0:
            np.testing.assert_array_equal(remat["dx"], plain["dx"])
        for name, g in plain["dw"].items():
            assert np.abs(g).max() > 0, name
            np.testing.assert_array_equal(remat["dw"][name], g,
                                          err_msg=name)


def _at(tree, path):
    for key in path.split("."):
        tree = tree[int(key)] if isinstance(tree, list) else tree[key]
    return tree


def test_stack_pipeline_params_matches_jax():
    _, params, *_ = _setup()
    layers = dh.torch_tree(jax.device_get(params["layers"]))
    got = tpipe.stack_pipeline_params(layers, 2)
    want = stack_pipeline_params(params["layers"], 2)
    map_tree(lambda path, t: np.testing.assert_array_equal(
        t.numpy(), np.asarray(_at(want, path)), err_msg=path), got)
    assert tuple(got["self_attn"]["q_proj"]["weight"].shape[:2]) == (2, 2)
    with pytest.raises(ValueError):
        tpipe.stack_pipeline_params(layers, 3)
