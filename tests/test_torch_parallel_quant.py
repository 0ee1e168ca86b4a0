"""W8A8 under a mesh on the port: the serving placement of fused and
quantized linears and kernel 1's in-sharded product (the JAX package's
`_quant_linear_tp`), on CPU ranks over gloo
(`torch_dist_helpers.serve_world`) against the port's solo runs and the
JAX package's mesh runs (tests/test_sharding.py::
test_quantized_tp_generation_matches_solo_quantized,
tests/test_continuous.py::test_mesh_engine_quantized_matches_solo).

tp="in" (o_proj, down_proj): the whole row quantized once
(`w8a8_quant_rows`), each rank's int32 partial of its columns
(`w8a8_partial`), the sums all-reduced, the fix-up once (`w8a8_fixup`):
bit-equal to the solo kernel's plain version. tp="out": each rank's
channel rows through kernel 1 as they are. One world of 2 ranks on
{model: 2}: the in-sharded linear, the greedy batch, the engine ({data:
2, model: 4} is tests/test_torch_parallel_serve.py's world); and the
serving placement of W8A8 dicts on {model: 2} and {model: 4}. Tiny
config, T = 0."""

import numpy as np
import pytest
import torch

import torch_dist_helpers as dh
from conftest import TINY_BACKBONE
from csm_mlx_tpu_torch import generation as tgen
from csm_mlx_tpu_torch.ops import quant
from test_torch_parallel_serve import (N_FRAMES, _engine_case, _engine_solo,
                                       _jax_frames, _payload, _port)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    payload = _payload(meshes={"m2": {"model": 2}}, kinds={"m2": ("w8a8",)},
                       engines={"m2": [_engine_case("w8a8", 2, "w8a8")]},
                       tp_in=("m2",))
    return payload, dh.run_world(2, dh.serve_world, payload,
                                 tmp_path_factory.mktemp("quant2"))


@pytest.fixture(scope="module")
def solo():
    prompts = _payload()["prompts"]
    return tgen.generate_tokens_batch(
        _port("w8a8"), prompts, [np.ones_like(p) for p in prompts],
        N_FRAMES, temperature=0.0)[0]


def test_quantized_mesh_generation_matches_solo_and_jax(world2, solo):
    """Fused q/k/v and gate/up split at head bounds (2 kv heads over 2
    ranks in the backbone, the decoder's one kv head kept by both), o and
    down through the int32 partials: the solo quantized frames, and
    JAX's."""
    payload, ranks = world2
    want = _jax_frames({"model": 2}, payload["prompts"], w8a8=True)
    np.testing.assert_array_equal(solo, want)
    for r in ranks:
        np.testing.assert_array_equal(r["m2 w8a8"]["frames"], want)


def test_quantized_engine_on_a_mesh_matches_solo(world2):
    _, ranks = world2
    got = ranks[0]["engine m2 w8a8"]
    for (tokens, _), want in zip(got, _engine_solo(_port("w8a8"), "w8a8")):
        np.testing.assert_array_equal(tokens, want)
    assert ranks[1]["engine m2 w8a8"] is None


def test_w8a8_in_sharded_linear_is_bit_equal(world2):
    """tp="in" on {model: 2}: bit-equal to the solo kernel's plain
    version; the summed partials equal its int32 sums."""
    payload, ranks = world2
    w = torch.from_numpy(payload["tp_in_w"])
    x = torch.from_numpy(payload["tp_in_x"])
    q = quant.quantize_weight_w8(w)
    want = quant.w8a8_matvec_plain(x, **q).numpy()
    xq, _ = quant.w8a8_quant_rows_plain(x)
    want_p = quant._int_dot(xq, q["weight_q"]).numpy()
    for r in ranks:
        got = r["tp_in m2"]
        np.testing.assert_array_equal(got["y"], want)
        np.testing.assert_array_equal(got["p"], want_p)


def test_plain_pieces_compose_to_the_fused_plain_version():
    """The three plain pieces of kernel 1 (rows, partials by columns, the
    fix-up) give `w8a8_matvec_plain` bit for bit, in fp32 and bf16."""
    gen = torch.Generator().manual_seed(3)
    w = torch.randn(40, 96, generator=gen)
    q = quant.quantize_weight_w8(w)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(5, 96, generator=gen).to(dtype)
        xq, aux = quant.w8a8_quant_rows(x)
        p = sum(quant.w8a8_partial(xq, lo, q["weight_q"][:, lo:lo + 32])
                for lo in (0, 32, 64))
        assert p.dtype == torch.int32
        got = quant.w8a8_fixup(p, aux, q["scales"], q["biases"], dtype)
        assert torch.equal(got, quant.w8a8_matvec_plain(x, **q))


def test_shard_model_places_by_heads(monkeypatch):
    """The serving placement on {model: 4} and {model: 2}, without a
    world: fused q/k/v split at head bounds (the backbone's kv heads of
    each rank's GQA group where 2 kv heads do not divide 4), the decoder's
    attention whole where its 2 q heads do not divide 4, the MLP by hidden
    columns, W8A8 scales with their rows, o/down codes by columns."""
    from csm_mlx_tpu_torch.ops import tensor_parallel as tpar
    from csm_mlx_tpu_torch.parallel import mesh as pmesh

    class FakeMesh:
        mesh_dim_names = ("model",)

        def __init__(self, n, r):
            self.shape, self.r = (n,), r

        def get_group(self, _):
            return None

        def get_local_rank(self, _):
            return self.r

    whole = _port("w8a8")
    d = TINY_BACKBONE.head_dim
    for n in (2, 4):
        for r in range(n):
            model = _port("w8a8")
            monkeypatch.setattr(pmesh.dist, "get_rank",
                                lambda group=None, r=r: r)
            pmesh.shard_model(model, FakeMesh(n, r))
            assert model.tp.size == n and model.tp.rank == r
            layer = model.params["backbone"]["layers"][0]
            full = whole.params["backbone"]["layers"][0]
            lay = tpar.attn_layout(TINY_BACKBONE, model.tp)
            qkv = full["self_attn"]["qkv_proj"]
            h = TINY_BACKBONE.num_attention_heads
            hkv = TINY_BACKBONE.num_key_value_heads
            q = qkv["weight_q"][:h * d]
            k = qkv["weight_q"][h * d:(h + hkv) * d]
            want = torch.cat([
                q[lay.q_lo * d:(lay.q_lo + lay.heads) * d],
                k[lay.kv_lo * d:(lay.kv_lo + lay.kv_heads) * d]])
            got = layer["self_attn"]["qkv_proj"]
            assert torch.equal(got["weight_q"][:want.shape[0]], want)
            assert got["scales"].shape[0] == got["weight_q"].shape[0] == \
                (lay.heads + 2 * lay.kv_heads) * d
            assert lay.kv_heads == 1
            o = layer["self_attn"]["o_proj"]
            assert torch.equal(o["weight_q"], full["self_attn"]["o_proj"][
                "weight_q"][:, r * h * d // n:(r + 1) * h * d // n])
            assert torch.equal(o["scales"],
                               full["self_attn"]["o_proj"]["scales"])
            f = TINY_BACKBONE.intermediate_size
            gu = layer["mlp"]["gateup_proj"]["weight_q"]
            fgu = full["mlp"]["gateup_proj"]["weight_q"]
            assert torch.equal(gu, torch.cat([
                fgu[r * f // n:(r + 1) * f // n],
                fgu[f + r * f // n:f + (r + 1) * f // n]]))
            dec = model.params["decoder"]["layers"][0]["self_attn"]
            fdec = whole.params["decoder"]["layers"][0]["self_attn"]
            same = torch.equal(dec["qkv_proj"]["weight_q"],
                               fdec["qkv_proj"]["weight_q"])
            assert same == (n == 4)  # 2 q heads do not divide 4
