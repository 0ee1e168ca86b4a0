"""Sharded serving on the port (`parallel.shard_model` + `mesh=`): CPU
ranks over gloo (`torch_dist_helpers.serve_world`) against the port's
solo runs and the JAX package's mesh runs on the conftest's virtual
devices (tests/test_sharding.py:41-154, tests/test_continuous.py:559-720,
tests/test_cli.py:83-100).

One world of 8 ranks on {data: 2, model: 4}: greedy `generate_tokens_batch`
fp32 and W8A8 (the backbone's 2 kv heads do not divide the axis, the
decoder's 2 q heads do not either), a B = 1 prompt, the engine's streams
with 4 slots and W8A8. One world of 2 ranks on {model: 2} and {data: 2}:
the same batch at fp32 and (model only) bf16, the vocabulary-sharded
embeddings and heads, a sampled run's ranks checked to draw alike, a gloo
mesh refused under capture, a follower's submit refused, the engine with 3 slots (indivisible: replicated) and
with the int8 codec, both TTS servers, and `serve --mesh model=2` answering a request.
The W8A8 cases on {model: 2} are tests/test_torch_parallel_quant.py's.
Tiny config, T = 0; each world is spawned once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_helpers as dh
from conftest import TINY_BACKBONE, TINY_DECODER, tiny_args
from csm_mlx_tpu.cli.serve import parse_mesh_argument as jparse
from csm_mlx_tpu.generation import generate_tokens_batch as jbatch
from csm_mlx_tpu.models import csm as jcsm
from csm_mlx_tpu.ops.quant import quantize_model as jquantize
from csm_mlx_tpu.parallel import create_mesh as jcreate_mesh
from csm_mlx_tpu.parallel import shard_model as jshard_model
from csm_mlx_tpu_torch import bridge
from csm_mlx_tpu_torch import generation as tgen
from csm_mlx_tpu_torch import tokenizers as ttok
from csm_mlx_tpu_torch.cli.serve import parse_mesh_argument
from csm_mlx_tpu_torch.continuous import ContinuousEngine
from csm_mlx_tpu_torch.models.csm import codebook0_logits, masked_input_embeds
from csm_mlx_tpu_torch.models.mimi import Mimi as TMimi
from csm_mlx_tpu_torch.ops import quant
from csm_mlx_tpu_torch.ops.quant import audio_head_logits, quantize_model
from csm_mlx_tpu_torch.serve import ContinuousTTSServer, TTSServer, wav_bytes
from test_torch_context import CODEC, N_CB
from torch_helpers import torch_model_from_jax

N_FRAMES = 4
TEXTS = ["hello there", "a b", "third one"]
# JAX's bound for the int8 codec's audio across placements
# (tests/test_continuous.py::test_mesh_engine_composes_with_quantized_codec)
CODEC_AUDIO_REL = 0.06
# waveforms of equal frames decoded in batches of other rows: fp32 sums in
# another order, and the continuous server moves PCM16, where a sample at
# a rounding edge then lands one step (1 / 32767) away; a differing frame
# moves samples by ~1e-1
SERVER_AUDIO_ATOL = 1.5 / 32767
# the engines' requests: (prompt rows, seed, max_frames)
ENGINE_REQS = {"dp4": [(4, 70, 6), (5, 71, 9), (6, 72, 4)],
               "odd": [(5, 80, 5)],
               "w8a8": [(4, 90, 6), (5, 91, 4)],
               "codec": [(4, 60, 5), (5, 61, 4), (6, 62, 6), (7, 63, 3)]}


def _jax_model():
    jm = jcsm.CSM(tiny_args(n_codebooks=N_CB), dtype=jnp.float32,
                  rng=jax.random.PRNGKey(0))
    jm.params["audio_head"] = jax.random.normal(
        jax.random.PRNGKey(1), jm.params["audio_head"].shape) * 0.5
    return jm


def _prompt(k, rows, seed):
    return np.random.RandomState(seed).randint(0, 60, (rows, k)).astype(
        np.int32)


def _port(kind="f32"):
    if kind == "bf16":
        model = torch_model_from_jax(_jax_model(), dtype=torch.bfloat16)
        model.params = dh.torch_tree(dh.numpy_tree(model.params),
                                     torch.bfloat16)
        return model
    model = torch_model_from_jax(_jax_model())
    if kind == "w8a8":
        quantize_model(model, mode="w8a8", min_size=1)
    return model


def _jax_frames(shape, prompts, w8a8=False):
    jm = _jax_model()
    if w8a8:
        jquantize(jm, mode="w8a8", min_size=1)
    n = int(np.prod(list(shape.values())))
    mesh = jcreate_mesh(shape, devices=jax.devices()[:n])
    jshard_model(jm, mesh)
    frames, _ = jbatch(jm, prompts, [np.ones_like(p) for p in prompts],
                       N_FRAMES, temperature=0.0, mesh=mesh)
    return frames


def _codec():
    return TMimi(bridge.mimi_config_from(CODEC), device="cpu",
                 generator=torch.Generator().manual_seed(63))


@pytest.fixture(scope="module")
def singletons():
    """The fake text tokenizer and the tiny codec in this process, as the
    ranks install them."""
    saved = (ttok.get_text_tokenizer, dict(ttok._MIMI_CACHE))
    ttok._MIMI_CACHE[(N_CB, "cpu")] = (None, _codec())
    fake = dh.FakeTokenizer()
    ttok.get_text_tokenizer = lambda path=None: fake
    yield
    ttok.get_text_tokenizer = saved[0]
    ttok._MIMI_CACHE.clear()
    ttok._MIMI_CACHE.update(saved[1])


def _payload(**kw):
    jm = _jax_model()
    a = jm.args
    k = a.n_audio_codebooks + 1
    rng = np.random.RandomState(5)
    d_b = TINY_BACKBONE.hidden_size
    d_d = TINY_DECODER.hidden_size
    return dict(
        backbones={"tiny": bridge.llama_config_from(TINY_BACKBONE)},
        decoders={"tiny": bridge.llama_config_from(TINY_DECODER)},
        model_args=(a.backbone_name, a.decoder_name, a.n_text_vocab,
                    a.n_audio_vocab, a.n_audio_codebooks),
        params=jax.device_get(jm.params), codec=bridge.mimi_config_from(CODEC),
        codec_seed=63, n_cb=N_CB, n_frames=N_FRAMES, texts=TEXTS,
        prompts=[_prompt(k, 10, s) for s in range(4)],
        tokens=rng.randint(0, 60, (2, 3, k)).astype(np.int32),
        hidden=rng.standard_normal((3, d_b)).astype(np.float32),
        hidden_d=rng.standard_normal((3, d_d)).astype(np.float32),
        tp_in_w=rng.standard_normal((48, 128)).astype(np.float32),
        tp_in_x=rng.standard_normal((3, 128)).astype(np.float32),
        **dict(dict(engines={}, kinds={}), **kw))


def _requests(name, k):
    return [(_prompt(k, rows, seed), mf) for rows, seed, mf in
            ENGINE_REQS[name]]


def _engine_case(label, n_slots, kind="f32", **kw):
    return dict(label=label, n_slots=n_slots, kind=kind,
                requests=_requests(label, N_CB + 1), **kw)


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    payload = _payload(
        meshes={"dm": {"data": 2, "model": 4}},
        kinds={"dm": ("f32", "w8a8")},
        engines={"dm": [_engine_case("dp4", 4),
                        _engine_case("w8a8", 2, "w8a8")]})
    return payload, dh.run_world(8, dh.serve_world, payload,
                                 tmp_path_factory.mktemp("serve8"))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    payload = _payload(
        meshes={"m2": {"model": 2}, "d2": {"data": 2}},
        kinds={"m2": ("f32", "bf16"), "d2": ("f32",)},
        engines={"d2": [_engine_case("odd", 3),
                        _engine_case("codec", 4, codec=True,
                                     quantize_codec=True)]},
        tables=("m2",), capture=("m2",), follower=("m2",), sampled=("m2",),
        servers=("m2",), cli={"m2": "model=2"})
    return payload, dh.run_world(2, dh.serve_world, payload,
                                 tmp_path_factory.mktemp("serve2"))


@pytest.fixture(scope="module")
def solo():
    """The port's solo batch frames per kind."""
    prompts = _payload()["prompts"]
    masks = [np.ones_like(p) for p in prompts]
    out = {}
    for kind in ("f32", "w8a8", "bf16"):
        out[kind] = tgen.generate_tokens_batch(_port(kind), prompts, masks,
                                               N_FRAMES, temperature=0.0)[0]
    p = prompts[0]
    out["single"] = tgen.generate_tokens(_port(), p, np.ones_like(p), 3,
                                         temperature=0.0)[0]
    return out


@pytest.mark.parametrize("kind", ["f32", "w8a8"])
def test_tp_dp_generation_matches_solo_and_jax(world8, solo, kind):
    """{data: 2, model: 4}: every rank returns the whole batch, equal to
    the port's solo frames and JAX's mesh frames (JAX's cases; W8A8 with
    fused q/k/v and gate/up, o and down through kernel 1's int32
    partials)."""
    payload, ranks = world8
    want = _jax_frames({"data": 2, "model": 4}, payload["prompts"],
                       w8a8=kind == "w8a8")
    np.testing.assert_array_equal(solo[kind], want)
    for r in ranks:
        np.testing.assert_array_equal(r[f"dm {kind}"]["frames"], want)
    assert (ranks[0][f"dm {kind}"]["n"] == N_FRAMES).all()


def test_single_prompt_on_a_data_mesh(world8, world2, solo):
    """B = 1 on data > 1 replicates the row (tensor parallelism still
    applies), as JAX's `_place_inputs`."""
    for ranks, key in ((world8[1], "dm f32"), (world2[1], "d2 f32"),
                       (world2[1], "m2 f32")):
        for r in ranks:
            np.testing.assert_array_equal(r[key]["single"], solo["single"])


@pytest.mark.parametrize("mesh", ["m2", "d2"])
def test_model_and_data_meshes_match_solo_and_jax(world2, solo, mesh):
    payload, ranks = world2
    want = _jax_frames(payload["meshes"][mesh], payload["prompts"])
    np.testing.assert_array_equal(solo["f32"], want)
    for r in ranks:
        np.testing.assert_array_equal(r[f"{mesh} f32"]["frames"], want)


def test_bf16_model_mesh_matches_solo(world2, solo):
    """bf16 weights on {model: 2}: the in-sharded products sum in fp32 and
    round once, as the solo matmul does."""
    _, ranks = world2
    for r in ranks:
        np.testing.assert_array_equal(r["m2 bf16"]["frames"], solo["bf16"])


def test_vocab_sharded_tables_equal_solo(world2):
    """{model: 2}: each rank holds half of every vocabulary (64 and 256
    rows divide 2); the masked lookups and the gathered logits equal the
    whole tables' exactly."""
    payload, ranks = world2
    model = _port()
    args = model.args
    tokens = torch.from_numpy(payload["tokens"]).long()
    hidden = torch.from_numpy(payload["hidden"])
    want = dict(
        embeds=masked_input_embeds(model.params, args, tokens,
                                   torch.ones_like(tokens)).numpy(),
        c0=codebook0_logits(model.params, args, hidden).numpy(),
        head=audio_head_logits(model.params["audio_head"], 2,
                               torch.from_numpy(payload["hidden_d"]),
                               args.n_audio_vocab).numpy())
    for r in ranks:
        got = r["tables m2"]
        assert got["local_rows"] == args.n_text_vocab // 2
        for key, w in want.items():
            np.testing.assert_array_equal(got[key], w, err_msg=key)


def test_mesh_refusals(world2):
    """A gloo mesh refuses CUDA-graph capture and names eager=True; a
    follower rank's engine takes no requests."""
    _, ranks = world2
    for r in ranks:
        assert "eager=True" in r["m2 f32"]["capture"]
    assert "rank 1" in ranks[1]["follower submit"]
    assert "follower submit" not in ranks[0]


def test_sampled_mesh_run_checks_its_ranks_draw_alike(world2):
    """T = 0.8 on {model: 2}: with one generator seed the ranks' frames
    agree (each rank checks every frame); with a seed a rank, every rank
    raises rather than leave the loop apart."""
    _, ranks = world2
    same = [r["sampled m2"]["same"] for r in ranks]
    assert all(isinstance(f, np.ndarray) and f.shape[0] > 0 for f in same)
    np.testing.assert_array_equal(same[0], same[1])
    for r in ranks:
        assert "same seed" in r["sampled m2"]["apart"]


def _engine_solo(model, label):
    return [np.asarray(tgen.generate_tokens(model, p, np.ones_like(p), mf,
                                            temperature=0.0)[0])
            for p, mf in _requests(label, N_CB + 1)]


@pytest.mark.parametrize("world,mesh,label,kind", [
    ("world8", "dm", "dp4", "f32"), ("world8", "dm", "w8a8", "w8a8"),
    ("world2", "d2", "odd", "f32")])
def test_engine_on_a_mesh_matches_solo(request, world, mesh, label, kind):
    """ContinuousEngine(mesh=): slots over "data" (4 slots; 3 on {data: 2}
    replicate), the model over "model"; rank 0's streams equal the solo
    runs, as JAX's cases."""
    _, ranks = request.getfixturevalue(world)
    got = ranks[0][f"engine {mesh} {label}"]
    for (tokens, _), want in zip(got, _engine_solo(_port(kind), label)):
        np.testing.assert_array_equal(tokens, want)
    assert all(r[f"engine {mesh} {label}"] is None for r in ranks[1:])


def test_engine_with_int8_codec_on_data_mesh(world2, singletons):
    """{data: 2}, quantize_codec=True, 4 slots (2 a rank), 4 requests: the
    tokens equal the solo engine's; the audio is within the int8 codec's
    noise of it (JAX's gate), its chunks decoded on each rank's rows."""
    _, ranks = world2
    model = _port()
    eng = ContinuousEngine(model, n_slots=4, max_frames=12,
                           max_prompt_bucket=32, capacity_slack=16,
                           frames_per_step=3, codec=True,
                           quantize_codec=True,
                           generator=torch.Generator().manual_seed(7))
    handles = [eng.submit_prompt(p, np.ones_like(p), max_frames=mf)
               for p, mf in _requests("codec", N_CB + 1)]
    eng.run_until_idle()
    got = ranks[0]["engine d2 codec"]
    for h, (tokens, audio) in zip(handles, got):
        np.testing.assert_array_equal(tokens, h.wait(0))
        want = h.audio()
        assert audio.shape == want.shape and audio.size
        rel = float(np.sqrt(np.mean((audio - want) ** 2))
                    / (np.sqrt(np.mean(want ** 2)) + 1e-12))
        assert rel < CODEC_AUDIO_REL, rel


def test_servers_on_a_mesh_match_solo(world2, singletons):
    """TTSServer and ContinuousTTSServer on {model: 2}: rank 0 serves
    (rank 1 follows), the waveforms of the solo servers' frames."""
    import asyncio

    _, ranks = world2
    model = _port()
    kw = dict(max_audio_length_ms=400, temperature=0.0)
    want = asyncio.run(dh._ask_servers(
        TTSServer(model, max_wait_ms=300, **kw),
        ContinuousTTSServer(model, n_slots=4, max_prompt_bucket=32, **kw),
        dict(texts=TEXTS)))
    got = ranks[0]["servers m2"]
    for key in ("tts", "stream", "continuous"):
        assert len(got[key]) == len(want[key]) > 0
        for a, b in zip(got[key], want[key]):
            # the same frames; the lockstep batches form by arrival time,
            # and the codec's float sums change with the batch's rows
            assert a.shape == b.shape, key
            np.testing.assert_allclose(a, b, rtol=0, atol=SERVER_AUDIO_ATOL,
                                       err_msg=key)
    assert "servers m2" not in ranks[1]


def test_serve_cli_mesh_answers_from_rank_0(world2, singletons):
    """`serve --mesh model=2`: both ranks shard the model, rank 0 binds the
    port and answers POST /tts with the WAV of the solo generation."""
    _, ranks = world2
    reply = ranks[0]["cli m2"]
    assert reply.startswith(b"HTTP/1.1 200"), reply[:80]
    body = reply.split(b"\r\n\r\n", 1)[1]
    audio = tgen.generate_batch(_port(), [TEXTS[1]], [0],
                                max_audio_length_ms=320,
                                temperature=0.0)[0].numpy()
    assert body == wav_bytes(audio)
    assert ranks[1]["cli m2"] is None


@pytest.mark.parametrize("spec", ["data=2,model=4", "model=4,data=2",
                                  "data=8", "data", "data=0", "data=2,",
                                  "=4", "data=x", "data=2,data=2"])
def test_parse_mesh_argument_equals_jax(spec):
    try:
        want = jparse(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_mesh_argument(spec)
        assert str(got.value) == str(e)
        return
    got = parse_mesh_argument(spec)
    assert got == want and list(got) == list(want)
