"""PyTorch port vs JAX package: Mimi's encode direction and its checkpoint
loader on the tiny codec config (`tests/test_mimi.py::TINY`).

The same parameters (the port's seeded init, carried to JAX) and the same
waveform and latents, made with numpy from a seed, go through
JAX's and the port's `seanet_encode`, `split_rvq_encode` and whole
encode: latents within atol 1e-5 (fp32 on both sides, sums in other
orders), codes exactly equal. The port's streamed `encode_step` equals its
batch encode, code for code. A random-init `transformers.MimiModel` (its
codebooks randomized, as `tests/test_mimi.py::hf_pair` does), mapped by the
port's `map_mimi_state_dict`, encodes to HF's codes; the moshi naming maps
to the HF naming's tree; `load_mimi_checkpoint` of that state dict written
by the port's `safetensors_io` gives the mapped tree."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_mimi import TINY, _hf_config
from test_mimi_weights import _hf_to_moshi_names
from torch_helpers import to_jax, to_torch
from csm_mlx_tpu.models.mimi import Mimi as JMimi
from csm_mlx_tpu.models.mimi import rvq as jrvq
from csm_mlx_tpu.models.mimi import seanet as jseanet
from csm_mlx_tpu.models.mimi.transformer import \
    transformer_forward as jtransformer
from csm_mlx_tpu.models.mimi.weights import \
    map_mimi_state_dict as jmap_state
from csm_mlx_tpu_torch import safetensors_io
from csm_mlx_tpu_torch.bridge import mimi_config_from
from csm_mlx_tpu_torch.loaders import tree_to_flat
from csm_mlx_tpu_torch.models.mimi import Mimi as TMimi
from csm_mlx_tpu_torch.models.mimi import mimi as tmimi_mod
from csm_mlx_tpu_torch.models.mimi import rvq as trvq
from csm_mlx_tpu_torch.models.mimi import seanet as tseanet
from csm_mlx_tpu_torch.models.mimi import transformer as ttransformer
from csm_mlx_tpu_torch.models.mimi.weights import (load_mimi_checkpoint,
                                                   map_mimi_state_dict)

ATOL = 1e-5
TCFG = mimi_config_from(TINY)


@pytest.fixture(scope="module")
def mimis():
    """The port's random init from a seed, carried to JAX."""
    tm = TMimi(TCFG, device="cpu", generator=torch.Generator().manual_seed(7))
    return JMimi(TINY, params=to_jax(tm.params)), tm


def _audio(b, frames, seed):
    return (0.5 * np.random.RandomState(seed).randn(
        b, 1, frames * TINY.frame_size)).astype(np.float32)


def _jax_latent(params, audio):
    latent = jseanet.seanet_encode(params["encoder"], TINY, audio)
    h, _ = jtransformer(params["encoder_transformer"], TINY,
                        latent.transpose(0, 2, 1))
    return jseanet._causal_conv_batch(
        params["downsample"], h.transpose(0, 2, 1), TINY.downsample_stride,
        pad_mode="replicate")


def test_seanet_encode_and_latent_match_jax(mimis):
    jm, tm = mimis
    audio = _audio(2, 5, 1)
    want = np.asarray(jseanet.seanet_encode(jm.params["encoder"], TINY,
                                            jnp.asarray(audio)))
    got = tseanet.seanet_encode(tm.params["encoder"], TCFG,
                                torch.from_numpy(audio))
    assert got.shape == want.shape == (2, TINY.hidden_size, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    want = np.asarray(_jax_latent(jm.params, jnp.asarray(audio)))
    got = tmimi_mod.mimi_encode_latent(tm.params, TCFG,
                                       torch.from_numpy(audio))
    assert got.shape == want.shape == (2, TINY.hidden_size, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("nq", [1, 3, 4])
def test_split_rvq_encode_matches_jax(mimis, nq):
    """The same latents: codes equal, index for index (the argmax of
    2 x.e - |e|^2 in fp32 on both sides)."""
    jm, tm = mimis
    x = np.random.RandomState(nq).randn(2, TINY.hidden_size, 9) \
        .astype(np.float32)
    want = np.asarray(jrvq.split_rvq_encode(jm.params["quantizer"],
                                            jnp.asarray(x), nq))
    got = trvq.split_rvq_encode(tm.params["quantizer"], torch.from_numpy(x),
                                nq)
    assert got.shape == want.shape == (2, nq, 9)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("frames", [1, 6, 9])
def test_encode_matches_jax(mimis, frames):
    """`Mimi.encode` pads to the frame bucket as JAX does (9 frames: the
    16-frame bucket) and keeps the first frames: codes equal JAX's; an
    audio length off the frame grid is padded to whole frames alike."""
    jm, tm = mimis
    audio = _audio(2, frames, 10 + frames)[:, :, :frames * TINY.frame_size
                                            - (frames > 1)]
    want = np.asarray(jm.encode(jnp.asarray(audio)))
    got = tm.encode(torch.from_numpy(audio))
    assert got.shape == want.shape == (2, TINY.num_quantizers, frames)
    np.testing.assert_array_equal(got.numpy(), want)


def test_encode_step_matches_batch_and_jax(mimis):
    """Frame by frame through `encode_step` (explicit and internal state):
    the port's batch encode, code for code, and JAX's streamed codes."""
    jm, tm = mimis
    f, fs = 8, TINY.frame_size
    audio = _audio(1, f, 2)
    full = tm.encode(torch.from_numpy(audio)).numpy()
    state, jstate = tm.init_encode_state(), jm.init_encode_state()
    got, want = [], []
    tm.reset_state()
    stateful = []
    for i in range(f):
        chunk = audio[:, :, i * fs:(i + 1) * fs]
        c, state = tm.encode_step(torch.from_numpy(chunk), state)
        got.append(c.numpy())
        stateful.append(tm.encode_step(torch.from_numpy(chunk)).numpy())
        jc, jstate = jm.encode_step(jnp.asarray(chunk), jstate)
        want.append(np.asarray(jc))
    assert bool(state.downsample_filled)
    np.testing.assert_array_equal(np.concatenate(got, axis=-1), full)
    np.testing.assert_array_equal(np.concatenate(stateful, axis=-1), full)
    np.testing.assert_array_equal(np.concatenate(got, axis=-1),
                                  np.concatenate(want, axis=-1))
    tm.reset_state()
    again = tm.encode_step(torch.from_numpy(audio[:, :, :fs]))
    np.testing.assert_array_equal(again.numpy(), full[:, :, :1])


def test_encode_num_quantizers_validated(mimis):
    """0, negative and past-the-codec counts raise (0 never falls back to
    every codebook); None means all; 2 gives two."""
    _, tm = mimis
    audio = torch.zeros((1, 1, TINY.frame_size))
    for bad in (0, -1, TINY.num_quantizers + 1):
        with pytest.raises(ValueError, match="num_quantizers"):
            tm.encode(audio, num_quantizers=bad)
        with pytest.raises(ValueError, match="num_quantizers"):
            tm.encode_step(audio, tm.init_encode_state(), num_quantizers=bad)
    assert tm.encode(audio).shape == (1, TINY.num_quantizers, 1)
    assert tm.encode(audio, num_quantizers=2).shape == (1, 2, 1)
    codes, _ = tm.encode_step(audio, tm.init_encode_state(),
                              num_quantizers=2)
    assert codes.shape == (1, 2, 1)


def test_init_draws_the_encoder_after_the_decoder():
    """A generator gives the decode-direction parameters it gave before the
    encoder was ported: they are drawn first, in the same order."""
    from csm_mlx_tpu_torch.models.mimi.rvq import init_split_rvq_params

    params = tmimi_mod.init_mimi_params(torch.Generator().manual_seed(3),
                                        TCFG, device="cpu")
    gen = torch.Generator().manual_seed(3)
    d, s = TCFG.hidden_size, TCFG.downsample_stride
    up = torch.randn((d, d // TCFG.upsample_groups, 2 * s), generator=gen)
    decoder = tseanet.init_seanet_decoder_params(gen, TCFG, device="cpu")
    transformer = ttransformer.init_transformer_params(gen, TCFG,
                                                       device="cpu")
    quantizer = init_split_rvq_params(gen, TCFG, device="cpu")
    for name, want in (("decoder", decoder),
                       ("decoder_transformer", transformer),
                       ("quantizer", quantizer)):
        got = tree_to_flat(params[name])
        want = tree_to_flat(want)
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in got), name
    assert torch.equal(params["upsample"]["weight"], up * (2 * s) ** -0.5)
    assert {"encoder", "encoder_transformer", "downsample"} <= params.keys()


@pytest.fixture(scope="module")
def hf_model():
    from transformers import MimiModel

    torch.manual_seed(0)
    hf = MimiModel(_hf_config()).eval()
    with torch.no_grad():  # the init's codebooks are zeros
        for q in (hf.quantizer.semantic_residual_vector_quantizer,
                  hf.quantizer.acoustic_residual_vector_quantizer):
            for layer in q.layers:
                layer.codebook.embed_sum.normal_()
                layer.codebook.cluster_usage.uniform_(0.5, 2.0)
                layer.codebook._embed = None
    return hf


def test_hf_checkpoint_encodes_to_hf_codes(hf_model):
    """HF's state dict through the port's mapper: the port's codes equal
    `MimiModel.encode`'s, and its tree equals JAX's mapper's."""
    state = hf_model.state_dict()
    params = map_mimi_state_dict(state, TCFG)
    tm = TMimi(TCFG, params=params)
    assert tm.device.type == "cpu"
    audio = _audio(1, 6, 4)
    with torch.no_grad():
        want = hf_model.encode(torch.from_numpy(audio),
                               num_quantizers=TINY.num_quantizers)[0]
    np.testing.assert_array_equal(tm.encode(torch.from_numpy(audio)).numpy(),
                                  want.numpy())
    jtree = tree_to_flat(to_torch(jmap_state(
        {k: v.numpy() for k, v in state.items()}, TINY)))
    tree = tree_to_flat(params)
    assert tree.keys() == jtree.keys()
    for k in tree:
        torch.testing.assert_close(tree[k], jtree[k], rtol=0, atol=0)


def test_moshi_naming_maps_to_the_hf_tree(hf_model):
    """moshi's fused in_proj_weight (interleaved rope rows), nested
    conv.conv / convtr.convtr names and rvq_first / rvq_rest codebooks map
    to the tree of the HF naming."""
    state = {k: v.numpy() for k, v in hf_model.state_dict().items()}
    tree_hf = tree_to_flat(map_mimi_state_dict(state, TCFG, device="cpu"))
    tree_moshi = tree_to_flat(map_mimi_state_dict(_hf_to_moshi_names(state),
                                                  TCFG, device="cpu"))
    assert tree_hf.keys() == tree_moshi.keys()
    for k in tree_hf:
        torch.testing.assert_close(tree_moshi[k], tree_hf[k], rtol=1e-6,
                                   atol=0, msg=k)
    bad = dataclasses.replace(TCFG, num_key_value_heads=1)
    with pytest.raises(ValueError, match="MHA"):
        map_mimi_state_dict(_hf_to_moshi_names(state), bad, device="cpu")


def test_load_mimi_checkpoint_equals_the_mapped_tree(hf_model, tmp_path):
    """The state dict written by the port's safetensors writer (bf16 leaves
    too, as the moshi checkpoint holds), read back by
    `load_mimi_checkpoint`: the tree `map_mimi_state_dict` makes of it. A
    missing file and one the reader cannot parse raise."""
    state = {k: v.contiguous() for k, v in hf_model.state_dict().items()}
    state["encoder.layers.0.conv.weight"] = \
        state["encoder.layers.0.conv.weight"].bfloat16()
    path = tmp_path / "mimi.safetensors"
    safetensors_io.save_file(state, str(path))
    got = tree_to_flat(load_mimi_checkpoint(str(path), TCFG, device="cpu"))
    want = tree_to_flat(map_mimi_state_dict(state, TCFG))
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == torch.float32 and got[k].device.type == "cpu"
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    tm = TMimi(TCFG, device="cpu").load_pytorch_weights(str(path))
    assert torch.equal(tm.params["downsample"]["weight"],
                       want["downsample.weight"])
    with pytest.raises(FileNotFoundError):
        load_mimi_checkpoint(str(tmp_path / "missing.safetensors"), TCFG,
                             device="cpu")
    (tmp_path / "empty.safetensors").write_bytes(b"")
    with pytest.raises(ValueError, match="safetensors"):
        load_mimi_checkpoint(str(tmp_path / "empty.safetensors"), TCFG,
                             device="cpu")


def test_get_audio_tokenizer_loads_a_local_checkpoint(hf_model, tmp_path,
                                                      monkeypatch):
    """`get_audio_tokenizer(weights=path)` and `CSM_TPU_MIMI_WEIGHTS` load a
    local checkpoint (the tiny config standing in for `mimi_202407`): the
    codec encodes to HF's codes, and a later call without a path returns
    the installed instance."""
    import csm_mlx_tpu_torch.models.mimi as mimi_pkg
    from csm_mlx_tpu_torch import tokenizers as ttok

    monkeypatch.setattr(mimi_pkg, "mimi_202407", lambda n=32:
                        dataclasses.replace(TCFG, num_quantizers=n))
    monkeypatch.delenv(ttok.MIMI_WEIGHTS_ENV, raising=False)
    path = tmp_path / "mimi.safetensors"
    safetensors_io.save_file({k: v.contiguous() for k, v in
                              hf_model.state_dict().items()}, str(path))
    nq = TINY.num_quantizers
    audio = _audio(1, 6, 5)
    with torch.no_grad():
        want = hf_model.encode(torch.from_numpy(audio),
                               num_quantizers=nq)[0].numpy()
    ttok.get_audio_tokenizer.cache_clear()
    try:
        codec = ttok.get_audio_tokenizer(nq, str(path), device="cpu")
        assert ttok.get_audio_tokenizer(nq, device="cpu") is codec
        np.testing.assert_array_equal(codec.encode(audio).numpy(), want)
        ttok.get_audio_tokenizer.cache_clear()
        monkeypatch.setenv(ttok.MIMI_WEIGHTS_ENV, str(path))
        again = ttok.get_audio_tokenizer(nq, device="cpu")
        assert again is not codec
        np.testing.assert_array_equal(again.encode(audio).numpy(), want)
    finally:
        ttok.get_audio_tokenizer.cache_clear()
