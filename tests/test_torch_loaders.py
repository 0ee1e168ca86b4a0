"""The port's checkpoint IO (`loaders.py`, `safetensors_io.py`) against the
JAX package's and the installed `safetensors` package: the same names and
trees, files that load in either package, and the non-strict merge rules."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch
import torch

from conftest import tiny_args
from csm_mlx_tpu.loaders import flat_to_tree as jax_flat_to_tree
from csm_mlx_tpu.loaders import tree_to_flat as jax_flat
from csm_mlx_tpu.models.csm import CSM as JaxCSM
from csm_mlx_tpu_torch import safetensors_io
from csm_mlx_tpu_torch.loaders import (flat_to_tree, load_csm_weights,
                                       save_csm_weights, tree_to_flat)
from csm_mlx_tpu_torch.ops.quant import quantize_model
from torch_helpers import torch_model_from_jax


def _tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "f32": torch.randn((3, 5), generator=g),
        "bf16": torch.randn((4, 2, 3), generator=g).bfloat16(),
        "f16": torch.randn((7,), generator=g).half(),
        "i8": torch.randint(-128, 128, (2, 9), generator=g, dtype=torch.int8),
        "i32": torch.randint(-2 ** 31, 2 ** 31 - 1, (5,), generator=g,
                             dtype=torch.int32),
        "u8": torch.randint(0, 256, (3, 3), generator=g, dtype=torch.uint8),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros((0, 4)),
    }


def test_safetensors_io_round_trips_against_the_package(tmp_path):
    """Each of F32, BF16, F16, I8, I32, U8 (and a 0-d and an empty tensor)
    written by the port loads bit-equal in the `safetensors` package, and
    the package's file loads bit-equal here."""
    tensors = _tensors()
    ours = str(tmp_path / "ours.safetensors")
    safetensors_io.save_file(tensors, ours, metadata={"format": "pt"})
    theirs = safetensors.torch.load_file(ours)
    ref = str(tmp_path / "ref.safetensors")
    safetensors.torch.save_file(tensors, ref, metadata={"format": "pt"})
    back = safetensors_io.load_file(ref)
    for loaded in (theirs, back, safetensors_io.load_file(ours)):
        assert set(loaded) == set(tensors)
        for k, t in tensors.items():
            assert loaded[k].dtype == t.dtype and loaded[k].shape == t.shape
            assert torch.equal(loaded[k], t), k
    with open(ours, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
    assert n % 8 == 0
    with pytest.raises(ValueError, match="dtype"):
        safetensors_io.save_file({"x": torch.zeros(2, dtype=torch.int64)},
                                 str(tmp_path / "bad.safetensors"))


def test_flat_tree_names_match_jax():
    jm = JaxCSM(tiny_args(), dtype=jnp.float32, rng=jax.random.PRNGKey(0))
    model = torch_model_from_jax(jm)
    model.params["_resident"] = {"norm": torch.zeros(2)}
    flat = tree_to_flat(model.params)
    assert set(flat) == set(jax_flat(jm.params))
    tree = flat_to_tree(flat)
    jtree = jax_flat_to_tree({k: np.asarray(v)
                              for k, v in jax_flat(jm.params).items()})
    assert len(tree["backbone"]["layers"]) == len(jtree["backbone"]["layers"])
    assert set(tree_to_flat(tree)) == set(flat)


def test_checkpoints_load_in_either_package(tmp_path):
    """A JAX save_weights file loads strictly in the port (bf16 model: floats
    cast, as in JAX) and the port's file loads strictly in JAX, bit-equal
    in fp32."""
    jm = JaxCSM(tiny_args(), dtype=jnp.float32, rng=jax.random.PRNGKey(1))
    jm.save_weights(str(tmp_path / "jax.safetensors"))
    model = torch_model_from_jax(JaxCSM(tiny_args(), dtype=jnp.float32,
                                        rng=jax.random.PRNGKey(2)))
    model.load_weights(str(tmp_path / "jax.safetensors"))
    want = jax_flat(jm.params)
    got = tree_to_flat(model.params)
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))
    model.save_weights(str(tmp_path / "port.safetensors"))
    back = JaxCSM(tiny_args(), dtype=jnp.float32, rng=jax.random.PRNGKey(3))
    back.load_weights(str(tmp_path / "port.safetensors"))
    for k, v in jax_flat(back.params).items():
        np.testing.assert_array_equal(np.asarray(v), got[k].numpy())
    tree = load_csm_weights(str(tmp_path / "jax.safetensors"),
                            dtype=torch.bfloat16, device="cpu")
    assert tree["audio_head"].dtype == torch.bfloat16
    save_csm_weights(str(tmp_path / "part.safetensors"),
                     {"projection": model.params["projection"]})
    with pytest.raises(ValueError, match="missing components"):
        load_csm_weights(str(tmp_path / "part.safetensors"), device="cpu")
    with pytest.raises(FileNotFoundError):
        load_csm_weights(str(tmp_path / "none.safetensors"), device="cpu")


def test_nonstrict_load_merges_like_jax(tmp_path):
    """Non-strict loads over a W8A8, fused model: a dense projection evicts
    its quantized sibling (codes and fp32 scales elsewhere keep their type),
    full q/k/v evict the fused qkv, a partial q update over a fused model
    raises, the caller's tree is not modified and "_" entries are dropped."""
    jm = JaxCSM(tiny_args(), dtype=jnp.float32, rng=jax.random.PRNGKey(4))
    fresh = torch_model_from_jax(JaxCSM(tiny_args(), dtype=jnp.float32,
                                        rng=jax.random.PRNGKey(5)))
    model = torch_model_from_jax(jm)
    quantize_model(model, mode="w8a8", min_size=1,
                   targets=("decoder", "projection"), fuse=True)
    model.params["_resident"] = {"norm": torch.zeros(2)}
    before = model.params
    fa = fresh.params["decoder"]["layers"][0]["self_attn"]
    path = str(tmp_path / "dense.safetensors")
    save_csm_weights(path, {
        "projection": {"weight": fresh.params["projection"]["weight"]},
        "decoder": {"layers": [{"self_attn": {
            k: {"weight": fa[k]["weight"]}
            for k in ("q_proj", "k_proj", "v_proj")}}]}})
    model.load_weights(path, strict=False)
    assert model.params is not before and "_resident" in before
    assert "_resident" not in model.params
    proj = model.params["projection"]
    assert set(proj) == {"weight"}
    assert torch.equal(proj["weight"], fresh.params["projection"]["weight"])
    at0 = model.params["decoder"]["layers"][0]["self_attn"]
    assert "qkv_proj" not in at0 and "q_proj" in at0
    at1 = model.params["decoder"]["layers"][1]["self_attn"]
    assert at1["qkv_proj"]["weight_q"].dtype == torch.int8
    assert at1["qkv_proj"]["scales"].dtype == torch.float32

    save_csm_weights(path, {"decoder.layers.1.self_attn.q_proj.weight":
                            fa["q_proj"]["weight"]})
    with pytest.raises(ValueError, match="fused"):
        model.load_weights(path, strict=False)
