"""PyTorch port vs JAX package: MLX-affine quantization and kernel 5 (the
grouped-affine dequant matvec). On the CPU the port's wrapper runs its
plain version; the JAX Pallas kernel runs in interpret mode, as the JAX
package runs it on the CPU."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_args
from torch_helpers import text_prompt, to_torch, torch_model_from_jax
from csm_mlx_tpu import generation as jgen
from csm_mlx_tpu.models import csm as jcsm
from csm_mlx_tpu.ops import quant as jquant
from csm_mlx_tpu_torch import generation as tgen
from csm_mlx_tpu_torch.ops import quant as tquant

# Both sides dequantize the same codes to the same fp32 weights and sum in
# fp32, in other orders (per group in the Pallas kernel, whole rows in the
# einsum and in torch).
RTOL = 1e-5


def _weights(seed, out_dim, in_dim, rows):
    rng = np.random.RandomState(seed)
    w = (rng.randn(out_dim, in_dim) * 0.1).astype(np.float32)
    x = rng.randn(rows, in_dim).astype(np.float32)
    return w, x


def _codes(tq, bits):
    """The port's codes unpacked to one uint8 per column."""
    wq = tq["weight_q"]
    return (tquant.unpack_uint4(wq) if bits == 4 else wq).numpy()


@pytest.mark.parametrize("group", [32, 64, 128])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_weight_equals_jitted_jax(bits, group):
    w, _ = _weights(bits * 1000 + group, 96, 256, 1)
    w[3] = 0.25  # a constant row: every scale is 0 -> 1
    w[4, :group] = -0.5  # one constant group
    want = jax.device_get(
        jquant._jitted_quantizer("affine", bits, group)(jnp.asarray(w)))
    got = tquant.quantize_weight(torch.from_numpy(w), bits, group)
    assert got["weight_q"].dtype == torch.uint8
    assert got["weight_q"].shape == (96, 256 if bits == 8 else 128)
    np.testing.assert_array_equal(_codes(got, bits),
                                  np.asarray(want["weight_q"], np.uint8))
    for k in ("scales", "biases"):
        assert got[k].shape == (96, 256 // group)
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    # and the dequantized weight, from the port's (packed) layout
    np.testing.assert_array_equal(
        tquant.dequantize_weight(got, bits, torch.float32).numpy(),
        np.asarray(jquant.dequantize_weight(want, dtype=jnp.float32)))


def test_pack_uint4_layout():
    q = torch.tensor([[1, 2, 15, 0], [7, 8, 3, 12]], dtype=torch.uint8)
    packed = tquant.pack_uint4(q)
    np.testing.assert_array_equal(packed.numpy(),
                                  [[0x21, 0x0F], [0x87, 0xC3]])
    np.testing.assert_array_equal(tquant.unpack_uint4(packed).numpy(),
                                  q.numpy())


def test_dequantize_weight_needs_bits():
    tq = tquant.quantize_weight(torch.randn(8, 64), 4, 32)
    with pytest.raises(TypeError):
        tquant.dequantize_weight(tq)  # (8, 32) uint8: 8-bit of IN 32 or 4-bit of 64
    with pytest.raises(ValueError, match="bits"):
        tquant.dequantize_weight(tq, 2)
    assert tquant.dequantize_weight(tq, 4).shape == (8, 64)


@pytest.mark.parametrize("codes", ["uint8", "uint4"])
@pytest.mark.parametrize("group", [128, 256])
@pytest.mark.parametrize("rows", [1, 2, 8, 32, 64])
def test_affine_plain_matches_pallas_interpret(rows, group, codes):
    """The plain version against the JAX Pallas kernel itself (interpret
    mode), with JAX's own codes carried across by the bridge: uint8 codes
    stay 8-bit, uint4 codes are packed."""
    bits = 4 if codes == "uint4" else 8
    w, x = _weights(rows * 7 + group, 256, 256, rows)
    jq = jquant._jitted_quantizer("affine", bits, group)(jnp.asarray(w))
    assert jq["weight_q"].dtype == jnp.dtype(codes)
    want = np.asarray(jquant._pallas_quant_matvec(
        jnp.asarray(x), jq["weight_q"], jq["scales"], jq["biases"],
        bits=bits, group_size=group))
    tq = to_torch(jq)
    assert tq["weight_q"].shape == (256, 256 * bits // 8)
    got = tquant.affine_matvec(torch.from_numpy(x), tq["weight_q"],
                               tq["scales"], tq["biases"]).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())


def _factorized_matvec(x, tq, bits):
    """The arithmetic of kernel 5's tensor-core route, written plainly: per
    group the exact products q * x (bf16 x, integer codes) summed in fp32,
    then acc = fma(z, sum(x), fma(s, sum(q x), acc)), the groups in order;
    the output in bf16."""
    wq = tq["weight_q"]
    q = (tquant.unpack_uint4(wq) if bits == 4 else wq).double()
    s, z = tq["scales"].double(), tq["biases"].double()
    out_dim, n_groups = s.shape
    qg = q.reshape(out_dim, n_groups, -1)
    xg = x.double().reshape(x.shape[0], n_groups, -1)
    # exact in float64, then rounded once to fp32: a sum of 16-bit-exact
    # products in another order than the tensor core's, within fp32 rounding
    c = torch.einsum("ogk,bgk->bog", qg, xg).float()
    xs = xg.sum(-1).float()
    acc = torch.zeros(x.shape[0], out_dim)
    for j in range(n_groups):
        # fp32 fma: exact in float64, then one rounding
        acc = (s[:, j] * c[:, :, j].double() + acc.double()).float()
        acc = (z[:, j] * xs[:, j:j + 1].double() + acc.double()).float()
    return acc.to(torch.bfloat16)


@pytest.mark.parametrize("case", ["random", "constant group", "code 255",
                                  "large bias"])
@pytest.mark.parametrize("in_dim,bits,group", [(2048, 4, 64), (2048, 8, 64),
                                               (8192, 4, 64), (8192, 8, 64),
                                               (512, 4, 16), (480, 4, 48),
                                               (480, 8, 48)])
def test_affine_factorized_sum_matches_plain(in_dim, bits, group, case):
    """The tensor-core route's factorization, s * sum(q x) + z * sum(x) per
    group from bf16 x, against the plain version (the fp32 dequantized
    weight), at CSM-1B widths and at the edges: a constant group (scale 1,
    codes 0), 8-bit code 255, groups 16 and 48, and a bias far larger than
    the scale. Tolerance: the card's bf16 check (2^-7 of each value and
    1e-5 of the largest)."""
    rng = np.random.RandomState(in_dim + bits + group + len(case))
    out_dim = 96
    w = (rng.randn(out_dim, in_dim) * 0.1).astype(np.float32)
    if case == "constant group":
        w[:, :group] = 0.375
    elif case == "large bias":
        w = (100.0 + rng.randn(out_dim, in_dim) * 1e-3).astype(np.float32)
    tq = tquant.quantize_weight(torch.from_numpy(w), bits, group)
    codes = _codes(tq, bits)
    if case == "constant group":
        assert (tq["scales"][:, 0] == 1).all() and (codes[:, :group] == 0).all()
    elif case == "code 255":
        assert bits == 4 or (codes == 255).any()
    elif case == "large bias":
        assert (tq["biases"].abs() > 1e4 * tq["scales"]).all()
    x = torch.from_numpy(rng.randn(3, in_dim).astype(np.float32)).to(
        torch.bfloat16)
    want = tquant.affine_matvec_plain(x, tq["weight_q"], tq["scales"],
                                      tq["biases"]).float()
    got = _factorized_matvec(x, tq, bits).float()
    torch.testing.assert_close(got, want, rtol=2.0 ** -7,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("rows", [1, 8, 64, 100])
def test_affine_quant_linear_matches_jax_group64(rows, bits):
    """quant_linear at the reference default group 64, which the JAX
    package sends to its dequant einsum: the port's kernel route at <= 64
    rows, and above them its own dequant + matmul, with a bias."""
    w, x = _weights(rows + bits, 192, 320, rows)
    jq = dict(jquant._jitted_quantizer("affine", bits, 64)(jnp.asarray(w)))
    jq["bias"] = jnp.asarray(np.linspace(-1, 1, 192, dtype=np.float32))
    xs = x.reshape(rows, 1, 320)  # (B, S, IN) as the model calls it
    want = np.asarray(jquant.quant_linear(jq, jnp.asarray(xs)))
    got = tquant.quant_linear(to_torch(jq), torch.from_numpy(xs)).numpy()
    assert got.shape == want.shape == (rows, 1, 192)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())


def test_quant_linear_dispatches_on_code_type(monkeypatch):
    """Signed int8 codes take kernel 1 (W8A8), unsigned codes kernel 5 at
    <= 64 rows and the dequant matmul above: counted through the plain
    versions the CPU wrappers call."""
    calls = []
    for name in ("w8a8_matvec_plain", "affine_matvec_plain"):
        fn = getattr(tquant, name)
        monkeypatch.setattr(tquant, name, lambda *a, fn=fn, name=name: (
            calls.append(name), fn(*a))[1])
    w = torch.randn(64, 128)
    tquant.quant_linear(tquant.quantize_weight_w8(w), torch.randn(3, 128))
    aff = tquant.quantize_weight(w, 4, 64)
    tquant.quant_linear(aff, torch.randn(64, 128))
    tquant.quant_linear(aff, torch.randn(65, 128))
    assert calls == ["w8a8_matvec_plain", "affine_matvec_plain"]
    with pytest.raises(ValueError, match="fit neither"):
        tquant.quant_linear(aff, torch.randn(2, 96))


def _quantized_paths(tree, path=""):
    """Dotted paths of the dicts that carry codes."""
    if isinstance(tree, dict) and "weight_q" in tree:
        return {path}
    items = tree.items() if isinstance(tree, dict) else \
        enumerate(tree) if isinstance(tree, list) else ()
    return set().union(*[_quantized_paths(v, f"{path}.{k}" if path else str(k))
                         for k, v in items])


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_model_affine_matches_jax(bits):
    """Affine group 64 on the tiny model: the same leaves quantized (the
    tiny decoder's 32-wide inputs are skipped on both sides, with the same
    warnings), "audio_head" among the targets skipped silently, and every
    leaf equal after the bridge."""
    jm = jcsm.CSM(tiny_args(), dtype=jnp.float32, rng=jax.random.PRNGKey(5))
    tm = torch_model_from_jax(jm)
    targets = ("backbone", "decoder", "projection", "audio_head")
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jquant.quantize_model(jm, bits=bits, group_size=64, min_size=0,
                              mode="affine", targets=targets)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        tquant.quantize_model(tm, bits=bits, group_size=64, min_size=0,
                              mode="affine", targets=targets)
    j_msgs = sorted(str(w.message) for w in jw
                    if "quantize_model" in str(w.message))
    t_msgs = sorted(str(w.message) for w in tw)
    assert t_msgs == j_msgs and len(t_msgs) > 0
    assert all("decoder" in m for m in t_msgs)
    jp = jax.device_get(jm.params)
    assert _quantized_paths(tm.params) == _quantized_paths(jp)
    assert "decoder.layers.0.mlp.down_proj" in _quantized_paths(tm.params)
    assert isinstance(tm.params["audio_head"], torch.Tensor)
    want = to_torch(jp)

    def compare(a, b, path):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                compare(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                compare(x, y, f"{path}.{i}")
        else:
            assert a.dtype == b.dtype, path
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=path)

    compare(tm.params, want, "params")
    qkv = tm.params["backbone"]["layers"][0]["self_attn"]["qkv_proj"]
    assert qkv["weight_q"].shape[1] == 64 * bits // 8  # fused, packed at 4


def test_quantize_model_defaults_and_skips():
    """The JAX defaults (affine, 4-bit, group 64, min_size 1 << 16), a DoRA
    leaf skipped with JAX's warning, and a mode that JAX lacks refused."""
    import inspect

    sig = inspect.signature(tquant.quantize_model)
    jsig = inspect.signature(jquant.quantize_model)
    assert [(p.name, p.default) for p in sig.parameters.values()] == \
        [(p.name, p.default) for p in jsig.parameters.values()]
    jm = jcsm.CSM(tiny_args(), dtype=jnp.float32, rng=jax.random.PRNGKey(6))
    tm = torch_model_from_jax(jm)
    layer = tm.params["backbone"]["layers"][1]["self_attn"]["o_proj"]
    layer["dora_m"] = torch.ones(64)
    with pytest.warns(UserWarning, match="skipping DoRA-adapted "
                      "'backbone.layers.1.self_attn.o_proj'"):
        tquant.quantize_model(tm, min_size=0, fuse=False)
    assert "weight" in layer and "weight_q" not in layer
    gate = tm.params["backbone"]["layers"][0]["mlp"]["gate_proj"]
    assert gate["weight_q"].shape == (128, 32)  # 4-bit packed, IN 64
    assert gate["scales"].shape == (128, 1)  # group 64
    with pytest.raises(ValueError, match="w2a8"):
        tquant.quantize_model(tm, mode="w2a8")


@pytest.fixture(scope="module")
def base_params():
    """Params of a tiny JAX CSM (fp32) with a random audio_head: a zero
    head would make every decoder codebook 0."""
    params = jcsm.CSM(tiny_args(), dtype=jnp.float32,
                      rng=jax.random.PRNGKey(21)).params
    params["audio_head"] = jax.random.normal(
        jax.random.PRNGKey(22), params["audio_head"].shape) * 0.5
    return params


@pytest.mark.parametrize("bits", [4, 8])
def test_affine_greedy_frames_equal_jax(base_params, bits):
    """Greedy fp32 frames of the affine model (group 64, fused) equal the
    JAX package's token for token. JAX runs its dequant einsum on the CPU,
    the port kernel 5's plain version at the decode rows (the prompt's 32
    prefill rows included) — the same fp32 function."""
    jm = jcsm.CSM(tiny_args(), params=jax.tree_util.tree_map(
        lambda a: a, base_params), dtype=jnp.float32)
    tm = torch_model_from_jax(jm)
    with warnings.catch_warnings():  # the 32-wide decoder leaves stay raw
        warnings.simplefilter("ignore")
        jquant.quantize_model(jm, bits=bits, group_size=64, min_size=0)
        tquant.quantize_model(tm, bits=bits, group_size=64, min_size=0)
    prompt, mask = text_prompt(jm.args, 9, seed=bits)
    want, n_want = jgen.generate_tokens(jm, prompt, mask, 4, temperature=0.0)
    got, n_got = tgen.generate_tokens(tm, prompt, mask, 4, temperature=0.0)
    assert n_got == n_want == 4
    np.testing.assert_array_equal(got, want)
