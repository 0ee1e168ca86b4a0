"""The port's user entry points against the JAX package's: the package root
(`__all__`, lazy imports), `python -m csm_mlx_tpu_torch`, and the CLI —
`generate`'s and every `finetune` command's flags and defaults against
JAX's `build_parser()`, their exits before any weight is loaded, `finetune
convert` against JAX's on one folder, `generate.synthesize` on a tiny CPU
model against a direct `generate` call, one `finetune lora sft` /
`finetune full sft` step on a tiny CPU model whose saved weights load back,
and `finetune full sft --data-parallel` / `finetune lora sft --fsdp` on two
CPU ranks over gloo (`torch_dist_helpers.cli_world`) against one rank.

The tiny model and codec are `tests/test_torch_context.py`'s (8 codebooks
of 32 codes, the real ratios), with its fake text tokenizer."""

import json
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_helpers as dh
from conftest import TINY_BACKBONE, TINY_DECODER, tiny_args
from test_torch_context import CODEC, N_CB, FakeTokenizer
from torch_helpers import text_prompt, torch_model_from_jax
from csm_mlx_tpu.models import csm as jcsm
from csm_mlx_tpu_torch import bridge
from csm_mlx_tpu_torch import generation as tgen
from csm_mlx_tpu_torch import tokenizers as ttok
from csm_mlx_tpu_torch.cli import generate as tgenerate_cli
from csm_mlx_tpu_torch.cli.application import build_parser
from csm_mlx_tpu_torch.cli.finetune import full_finetune, lora_finetune
from csm_mlx_tpu_torch.finetune.lora import load_adapters
from csm_mlx_tpu_torch.models.csm import CSM
from csm_mlx_tpu_torch.models.mimi import Mimi as TMimi
from csm_mlx_tpu_torch.ops.layers import linear
from csm_mlx_tpu_torch.ops.sampling import make_sampler
from csm_mlx_tpu_torch.segment import Segment
from csm_mlx_tpu_torch.utils.audio import write_audio

ROOT = Path(__file__).resolve().parent.parent

COMMANDS = [("generate",), ("finetune", "convert")] + [
    ("finetune", kind, mode) for kind in ("full", "lora")
    for mode in ("sft", "dpo", "kto")]


def _subparser(parser, path):
    for name in path:
        sub = next(a for a in parser._actions
                   if type(a).__name__ == "_SubParsersAction")
        parser = sub.choices[name]
    return parser


def _flags(parser):
    """{dest: (option strings, default, type, choices, action)}, help texts
    aside (as tests/test_torch_serve.py compares `serve`)."""
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices,
                     type(a).__name__)
            for a in parser._actions if a.dest not in ("help", "func")}


def _commands(parser):
    """(name, help) of each subcommand, in order, one level down."""
    sub = next(a for a in parser._actions
               if type(a).__name__ == "_SubParsersAction")
    return [(c.dest, c.help) for c in sub._choices_actions]


@pytest.mark.parametrize("path", COMMANDS, ids=" ".join)
def test_flags_and_defaults_equal_jax(path):
    """Every flag of the command: option strings, default, type, choices
    and action, as JAX's. The weight default is JAX's hub id, which the
    port does not fetch (it exits, see below)."""
    from csm_mlx_tpu.cli.application import build_parser as jbuild

    got = _flags(_subparser(build_parser(), path))
    assert got == _flags(_subparser(jbuild(), path))
    if path == ("generate",):
        assert got["weight"][1] == "senstella/csm-1b-mlx"
        assert got["adapter"][1] is None
    if path[0] == "finetune" and path[-1] != "convert":
        assert got["pretrained_path"][1] is None


def test_commands_in_jax_order_with_jax_help():
    from csm_mlx_tpu.cli.application import build_parser as jbuild

    for path in ((), ("finetune",), ("finetune", "full"),
                 ("finetune", "lora")):
        assert _commands(_subparser(build_parser(), path)) == \
            _commands(_subparser(jbuild(), path)), path
    assert build_parser().prog == "csm-torch"


def test_python_m_lists_the_commands():
    for argv, names in ((["--help"], ("generate", "serve", "finetune")),
                        (["finetune", "--help"], ("full", "lora", "convert"))):
        out = subprocess.run(
            [sys.executable, "-m", "csm_mlx_tpu_torch", *argv],
            capture_output=True, text=True, cwd=ROOT, timeout=120)
        assert out.returncode == 0, out.stderr
        assert all(n in out.stdout for n in names), out.stdout


def test_package_root_exports_jax_all():
    """`from csm_mlx_tpu_torch import *` gives JAX's `__all__`; a bare
    import loads no trainer, server or engine module; the version is
    pyproject's."""
    import csm_mlx_tpu
    import csm_mlx_tpu_torch

    assert csm_mlx_tpu_torch.__all__ == csm_mlx_tpu.__all__
    scope: dict = {}
    exec("from csm_mlx_tpu_torch import *", scope)
    assert set(csm_mlx_tpu.__all__) <= set(scope)
    assert scope["quantize"].__name__ == "quantize_model"
    assert scope["CSMTrainer"].__module__ == \
        "csm_mlx_tpu_torch.finetune.trainer"
    assert csm_mlx_tpu_torch.__version__ == "0.5.0"
    assert 'version = "0.5.0"' in (ROOT / "pyproject.toml").read_text()
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        csm_mlx_tpu_torch.nope
    code = ("import sys, csm_mlx_tpu_torch\n"
            "bad = [m for m in sys.modules if m.startswith("
            "('csm_mlx_tpu_torch.finetune', 'csm_mlx_tpu_torch.serve', "
            "'csm_mlx_tpu_torch.continuous', 'csm_mlx_tpu_torch.cli'))]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("argv,match", [
    (["generate", "hi", "-o", "x.wav"], "not a local path"),
    (["generate", "hi", "-o", "x.wav", "-ia", "a.wav"], None),
    (["finetune", "lora", "sft", "--data-path", "d.json", "-o", "out"],
     "--pretrained-path"),
    (["finetune", "convert", "/nonexistent/dir", "out.json"],
     "is not a directory"),
])
def test_commands_exit_before_loading(argv, match, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = build_parser().parse_args(argv)
    with pytest.raises(SystemExit, match=match) as e:
        args.func(args)
    if match is None:  # context inputs of unequal length
        assert e.value.code == 1


def test_generate_without_a_gpu_raises_resolve_device(tmp_path, monkeypatch):
    """A local weight file is accepted; with no GPU visible the command
    raises `resolve_device`'s error rather than carry on on the CPU."""
    weights = tmp_path / "model.safetensors"
    weights.write_bytes(b"")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = build_parser().parse_args(
        ["generate", "hi", "-o", str(tmp_path / "x.wav"), "-w", str(weights)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        args.func(args)


def _conversations(root: Path, seconds: float = 0.24) -> Path:
    """Two conversation folders of `speaker<N>` WAVs and transcripts (one
    WAV without a transcript, one empty transcript), as `convert` reads
    them."""
    rng = np.random.RandomState(3)
    for conv, names in (("conv1", ("turn1_speaker0", "turn2_speaker1",
                                   "turn10_speaker0", "turn3_speaker1")),
                        ("conv2", ("a_speaker2", "b_SPEAKER3"))):
        d = root / conv
        d.mkdir(parents=True)
        for i, name in enumerate(names):
            wave = 0.3 * np.sin(np.linspace(0, 200 * (i + 1),
                                            int(24000 * seconds)))
            write_audio((wave + 0.01 * rng.randn(wave.size)).astype(
                np.float32), d / f"{name}.wav", 24000)
            if name != "turn3_speaker1":
                (d / f"{name}.txt").write_text(
                    "" if name == "b_SPEAKER3" else f"Line {name}.\n")
    return root


def test_convert_writes_jax_json(tmp_path):
    from csm_mlx_tpu.cli.application import build_parser as jbuild

    src = _conversations(tmp_path / "in")
    out = {}
    for side, parse in (("jax", jbuild), ("port", build_parser)):
        path = tmp_path / side / "data.json"
        args = parse().parse_args(["finetune", "convert", str(src),
                                   str(path)])
        args.func(args)
        out[side] = path.read_text()
    assert out["port"] == out["jax"]
    data = json.loads(out["port"])
    assert [[t["speaker"] for t in c] for c in data] == [[0, 1, 0], [2]]


@pytest.fixture
def tiny(monkeypatch):
    """A tiny fp32 CPU CSM with a random head (8 codebooks), the tiny codec
    installed as the CPU singleton and the fake text tokenizer."""
    jm = jcsm.CSM(tiny_args(n_codebooks=N_CB), dtype=jnp.float32,
                  rng=jax.random.PRNGKey(61))
    jm.params["audio_head"] = jax.random.normal(
        jax.random.PRNGKey(62), jm.params["audio_head"].shape) * 0.5
    mimi = TMimi(bridge.mimi_config_from(CODEC), device="cpu",
                 generator=torch.Generator().manual_seed(63))
    monkeypatch.delenv(ttok.MIMI_WEIGHTS_ENV, raising=False)
    monkeypatch.setitem(ttok._MIMI_CACHE, (N_CB, "cpu"), (None, mimi))
    fake = FakeTokenizer()
    monkeypatch.setattr(ttok, "get_text_tokenizer", lambda path=None: fake)
    return torch_model_from_jax(jm)


@pytest.mark.parametrize("case", ["greedy", "seeded", "context", "long"])
def test_synthesize_writes_the_wav_of_generate(tiny, tmp_path, case):
    """The flags through `synthesize` on a model in hand write the WAV that
    the same call of `generate` (`generate_long` with --long) gives."""
    out = tmp_path / "out.wav"
    flags = ["generate", "Hello there. How are you?", "-o", str(out),
             "-l", "640", "-s", "1"]
    sampler = make_sampler(temp=0.8, top_k=50)
    gen = None
    context = ()
    if case == "greedy":
        flags += ["--temperature", "0"]
        sampler = make_sampler(temp=0.0, top_k=50)
    elif case == "seeded":
        flags += ["--seed", "5", "--top-p", "0.9"]
        sampler = make_sampler(temp=0.8, top_p=0.9, top_k=50)
        gen = torch.Generator().manual_seed(5)
    elif case == "context":
        wav = tmp_path / "ctx.wav"
        write_audio(0.2 * np.sin(np.linspace(0, 300, 24000 // 5)).astype(
            np.float32), wav, 24000)
        flags += ["--temperature", "0", "-is", "0", "-ia", str(wav), "-it",
                  "Before."]
        sampler = make_sampler(temp=0.0, top_k=50)
        context = [Segment(0, "Before.", None, wav)]
    else:
        flags += ["--temperature", "0", "--long", "--pause-ms", "40"]
        sampler = make_sampler(temp=0.0, top_k=50)
    args = build_parser().parse_args(flags)
    assert args.func is tgenerate_cli.run
    audio = tgenerate_cli.synthesize(args, tiny)
    if case == "long":
        want = tgen.generate_long(tiny, args.text, 1, (),
                                  max_segment_audio_ms=640, sampler=sampler,
                                  pause_ms=40)
    else:
        want = tgen.generate(tiny, args.text, 1, context, 640,
                             sampler=sampler, generator=gen)
    assert want.numel() > 0
    torch.testing.assert_close(audio, want, rtol=0, atol=0)
    write_audio(want.numpy(), tmp_path / "want.wav", 24000)
    assert out.read_bytes() == (tmp_path / "want.wav").read_bytes()


def _c0_logits(model, prompt, mask):
    """codebook 0's logits after one prefill of the prompt."""
    from csm_mlx_tpu_torch.ops.kv_cache import KVCache
    from csm_mlx_tpu_torch.ops.rope import rope_cache_for

    tokens, msk, pad, bucket = tgen._pad_prompt(prompt, mask)
    bcfg = model.args.backbone_config
    cos, sin = rope_cache_for(bcfg, bcfg.max_position_embeddings, "cpu")
    cache = KVCache.init(bcfg, 1, bucket + 1, dtype=torch.float32,
                         device="cpu")
    with torch.no_grad():
        h, _ = tgen._prefill(model.params, model.args,
                             torch.from_numpy(tokens).long(),
                             torch.from_numpy(msk).long(),
                             torch.from_numpy(pad).long(), cache, cos, sin)
        return linear(model.params["codebook0_head"], h).float()


def _clone(params):
    if isinstance(params, dict):
        return {k: _clone(v) for k, v in params.items()}
    if isinstance(params, list):
        return [_clone(v) for v in params]
    return params.detach().clone()


@pytest.mark.parametrize("kind", ["lora", "full"])
def test_finetune_sft_one_step_saves_weights_that_reload(tiny, tmp_path,
                                                         kind):
    """`finetune convert` then one `finetune {lora,full} sft` step at batch
    1 on a model in hand: a finite loss, the files JAX's command writes,
    and the saved weights, loaded into the untrained model (LoRA:
    `load_adapters`), give the trained model's logits on one prompt."""
    src = _conversations(tmp_path / "in")
    data = tmp_path / "data.json"
    convert = build_parser().parse_args(["finetune", "convert", str(src),
                                         str(data)])
    convert.func(convert)
    # one conversation: one step of batch 1
    data.write_text(json.dumps(json.loads(data.read_text())[:1]))
    out = tmp_path / "run"
    args = build_parser().parse_args(
        ["finetune", kind, "sft", "--data-path", str(data), "-o", str(out),
         "--batch-size", "1", "--epochs", "1", "--log-freq", "1",
         "--ckpt-freq", "0", "--lr", "1e-2", "--lora-rank", "4"]
        if kind == "lora" else
        ["finetune", kind, "sft", "--data-path", str(data), "-o", str(out),
         "--batch-size", "1", "--epochs", "1", "--log-freq", "1",
         "--ckpt-freq", "0", "--lr", "1e-3", "--freeze-decoder"])
    module = lora_finetune if kind == "lora" else full_finetune
    assert args.func is module.run
    base = _clone(tiny.params)
    prompt, mask = text_prompt(tiny.args, 7, seed=1)
    before = _c0_logits(tiny, prompt, mask)
    module.train(args, tiny)
    history = json.loads((out / "trainer_state.json").read_text())
    losses = [r["loss"] for r in history["history"]]
    assert len(losses) == 1 and math.isfinite(losses[0])
    trained = _c0_logits(tiny, prompt, mask)
    assert not torch.equal(trained, before)
    reloaded = CSM(tiny.args, params=base, dtype=torch.float32)
    if kind == "lora":
        cfg = json.loads((out / "adapter_config.json").read_text())
        assert cfg["fine_tune_type"] == "lora"
        assert cfg["lora_parameters"]["rank"] == 4
        load_adapters(reloaded, str(out))
    else:
        reloaded.load_weights(str(out / "final_model.safetensors"))
        torch.testing.assert_close(
            reloaded.params["decoder"]["layers"][0]["mlp"]["down_proj"]
            ["weight"],
            base["decoder"]["layers"][0]["mlp"]["down_proj"]["weight"])
    torch.testing.assert_close(_c0_logits(reloaded, prompt, mask), trained,
                               rtol=0, atol=0)


@pytest.mark.parametrize("kind,flag", [("full", "--data-parallel"),
                                       ("lora", "--fsdp")])
def test_finetune_parallel_flags_on_two_ranks_give_one_ranks_loss(
        tiny, tmp_path, kind, flag):
    """`finetune full sft --data-parallel` and `finetune lora sft --fsdp`
    run one step of batch 2 on two CPU ranks (gloo), one row each: the
    loss of a one-rank run of the same command without the flag (rtol
    1e-5: the masked means' sums split over the ranks), and only rank 0
    writes files (the checkpoint, the trainer state, the final weights or
    adapters and their config)."""
    src = _conversations(tmp_path / "in")
    data = tmp_path / "data.json"
    convert = build_parser().parse_args(["finetune", "convert", str(src),
                                         str(data)])
    convert.func(convert)
    params = dh.numpy_tree(tiny.params)

    def argv(out):
        return (["finetune", kind, "sft", "--data-path", str(data), "-o",
                 str(out), "--batch-size", "2", "--epochs", "1",
                 "--log-freq", "1", "--ckpt-freq", "1", "--lr", "1e-3"]
                + (["--lora-rank", "4"] if kind == "lora" else []))

    one = tmp_path / "one"
    module = lora_finetune if kind == "lora" else full_finetune
    module.train(build_parser().parse_args(argv(one)), tiny)
    want = [r["loss"] for r in json.loads(
        (one / "trainer_state.json").read_text())["history"]]
    a = tiny.args
    two = tmp_path / "two"
    ranks = dh.run_world(2, dh.cli_world, dict(
        backbones={"tiny": bridge.llama_config_from(TINY_BACKBONE)},
        decoders={"tiny": bridge.llama_config_from(TINY_DECODER)},
        model_args=(a.backbone_name, a.decoder_name, a.n_text_vocab,
                    a.n_audio_vocab, a.n_audio_codebooks),
        params=params, codec=bridge.mimi_config_from(CODEC), codec_seed=63,
        n_cb=N_CB, argv=argv(two) + [flag], out=str(two),
        fsdp_min_bytes=1024), tmp_path)
    got = [r["loss"] for r in ranks[0]["history"]]
    assert len(want) == 1 and math.isfinite(want[0])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert ranks[1]["written"] == []
    final = "adapters.safetensors" if kind == "lora" else \
        "final_model.safetensors"
    assert {"latest.safetensors", "trainer_state.json", final} <= \
        set(ranks[0]["written"])
    assert (two / final).exists()
