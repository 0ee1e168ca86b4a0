"""`generate` — text to a WAV file (port of `csm_mlx_tpu/cli/generate.py`),
with the JAX CLI's flags and defaults. Weights and adapters are local
paths (`parse_weight_argument`, `parse_adapter_argument`); the default
hub id exits naming that rule. The text tokenizer and the Mimi weights
come from `CSM_TPU_TEXT_TOKENIZER` and `CSM_TPU_MIMI_WEIGHTS`. `--seed`
seeds a `torch.Generator` on the model's device.

`run` loads the model; `synthesize(args, csm)` does the rest (context,
`generate` or, with `--long`, `generate_long`, and the WAV), so that a
caller with a model in hand can drive the command's flags."""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional

from csm_mlx_tpu_torch.cli.config import MODEL


def parse_weight_argument(value: str) -> str:
    """A local weight file or directory -> the checkpoint file
    (`loaders.resolve_weight_path`); a failure exits with its message. A
    hub repo id is not fetched: it exits naming the local-path rule."""
    from csm_mlx_tpu_torch.loaders import resolve_weight_path

    try:
        return resolve_weight_path(value)
    except FileNotFoundError as e:
        raise SystemExit(f"Error: {e}")


def parse_adapter_argument(value: Optional[str]) -> Optional[str]:
    """A local LoRA adapter directory (adapter_config.json +
    adapters.safetensors) -> its resolved path; None passes through."""
    if value is None:
        return None
    required = ["adapter_config.json", "adapters.safetensors"]
    path = Path(value)
    if path.is_dir() and all((path / f).exists() for f in required):
        return str(path.resolve())
    raise SystemExit(
        f"Error: No required adapter files ({required}) found in {value} "
        f"(adapters are read from local directories only)")


def add_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "generate", help="Generate speech from text using CSM.")
    p.add_argument("text")
    p.add_argument("--output", "-o", required=True, type=Path,
                   help="Output audio file path")
    p.add_argument("--model", choices=list(MODEL), default="1b",
                   help="Model size")
    p.add_argument("--weight", "-w", default="senstella/csm-1b-mlx",
                   help="Local weight file or directory (a hub repo id is "
                        "not fetched)")
    p.add_argument("--adapter", "-a", default=None,
                   help="Path to adapter dir (adapter_config.json + "
                        "adapters.safetensors)")
    p.add_argument("--speaker", "-s", type=int, default=0, help="Speaker ID")
    p.add_argument("--max-audio-length", "-l", type=int, default=10_000,
                   help="Maximum audio length in milliseconds")
    p.add_argument("--temperature", "--temp", "-t", type=float, default=0.8)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--min-p", type=float, default=None)
    p.add_argument("--top-k", "-k", type=int, default=50)
    p.add_argument("--min-tokens-to-keep", type=int, default=1)
    p.add_argument("--input-speakers", "-is", type=int, nargs="*", default=[],
                   help="Speaker IDs for context segments")
    p.add_argument("--input-audios", "-ia", type=Path, nargs="*", default=[],
                   help="Audio files for context segments")
    p.add_argument("--input-texts", "-it", nargs="*", default=[],
                   help="Transcripts for context segments")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--watermark-key", type=int, default=None,
                   help="Embed a keyed spread-spectrum watermark in the "
                        "output (verify with "
                        "csm_mlx_tpu_torch.detect_watermark)")
    p.add_argument("--long", action="store_true",
                   help="Long-form mode: split the text into sentences and "
                        "synthesize each with a rolling voice context — "
                        "text length is not bound by the model context "
                        "window (--max-audio-length then caps each "
                        "sentence, not the total)")
    p.add_argument("--pause-ms", type=float, default=0.0,
                   help="Silence inserted between sentences in --long mode")
    p.set_defaults(func=run)


def run(args: argparse.Namespace) -> None:
    if len(args.input_audios) != len(args.input_texts) or \
            len(args.input_audios) != len(args.input_speakers):
        print("Error! All context inputs (input_audios, input_texts, and "
              "input_speakers) must have the same length.", file=sys.stderr)
        raise SystemExit(1)
    weight = parse_weight_argument(args.weight)
    adapter = parse_adapter_argument(args.adapter)

    from csm_mlx_tpu_torch.device import resolve_device
    from csm_mlx_tpu_torch.finetune.lora import load_adapters
    from csm_mlx_tpu_torch.loaders import load_csm_weights
    from csm_mlx_tpu_torch.models.csm import CSM

    print("Loading model...")
    csm = CSM(MODEL[args.model]["config"],
              params=load_csm_weights(weight, device=resolve_device()))
    if adapter is not None:
        load_adapters(csm, adapter)
    synthesize(args, csm)


def synthesize(args: argparse.Namespace, csm):
    """The flags' context, sampler and seed through `generate` (or
    `generate_long` with `--long`) on a loaded model; writes the WAV to
    `--output` and returns the waveform."""
    import torch

    from csm_mlx_tpu_torch.generation import generate, generate_long
    from csm_mlx_tpu_torch.ops.sampling import make_sampler
    from csm_mlx_tpu_torch.segment import Segment
    from csm_mlx_tpu_torch.utils.audio import write_audio

    sampler = make_sampler(
        temp=args.temperature,
        top_p=args.top_p or 0.0,
        min_p=args.min_p or 0.0,
        top_k=args.top_k or 0,
        min_tokens_to_keep=args.min_tokens_to_keep,
    )
    context = [
        Segment(speaker, text, None, audio)
        for audio, text, speaker in zip(
            args.input_audios, args.input_texts, args.input_speakers)
    ]

    print("Inferencing...")
    generator = None
    if args.seed is not None:
        generator = torch.Generator(device=csm.device)
        generator.manual_seed(args.seed)
    if args.long:
        result = generate_long(
            csm, args.text, args.speaker, context,
            max_segment_audio_ms=args.max_audio_length, sampler=sampler,
            generator=generator, watermark_key=args.watermark_key,
            pause_ms=args.pause_ms)
    else:
        result = generate(csm, args.text, args.speaker, context,
                          args.max_audio_length, sampler=sampler,
                          generator=generator,
                          watermark_key=args.watermark_key)
    write_audio(result.float().cpu().numpy(), args.output,
                MODEL[args.model].get("sampling_rate", 24000))
    print(f"Success! Audio saved to: {args.output}")
    return result
