"""`serve` — the TTS HTTP server (port of `csm_mlx_tpu/cli/serve.py`),
lockstep (`serve.TTSServer`) or, with `--continuous`, over the continuous
engine (`serve.ContinuousTTSServer`). The flags and defaults are the JAX
CLI's; `--mesh` and `--quantize-codec` exit naming the ROADMAP item they
wait for. Weights and adapters are local paths."""

from __future__ import annotations

import argparse


def add_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "serve", help="Serve batched TTS over HTTP (POST /tts).")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    from csm_mlx_tpu_torch.cli.config import MODEL

    p.add_argument("--model", choices=list(MODEL), default="1b")
    p.add_argument("--weight", "-w", default="senstella/csm-1b-mlx",
                   help="local weight file or directory (a hub repo id "
                        "is not fetched)")
    p.add_argument("--adapter", "-a", default=None,
                   help="LoRA adapter dir (adapter_config.json + "
                        "adapters.safetensors)")
    p.add_argument("--quantize", action="store_true",
                   help="Quantize to W8A8 (kernels 1 and 3) before serving")
    p.add_argument("--max-batch", type=int, default=64,
                   help="Coalesce up to this many concurrent requests "
                        "(default: kernel 3's rows a launch)")
    p.add_argument("--max-pending", type=int, default=256,
                   help="Reject (HTTP 503) new requests past this many "
                        "already queued")
    p.add_argument("--transfer", choices=("int16", "float32"),
                   default="int16",
                   help="Card-to-host waveform type; int16 moves half the "
                        "bytes and is lossless for the 16-bit PCM the "
                        "HTTP endpoints send")
    p.add_argument("--max-wait-ms", type=float, default=30.0,
                   help="How long to hold the first request for batchmates")
    p.add_argument("--max-audio-length", "-l", type=int, default=30_000,
                   help="Max generated audio per request (ms)")
    p.add_argument("--temperature", "--temp", "-t", type=float, default=0.8)
    p.add_argument("--watermark-key", type=int, default=None,
                   help="Watermark every generated waveform with this key")
    p.add_argument("--continuous", action="store_true",
                   help="Continuous batching: per-slot admission into one "
                        "always-running batched frame loop (finished rows "
                        "recycle at once; best under mixed lengths)")
    p.add_argument("--quantize-codec", action="store_true",
                   help="Continuous mode: the int8 Mimi decoder (not "
                        "ported: exits)")
    p.add_argument("--slots", type=int, default=64,
                   help="Continuous mode: concurrent generation slots "
                        "(default: kernel 3's rows a launch)")
    p.add_argument("--mesh", default=None, metavar="AXES",
                   help="Multi-card serving, 'data=2,model=4' (not "
                        "ported: exits)")
    p.set_defaults(func=run)


def make_server(args: argparse.Namespace, csm):
    """The server the flags ask for, over a loaded model."""
    from csm_mlx_tpu_torch.serve import ContinuousTTSServer, TTSServer

    if args.continuous:
        return ContinuousTTSServer(
            csm, n_slots=args.slots,
            max_audio_length_ms=args.max_audio_length,
            temperature=args.temperature, watermark_key=args.watermark_key,
            max_pending=args.max_pending, transfer=args.transfer)
    return TTSServer(
        csm, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        max_audio_length_ms=args.max_audio_length,
        temperature=args.temperature, watermark_key=args.watermark_key,
        transfer=args.transfer, max_pending=args.max_pending)


def run(args: argparse.Namespace) -> None:
    import asyncio

    from csm_mlx_tpu_torch.cli.config import MODEL
    from csm_mlx_tpu_torch.cli.generate import (parse_adapter_argument,
                                                parse_weight_argument)

    if args.mesh:
        raise SystemExit(
            "serve: --mesh: parallelism is not ported yet (ROADMAP queue 1, "
            "item 12)")
    if args.quantize_codec:
        raise SystemExit(
            "serve: --quantize-codec: the int8 codec (models/mimi/quant.py) "
            "is not ported; it waits for a measurement (ROADMAP queue 1)")
    weight = parse_weight_argument(args.weight)
    adapter = parse_adapter_argument(args.adapter)

    from csm_mlx_tpu_torch.device import resolve_device
    from csm_mlx_tpu_torch.finetune.lora import load_adapters
    from csm_mlx_tpu_torch.loaders import load_csm_weights
    from csm_mlx_tpu_torch.models.csm import CSM
    from csm_mlx_tpu_torch.ops.quant import quantize_model
    from csm_mlx_tpu_torch.serve import serve_http

    print("Loading model...")
    csm = CSM(MODEL[args.model]["config"],
              params=load_csm_weights(weight, device=resolve_device()))
    if adapter is not None:
        load_adapters(csm, adapter)
    if args.quantize:
        quantize_model(csm, mode="w8a8")
    server = make_server(args, csm)

    async def main():
        http = await serve_http(server, host=args.host, port=args.port)
        port = http.sockets[0].getsockname()[1]
        print(f"Serving TTS on http://{args.host}:{port} "
              f"(POST /tts, POST /tts-stream, GET /healthz, GET /stats)")
        async with http:
            await http.serve_forever()

    asyncio.run(main())
