"""`serve` — the TTS HTTP server (port of `csm_mlx_tpu/cli/serve.py`),
lockstep (`serve.TTSServer`) or, with `--continuous`, over the continuous
engine (`serve.ContinuousTTSServer`). The flags and defaults are the JAX
CLI's. Weights and adapters are local paths.

`--mesh data=2,model=4` serves across GPUs, one process a card under
`torchrun --nproc-per-node N -m csm_mlx_tpu_torch serve --mesh ...`: each
rank loads the model, `parallel.create_mesh` joins the NCCL group from
torchrun's environment, `parallel.shard_model` keeps the rank's shards,
and rank 0 binds the port while every other rank follows it
(`TTSServer.follow`, `ContinuousTTSServer.follow`)."""

from __future__ import annotations

import argparse
from datetime import timedelta

# how long a follower rank waits for rank 0's next request
FOLLOWER_TIMEOUT = timedelta(days=365)


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
                   help="Continuous mode: decode through an int8 copy of "
                        "the Mimi decoder")
    p.add_argument("--slots", type=int, default=64,
                   help="Continuous mode: concurrent generation slots "
                        "(default: kernel 3's rows a launch)")
    p.add_argument("--mesh", default=None, metavar="AXES",
                   help="Multi-card serving under torchrun: mesh axes as "
                        "'data=2,model=4' (sizes multiply to the world "
                        "size). Shards the model over 'model' and request "
                        "rows / slots over 'data'; with --quantize the "
                        "W8A8 linears run per shard (the whole-frame "
                        "decoder kernel is dropped)")
    p.set_defaults(func=run)


def parse_mesh_argument(spec: str) -> "dict[str, int]":
    """'data=2,model=4' -> {"data": 2, "model": 4} (axis order preserved —
    it defines the device layout; "model" innermost)."""
    axes: dict = {}
    for part in spec.split(","):
        name, _, size = part.partition("=")
        name = name.strip()
        if not name or not size.strip().isdigit() or int(size) < 1:
            raise ValueError(
                f"bad mesh axis {part!r} in --mesh {spec!r}; expected "
                f"NAME=SIZE pairs like 'data=2,model=4'")
        if name in axes:
            raise ValueError(
                f"duplicate mesh axis {name!r} in --mesh {spec!r}")
        axes[name] = int(size.strip())
    return axes


def make_server(args: argparse.Namespace, csm, mesh=None):
    """The server the flags ask for, over a loaded (and, with `mesh`,
    sharded) model."""
    from csm_mlx_tpu_torch.serve import ContinuousTTSServer, TTSServer

    if args.continuous:
        return ContinuousTTSServer(
            csm, n_slots=args.slots,
            max_audio_length_ms=args.max_audio_length,
            temperature=args.temperature, watermark_key=args.watermark_key,
            max_pending=args.max_pending, transfer=args.transfer,
            quantize_codec=args.quantize_codec, mesh=mesh)
    return TTSServer(
        csm, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        max_audio_length_ms=args.max_audio_length,
        temperature=args.temperature, watermark_key=args.watermark_key,
        transfer=args.transfer, max_pending=args.max_pending, mesh=mesh)


def serve_model(args: argparse.Namespace, csm, devices=None,
                until=None) -> None:
    """Serve a loaded model as the flags ask: with `--mesh`, on a mesh
    over the default process group's ranks (`devices` as in
    `parallel.create_mesh`), the model sharded, rank 0 binding the port
    and every other rank following it. `until`: an async function of the
    bound port; the server stops when it returns (None: serve for ever)."""
    import asyncio

    from csm_mlx_tpu_torch.serve import serve_http

    mesh = None
    if args.mesh:
        import torch.distributed as dist

        from csm_mlx_tpu_torch.parallel import create_mesh, shard_model
        from csm_mlx_tpu_torch.parallel.mesh import _init_group

        if not dist.is_initialized():
            # the followers wait in a broadcast for rank 0's next request,
            # for as long as the server is idle
            _init_group(devices == "cpu", timeout=FOLLOWER_TIMEOUT)
        try:
            mesh = create_mesh(parse_mesh_argument(args.mesh), devices)
        except ValueError as e:
            raise SystemExit(f"csm-torch serve: {e}")
        shard_model(csm, mesh)
    server = make_server(args, csm, mesh)
    if mesh is not None and mesh.get_rank() != 0:
        server.follow()
        return

    async def main():
        http = await serve_http(server, host=args.host, port=args.port)
        port = http.sockets[0].getsockname()[1]
        print(f"Serving TTS on http://{args.host}:{port} "
              f"(POST /tts, POST /tts-stream, GET /healthz, GET /stats)")
        try:
            async with http:
                if until is None:
                    await http.serve_forever()
                else:
                    await until(port)
        finally:
            await server.stop()  # under a mesh, the followers leave too

    asyncio.run(main())


def run(args: argparse.Namespace) -> None:
    from csm_mlx_tpu_torch.cli.config import MODEL
    from csm_mlx_tpu_torch.cli.generate import (parse_adapter_argument,
                                                parse_weight_argument)

    if args.mesh:
        try:
            parse_mesh_argument(args.mesh)
        except ValueError as e:
            raise SystemExit(f"csm-torch serve: {e}")
    if args.quantize_codec and not args.continuous:
        raise SystemExit(
            "csm-torch serve: --quantize-codec requires --continuous "
            "(the lockstep server decodes through the shared f32 codec)")
    weight = parse_weight_argument(args.weight)
    adapter = parse_adapter_argument(args.adapter)

    from csm_mlx_tpu_torch.device import resolve_device
    from csm_mlx_tpu_torch.finetune.lora import load_adapters
    from csm_mlx_tpu_torch.loaders import load_csm_weights
    from csm_mlx_tpu_torch.models.csm import CSM
    from csm_mlx_tpu_torch.ops.quant import quantize_model

    if args.mesh:
        import os

        import torch

        # each rank loads onto its own card (torchrun's LOCAL_RANK)
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    print("Loading model...")
    csm = CSM(MODEL[args.model]["config"],
              params=load_csm_weights(weight, device=resolve_device()))
    if adapter is not None:
        load_adapters(csm, adapter)
    if args.quantize:
        quantize_model(csm, mode="w8a8")
    serve_model(args, csm)
