"""Worlds of CPU ranks over gloo for the port's multi-rank tests
(tests/test_torch_parallel_*.py, tests/test_torch_cli.py).

`run_world(n, fn, payload, tmp_path)` spawns n processes; each joins a
gloo group (a `FileStore` under tmp_path, a 60 s timeout on every
collective), runs `fn(rank, n, payload)` with one intra-op thread and
sends back its result. A rank that fails, or a world that outlives its
limit, fails the test with every rank's traceback. Payloads and results
cross as numpy arrays and plain Python values.

This module imports no JAX: the JAX references run in the pytest process,
the ranks import only the port. The worker functions below are the ranks'
halves of the tests.
"""

from __future__ import annotations

import datetime
import json
import multiprocessing as mp
import queue
import time
import traceback
import uuid
from pathlib import Path
from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.distributed as dist

GROUP_TIMEOUT = datetime.timedelta(seconds=60)
WORLD_TIMEOUT = 240.0  # seconds a world may take, start-up included


def run_world(n: int, fn: Callable, payload: Any, tmp_path: Path,
              timeout: float = WORLD_TIMEOUT) -> List[Any]:
    """fn(rank, n, payload) on n spawned gloo ranks; their results in rank
    order."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = str(Path(tmp_path) / f"store-{uuid.uuid4().hex}")
    procs = [ctx.Process(target=_rank_main,
                         args=(rank, n, store, fn, payload, results),
                         daemon=True) for rank in range(n)]
    for p in procs:
        p.start()
    got: Dict[int, tuple] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < n and time.monotonic() < deadline:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    time.sleep(0.5)  # a dying rank's report may be in flight
                    if results.empty():
                        break
                continue
            got[rank] = (ok, value)
            if not ok:
                break  # the others would wait on it until their timeout
    finally:
        for p in procs:
            p.join(timeout=5)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    failed = [f"rank {r}:\n{v}" for r, (ok, v) in sorted(got.items())
              if not ok]
    missing = [r for r in range(n) if r not in got]
    if failed or missing:
        raise AssertionError(
            f"world of {n} ({getattr(fn, '__name__', fn)}) failed; no result "
            f"from ranks {missing} (exit codes "
            f"{[p.exitcode for p in procs]})\n" + "\n".join(failed))
    return [got[r][1] for r in range(n)]


def _rank_main(rank, n, store, fn, payload, results) -> None:
    try:
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, n), rank=rank, world_size=n,
            timeout=GROUP_TIMEOUT)
        try:
            out = fn(rank, n, payload)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the test
        results.put((rank, False, traceback.format_exc()))


# ---------------------------------------------------------------------------
# Shared pieces of the ranks
# ---------------------------------------------------------------------------


def numpy_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [numpy_tree(v) for v in tree]
    if torch.is_tensor(tree):  # a copy: the tensor may change after
        return (tree.detach().float() if tree.is_floating_point()
                else tree).numpy().copy()
    return tree


def torch_tree(tree: Any, dtype=None) -> Any:
    if isinstance(tree, dict):
        return {k: torch_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [torch_tree(v, dtype) for v in tree]
    t = torch.from_numpy(np.array(tree))
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def register_configs(payload: dict) -> None:
    """The port's copies of the test configs, registered by name."""
    from csm_mlx_tpu_torch import bridge

    bridge.register_llama_configs(backbone=payload.get("backbones", {}),
                                  decoder=payload.get("decoders", {}))


def port_model(payload: dict, params_key: str = "params"):
    from csm_mlx_tpu_torch.models.csm import CSM, ModelArgs

    register_configs(payload)
    return CSM(ModelArgs(*payload["model_args"]),
               params=torch_tree(payload[params_key]), dtype=torch.float32)


def adam(lr: float, eps: float):
    return lambda ps: torch.optim.Adam(ps, lr=lr, eps=eps)


def cpu_mesh(shape=None):
    from csm_mlx_tpu_torch.parallel import create_mesh

    return create_mesh(shape, devices="cpu")


# ---------------------------------------------------------------------------
# Trainers (tests/test_torch_parallel_train.py)
# ---------------------------------------------------------------------------


def _train_run(payload, mesh, sharding: str, out_dir: str, kind: str = "sft",
               steps=None, **extra):
    from csm_mlx_tpu_torch.finetune import trainer as ft

    model = port_model(payload)
    common = dict(model=model, optimizer=adam(payload["lr"], payload["eps"]),
                  output_dir=Path(out_dir), ckpt_freq=0, mesh=mesh,
                  param_sharding=sharding, max_norm=1.0, **extra)
    if kind == "kto":
        ref = port_model(payload, "ref_params")
        tr = ft.KTOTrainer(ft.KTOArgs(reference_model=ref, **common))
    elif kind == "dpo":
        tr = ft.DPOTrainer(ft.DPOArgs(**common))
    else:
        tr = ft.CSMTrainer(ft.TrainArgs(**common))
    losses = [tr.train_step(b) for b in (steps or payload["batches"])]
    return tr, losses


def _stored(tr) -> Dict[str, tuple]:
    """{name: (stored shape, numel)} of the trainable tensors and of their
    Adam moments."""
    out = {}
    for name, t in tr.trainable:
        st = tr.optimizer.state.get(t, {})
        out[name] = (tuple(t.shape), tuple(st["exp_avg"].shape)
                     if "exp_avg" in st else None)
    return out


def train_world(rank: int, n: int, payload: dict) -> dict:
    """The trainer cases of one world: data-parallel (replicated) SFT
    steps; with payload["more"] also a DPO step, FSDP steps with the
    lowered replicate threshold, a KTO step under FSDP (its reference
    sharded too), decoder_loss_fraction 0.5, and a checkpoint written
    under FSDP."""
    from csm_mlx_tpu_torch.loaders import tree_to_flat
    from csm_mlx_tpu_torch.parallel import mesh as mesh_mod

    tmp = Path(payload["tmp"])
    mesh = cpu_mesh()
    out: Dict[str, Any] = {}

    tr, losses = _train_run(payload, mesh, "replicated", tmp / f"dp{rank}")
    out["dp"] = dict(losses=losses, params=numpy_tree(tr.full_params()))
    if not payload["more"]:
        return out
    tr, losses = _train_run(payload, mesh, "replicated", tmp / f"dpo{rank}",
                            kind="dpo", steps=payload["dpo_batches"])
    out["dpo"] = dict(losses=losses)

    mesh_mod._FSDP_MIN_BYTES = payload["fsdp_min_bytes"]
    tr, losses = _train_run(payload, mesh, "fsdp", tmp / f"fsdp{rank}")
    out["fsdp"] = dict(losses=losses, params=numpy_tree(tr.full_params()),
                       stored=_stored(tr),
                       specs={k: tuple(v) for k, v in
                              tr.parallel.specs.items()})

    tr, losses = _train_run(payload, mesh, "fsdp", tmp / f"kto{rank}",
                            kind="kto", steps=payload["kto_batches"])
    ref = tree_to_flat(tr.reference_model.params)
    out["kto"] = dict(losses=losses, ref_shapes={k: tuple(v.shape)
                                                 for k, v in ref.items()})
    mesh_mod._FSDP_MIN_BYTES = 1 << 16

    tr, losses = _train_run(payload, mesh, "replicated", tmp / f"dlf{rank}",
                            decoder_loss_fraction=0.5)
    out["dlf"] = dict(losses=losses, params=numpy_tree(tr.full_params()))

    # checkpoints written by the FSDP world (both backends), resumed by one
    # rank after
    mesh_mod._FSDP_MIN_BYTES = payload["fsdp_min_bytes"]
    for backend in ("safetensors", "orbax"):
        ckpt_dir = Path(payload["ckpt_dir"]) / backend
        tr, losses = _train_run(payload, mesh, "fsdp", ckpt_dir,
                                checkpoint_backend=backend)
        tr.state.step = len(losses)
        tr.checkpointer.save()
        tr.checkpointer.wait()
        dist.barrier()  # rank 0's files are complete
        out[f"ckpt {backend}"] = dict(
            params=numpy_tree(tr.full_params()),
            opt={k: v.float().numpy()
                 for k, v in tr.checkpointer._opt_flat().items()},
            files=sorted(p.name for p in ckpt_dir.iterdir()))
    mesh_mod._FSDP_MIN_BYTES = 1 << 16
    return out


# ---------------------------------------------------------------------------
# Meshes and placements (tests/test_torch_parallel_mesh.py)
# ---------------------------------------------------------------------------


def mesh_world(rank: int, n: int, payload: dict) -> dict:
    """create_mesh's shapes and errors, the TP shards of shard_params (and
    its fallbacks), the FSDP specs and shards, shard_batch, and the 2-D
    pipe x data pipeline."""
    from csm_mlx_tpu_torch.parallel import (create_mesh, csm_param_spec,
                                            data_parallel_spec,
                                            fsdp_param_spec, shard_batch,
                                            shard_model, shard_params,
                                            shard_params_fsdp)
    from csm_mlx_tpu_torch.parallel import mesh as mesh_mod
    from csm_mlx_tpu_torch.parallel.mesh import axis_sizes

    out: Dict[str, Any] = {}
    m24 = cpu_mesh({"data": 2, "model": 4})
    m8 = cpu_mesh()
    out["shapes"] = [axis_sizes(m24), axis_sizes(m8),
                     axis_sizes(cpu_mesh({"pipe": 2, "data": 4}))]
    try:
        create_mesh({"data": 3}, devices="cpu")
    except ValueError as e:
        out["bad_shape"] = str(e)
    params = torch_tree(payload["params"])
    out["tp"] = numpy_tree(shard_params(params, m24, tensor_parallel=True))
    out["tp_specs"] = _spec_leaves(csm_param_spec(params))
    out["dataonly"] = numpy_tree(shard_params(params, m8))
    odd = torch_tree(payload["odd_params"])
    out["odd"] = numpy_tree(shard_params(odd, m24))
    mesh_mod._FSDP_MIN_BYTES = payload["fsdp_min_bytes"]
    out["fsdp_specs"] = _spec_leaves(fsdp_param_spec(params, m8))
    out["fsdp"] = numpy_tree(shard_params_fsdp(params, m8))
    mesh_mod._FSDP_MIN_BYTES = 1 << 16
    batch = torch_tree(payload["batch"])
    out["batch"] = numpy_tree(shard_batch(batch, m8))
    out["batch_np"] = shard_batch(payload["batch"], m8)
    out["batch_specs"] = _spec_leaves(data_parallel_spec(batch))

    class Holder:
        params = dict(torch_tree(payload["params"]),
                      _resident={"tables": torch.zeros(3)})

    # a data-only mesh: the serving placement (tests/
    # test_torch_parallel_serve.py) needs the model's configs
    out["model_keys"] = sorted(shard_model(Holder(), m8).params)
    out["pp_dp"] = pipeline_case(payload["pp_dp"], {"pipe": 2, "data": 4})
    try:  # a microbatch of 4 rows over data=8
        pipeline_case(payload["pp_dp"], {"pipe": 1, "data": 8})
    except ValueError as e:
        out["pp_bad"] = str(e)
    return out


def _spec_leaves(tree) -> Dict[str, tuple]:
    from csm_mlx_tpu_torch.parallel.mesh import map_tree

    flat: Dict[str, tuple] = {}
    map_tree(lambda path, s: flat.__setitem__(path, tuple(s)), tree)
    return flat


# ---------------------------------------------------------------------------
# Pipeline and ring attention (tests/test_torch_parallel_ops.py)
# ---------------------------------------------------------------------------


def pipeline_case(case: dict, shape: dict) -> dict:
    """One pipeline_forward case on a mesh of `shape`: the output, and with
    case["grad"] the gradients of sum(h ** 2) in the embeddings (on the
    first stage) and in this stage's stacked weights."""
    from csm_mlx_tpu_torch.config import BACKBONE_CONFIGURATION
    from csm_mlx_tpu_torch.models.llama import fuse_layer_weights
    from csm_mlx_tpu_torch.parallel import (pipeline_forward,
                                            shard_pipeline_params,
                                            stack_pipeline_params)
    from csm_mlx_tpu_torch.parallel.mesh import map_tree

    register_configs(case)
    cfg = BACKBONE_CONFIGURATION[case["cfg"]]
    mesh = cpu_mesh(shape)
    params = torch_tree(case["params"])
    if case.get("fused"):
        fuse_layer_weights(params)
    stacked = stack_pipeline_params(params["layers"], shape["pipe"])
    grad = case.get("grad")
    if grad == "weights":
        map_tree(lambda _, t: t.requires_grad_(True), stacked)
    x = torch_tree(case["x"]).requires_grad_(grad == "x")
    h = pipeline_forward(shard_pipeline_params(stacked, mesh), cfg, x,
                         torch_tree(case["cos"]), torch_tree(case["sin"]),
                         torch_tree(case["positions"]),
                         torch_tree(case["bias"]), mesh, case["n_micro"],
                         norm=params["norm"], remat=case.get("remat", False),
                         data_axis=case.get("data_axis"))
    out = {"h": numpy_tree(h)}
    if grad:
        (h ** 2).sum().backward()
    if grad == "x":
        out["dx"] = None if x.grad is None else numpy_tree(x.grad)
    elif grad == "weights":
        idx = mesh.get_local_rank("pipe")
        out["dw"] = map_tree(lambda _, t: t.grad[idx].numpy(), stacked)
    return out


def pipeline_dropout_case(case: dict, shape: dict) -> dict:
    """pipeline_forward over LoRA layers with live dropout (rate
    case["lora_dropout"] on q_proj and v_proj adapters), without and with
    remat, each under a generator of one seed: the outputs and this stage's
    gradients of sum(h ** 2) in its adapters and in the embeddings."""
    from csm_mlx_tpu_torch.config import BACKBONE_CONFIGURATION
    from csm_mlx_tpu_torch.ops.layers import lora_dropout_rng
    from csm_mlx_tpu_torch.parallel import (pipeline_forward,
                                            shard_pipeline_params,
                                            stack_pipeline_params)

    register_configs(case)
    cfg = BACKBONE_CONFIGURATION[case["cfg"]]
    mesh = cpu_mesh(shape)
    params = torch_tree(case["params"])
    stacked = stack_pipeline_params(params["layers"], shape["pipe"])
    gen = torch.Generator().manual_seed(case["seed"])
    adapters = []
    for name in ("q_proj", "v_proj"):
        lin = stacked["self_attn"][name]
        lead, (d_out, d_in) = lin["weight"].shape[:2], lin["weight"].shape[2:]
        lin["lora_a"] = 0.1 * torch.randn(*lead, 4, d_in, generator=gen)
        lin["lora_b"] = 0.1 * torch.randn(*lead, d_out, 4, generator=gen)
        lin["lora_dropout"] = torch.full(tuple(lead), case["lora_dropout"])
        adapters += [(f"{name}.lora_a", lin["lora_a"]),
                     (f"{name}.lora_b", lin["lora_b"])]
    out = {}
    for remat in (False, True):
        mine = shard_pipeline_params(stacked, mesh)
        leaves = [(k, mine["self_attn"][k.split(".")[0]][k.split(".")[1]]
                   .requires_grad_(True)) for k, _ in adapters]
        x = torch_tree(case["x"]).requires_grad_(True)
        with lora_dropout_rng(torch.Generator().manual_seed(case["seed"])):
            h = pipeline_forward(
                mine, cfg, x, torch_tree(case["cos"]),
                torch_tree(case["sin"]), torch_tree(case["positions"]),
                torch_tree(case["bias"]), mesh, case["n_micro"],
                norm=params["norm"], remat=remat)
            (h ** 2).sum().backward()
        out["remat" if remat else "plain"] = {
            "h": numpy_tree(h),
            "dx": None if x.grad is None else numpy_tree(x.grad),
            "dw": {k: numpy_tree(t.grad) for k, t in leaves}}
    return out


def ring_case(case: dict, n: int) -> dict:
    """ring_sdpa on this rank's blocks: its output block and, with
    case["grad"], its blocks of the gradients of sum(o ** 2)."""
    from csm_mlx_tpu_torch.parallel import ring_sdpa, shard_sequence

    mesh = cpu_mesh({"seq": n})
    dtype = torch.bfloat16 if case.get("bf16") else torch.float32
    q, k, v = (torch_tree(case[x]).to(dtype) for x in ("q", "k", "v"))
    ql, kl, vl = (shard_sequence(t, mesh).detach().requires_grad_(True)
                  for t in (q, k, v))
    o = ring_sdpa(ql, kl, vl, case["scale"], mesh)
    out = {"o": numpy_tree(o), "dtype": str(o.dtype)}
    if case.get("grad"):
        (o.float() ** 2).sum().backward()
        out["grads"] = [numpy_tree(t.grad) for t in (ql, kl, vl)]
    return out


def ops_world(rank: int, n: int, payload: dict) -> dict:
    out: Dict[str, Any] = {"ring": {}, "pipe": {}}
    for name, case in payload["ring"].items():
        out["ring"][name] = ring_case(case, n)
    try:
        from csm_mlx_tpu_torch.parallel import shard_sequence

        shard_sequence(torch.zeros(1, 1, payload["odd_len"], 4),
                       cpu_mesh({"seq": n}))
    except ValueError as e:
        out["odd_len"] = str(e)
    if "pipe_dropout" in payload:
        out["pipe_dropout"] = pipeline_dropout_case(payload["pipe_dropout"],
                                                    {"pipe": n})
    for name, case in payload["pipe"].items():
        out["pipe"][name] = pipeline_case(case, {"pipe": case["stages"]} if
                                          case["stages"] == n else
                                          {"pipe": case["stages"],
                                           "data": n // case["stages"]})
    return out


# ---------------------------------------------------------------------------
# The finetune commands (tests/test_torch_cli.py)
# ---------------------------------------------------------------------------


class FakeTokenizer:
    """The CLI tests' fake text tokenizer (tests/test_serve.py's encoding)
    whose `encode` also has `.ids`."""

    bos_token = "<b>"
    eos_token = "<e>"
    bos_token_id = 1
    eos_token_id = 2

    class _Ids(list):
        @property
        def ids(self):
            return list(self)

    def encode(self, text: str):
        return self._Ids([1] + [3 + (ord(c) % 50) for c in text[:10]] + [2])


def cli_world(rank: int, n: int, payload: dict) -> dict:
    """One `finetune` command on this rank's copy of the tiny model, the
    tiny codec installed as the CPU singleton and the fake tokenizer; the
    files each rank wrote (safetensors and JSON) recorded."""
    from csm_mlx_tpu_torch import safetensors_io
    from csm_mlx_tpu_torch import tokenizers as ttok
    from csm_mlx_tpu_torch.cli.application import build_parser
    from csm_mlx_tpu_torch.cli.finetune.common import make_mesh_if_requested
    from csm_mlx_tpu_torch.cli.finetune import full_finetune, lora_finetune
    from csm_mlx_tpu_torch.models.mimi import Mimi
    from csm_mlx_tpu_torch.parallel import mesh as mesh_mod

    written: List[str] = []
    save_file, dump = safetensors_io.save_file, json.dump

    def record_save(tensors, path, *a, **k):
        written.append(Path(path).name)
        return save_file(tensors, path, *a, **k)

    def record_dump(obj, f, *a, **k):
        written.append(Path(f.name).name)
        return dump(obj, f, *a, **k)

    safetensors_io.save_file, json.dump = record_save, record_dump
    mesh_mod._FSDP_MIN_BYTES = payload["fsdp_min_bytes"]
    mimi = Mimi(payload["codec"], device="cpu",
                generator=torch.Generator().manual_seed(payload["codec_seed"]))
    ttok._MIMI_CACHE[(payload["n_cb"], "cpu")] = (None, mimi)
    fake = FakeTokenizer()
    ttok.get_text_tokenizer = lambda path=None: fake
    model = port_model(payload)
    args = build_parser().parse_args(payload["argv"])
    module = lora_finetune if payload["argv"][1] == "lora" else full_finetune
    module.train(args, model,
                 mesh=make_mesh_if_requested(args, devices="cpu"))
    history = []
    state = Path(payload["out"]) / "trainer_state.json"
    if rank == 0:
        history = json.loads(state.read_text())["history"]
    return dict(written=written, history=history)


# ---------------------------------------------------------------------------
# Sharded serving (tests/test_torch_parallel_serve.py)
# ---------------------------------------------------------------------------


def _serving_setup(payload: dict):
    """The fake text tokenizer and the tiny codec as this rank's CPU
    singletons, as the parent installs them."""
    from csm_mlx_tpu_torch import tokenizers as ttok
    from csm_mlx_tpu_torch.models.mimi import Mimi

    mimi = Mimi(payload["codec"], device="cpu",
                generator=torch.Generator().manual_seed(payload["codec_seed"]))
    ttok._MIMI_CACHE[(payload["n_cb"], "cpu")] = (None, mimi)
    fake = FakeTokenizer()
    ttok.get_text_tokenizer = lambda path=None: fake


def serving_model(payload: dict, mesh, kind: str = "f32"):
    """The tiny model on this rank: "f32", "bf16" or "w8a8" (quantized
    here, as the parent quantizes its copy), placed on `mesh`."""
    from csm_mlx_tpu_torch.ops.quant import quantize_model
    from csm_mlx_tpu_torch.parallel import shard_model

    model = port_model(payload)
    if kind == "bf16":
        model.params = torch_tree(payload["params"], torch.bfloat16)
        model.dtype = torch.bfloat16
    elif kind == "w8a8":
        quantize_model(model, mode="w8a8", min_size=1)
    return shard_model(model, mesh)


def _batch_frames(model, payload, mesh, key: str = "prompts") -> dict:
    from csm_mlx_tpu_torch.generation import generate_tokens_batch

    prompts = payload[key]
    frames, n = generate_tokens_batch(
        model, prompts, [np.ones_like(p) for p in prompts],
        payload["n_frames"], temperature=0.0, mesh=mesh)
    return dict(frames=frames, n=n)


def _engine_streams(model, payload, mesh, case: dict) -> Any:
    """case["requests"] through a ContinuousEngine on `mesh`: rank 0's
    (tokens, audio) per request; the other ranks follow."""
    from csm_mlx_tpu_torch.continuous import ContinuousEngine

    eng = ContinuousEngine(
        model, n_slots=case["n_slots"], max_frames=12, max_prompt_bucket=32,
        capacity_slack=16, frames_per_step=3, codec=case.get("codec", False),
        quantize_codec=case.get("quantize_codec", False), mesh=mesh,
        generator=torch.Generator().manual_seed(7))
    if dist.get_rank() != 0:
        eng.follow()
        return None
    handles = [eng.submit_prompt(p, np.ones_like(p), max_frames=mf)
               for p, mf in case["requests"]]
    eng.run_until_idle()
    eng.stop()
    return [(h.wait(0), h.audio() if eng.has_codec else None)
            for h in handles]


def _tp_in_case(payload: dict, tp) -> dict:
    """The in-sharded W8A8 linear of this rank's column shard against the
    solo kernel: its output, and its int32 partials summed."""
    from csm_mlx_tpu_torch.ops import quant, tensor_parallel

    w, x = torch_tree(payload["tp_in_w"]), torch_tree(payload["tp_in_x"])
    q = quant.quantize_weight_w8(w)
    step = w.shape[1] // tp.size
    lo = tp.rank * step
    local = {k: (v[:, lo:lo + step].contiguous() if k == "weight_q" else v)
             for k, v in q.items()}
    with tensor_parallel.scope(tp):
        y = tensor_parallel.linear_in(local, x[:, lo:lo + step])
        qx, _ = quant.w8a8_quant_rows(x)
        p = tensor_parallel.all_reduce(
            quant.w8a8_partial(qx, lo, local["weight_q"]))
    return dict(y=y.numpy(), p=p.numpy())


def _tables_case(model, payload) -> dict:
    """The vocabulary-sharded embeddings and heads of a sharded model."""
    from csm_mlx_tpu_torch.models.csm import (codebook0_logits,
                                              masked_input_embeds)
    from csm_mlx_tpu_torch.ops import tensor_parallel
    from csm_mlx_tpu_torch.ops.quant import audio_head_logits

    tokens = torch_tree(payload["tokens"]).long()
    hidden = torch_tree(payload["hidden"])
    hidden_d = torch_tree(payload["hidden_d"])
    args = model.args
    with tensor_parallel.scope(tensor_parallel.of(model)):
        return dict(
            embeds=masked_input_embeds(model.params, args, tokens,
                                       torch.ones_like(tokens)).numpy(),
            c0=codebook0_logits(model.params, args, hidden).numpy(),
            head=audio_head_logits(model.params["audio_head"], 2, hidden_d,
                                   args.n_audio_vocab).numpy(),
            local_rows=int(model.params["text_embeddings"]["weight"]
                           .shape[0]))


async def _ask_servers(tts, cont, payload) -> dict:
    """Rank 0: the lockstep server's batch and stream, the continuous
    server's requests."""
    import asyncio

    texts = payload["texts"]
    out = {}
    await tts.start()
    out["tts"] = await asyncio.gather(*[tts.synthesize(t, 0)
                                        for t in texts])
    out["stream"] = [c async for c in tts.synthesize_stream(texts[0], 0)]
    await tts.stop()
    await cont.start()
    out["continuous"] = await asyncio.gather(*[cont.synthesize(t, 0)
                                               for t in texts])
    await cont.stop()
    return out


def _sampled_case(payload: dict, mesh, rank: int) -> dict:
    """A sampled run (T = 0.8) on a model axis: with one generator seed on
    every rank its frames, with a seed a rank the error every rank
    raises."""
    from csm_mlx_tpu_torch.generation import generate_tokens

    model = serving_model(payload, mesh)
    p = payload["prompts"][0]
    out = {}
    for label, seed in (("same", 11), ("apart", 11 + rank)):
        try:
            out[label] = generate_tokens(
                model, p, np.ones_like(p), 4, temperature=0.8, mesh=mesh,
                generator=torch.Generator().manual_seed(seed))[0]
        except RuntimeError as e:
            out[label] = str(e)
    return out


def _cli_case(payload: dict, mesh_arg: str) -> Any:
    """`serve --mesh` over this world: rank 0 answers one POST /tts."""
    import asyncio

    from csm_mlx_tpu_torch.cli.application import build_parser
    from csm_mlx_tpu_torch.cli.serve import serve_model

    args = build_parser().parse_args(
        ["serve", "--mesh", mesh_arg, "--port", "0", "--temperature", "0",
         "--max-audio-length", "320", "--max-wait-ms", "1", "--transfer",
         "float32"])
    got = {}

    async def ask(port):
        body = json.dumps({"text": payload["texts"][1], "speaker": 0})
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write((f"POST /tts HTTP/1.1\r\nHost: x\r\nContent-Length: "
                      f"{len(body)}\r\n\r\n{body}").encode())
        await writer.drain()
        got["reply"] = await reader.read()
        writer.close()

    serve_model(args, port_model(payload), devices="cpu", until=ask)
    return got.get("reply")


def serve_world(rank: int, n: int, payload: dict) -> dict:
    """The sharded-serving cases of one world (payload["cases"] names
    them): generation on each of payload["meshes"], the engine, the W8A8
    in-sharded linear, the vocabulary tables, the servers and the CLI."""
    from csm_mlx_tpu_torch.ops import tensor_parallel
    from csm_mlx_tpu_torch.serve import ContinuousTTSServer, TTSServer

    _serving_setup(payload)
    register_configs(payload)
    out: Dict[str, Any] = {}
    for name, shape in payload["meshes"].items():
        mesh = cpu_mesh(shape)
        for kind in payload["kinds"].get(name, ()):
            model = serving_model(payload, mesh, kind)
            got = _batch_frames(model, payload, mesh)
            if kind == "f32":
                from csm_mlx_tpu_torch.generation import generate_tokens

                p = payload["prompts"][0]
                got["single"] = generate_tokens(
                    model, p, np.ones_like(p), 3, temperature=0.0,
                    mesh=mesh)[0]
                if name in payload.get("tables", ()):
                    out[f"tables {name}"] = _tables_case(model, payload)
                if name in payload.get("capture", ()):
                    try:
                        tensor_parallel.check_capture(
                            tensor_parallel.of(model), mesh, "eager=True")
                    except ValueError as e:
                        got["capture"] = str(e)
            out[f"{name} {kind}"] = got
        for case in payload["engines"].get(name, ()):
            model = serving_model(payload, mesh, case["kind"])
            out[f"engine {name} {case['label']}"] = _engine_streams(
                model, payload, mesh, case)
        if name in payload.get("tp_in", ()):
            out[f"tp_in {name}"] = _tp_in_case(
                payload, tensor_parallel.TensorParallel(
                    mesh.get_group("model"), shape["model"],
                    mesh.get_local_rank("model")))
        if name in payload.get("sampled", ()):
            out[f"sampled {name}"] = _sampled_case(payload, mesh, rank)
        if name in payload.get("follower", ()) and rank != 0:
            from csm_mlx_tpu_torch.continuous import ContinuousEngine

            model = serving_model(payload, mesh)
            eng = ContinuousEngine(model, n_slots=2, max_frames=4,
                                   max_prompt_bucket=32, capacity_slack=8,
                                   codec=False, mesh=mesh,
                                   generator=torch.Generator().manual_seed(7))
            try:
                eng.submit_prompt(payload["prompts"][0],
                                  np.ones_like(payload["prompts"][0]))
            except RuntimeError as e:
                out["follower submit"] = str(e)
        if name in payload.get("servers", ()):
            import asyncio

            model = serving_model(payload, mesh)
            kw = dict(max_audio_length_ms=400, temperature=0.0)
            tts = TTSServer(model, max_wait_ms=300, mesh=mesh, **kw)
            cont = ContinuousTTSServer(model, n_slots=4,
                                       max_prompt_bucket=32, mesh=mesh, **kw)
            if rank == 0:
                out[f"servers {name}"] = asyncio.run(
                    _ask_servers(tts, cont, payload))
            else:
                tts.follow()
                cont.follow()
        if name in payload.get("cli", ()):
            out[f"cli {name}"] = _cli_case(payload, payload["cli"][name])
    return out
