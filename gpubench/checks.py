"""What decides `correct`: the served requests held to the plain reference.

After the window, with the system's state freed, a sample of the finished
greedy requests drawn from the seed (the longest of them always in it, and
one with conversational context where any was served) is run through the
reference once, teacher-forced on the served tokens:

- token_gap: the widest gap by which a served token's logit lies below
  the reference's best logit at its position (codebook 0 from the backbone,
  codebooks 1..31 from the decoder), over every token of the sample;
- audio_err: the largest difference between a request's delivered audio
  and the reference decode of its served frames, over the largest
  magnitude of that decode, over the sample.

The control puts the reference in the system's place one precision lower:
int4 weights for the configuration's int8 (the gap of the token the
int4 model puts first), and TF32 for the codec's fp32.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from gpubench import weights
from gpubench.reference import mimi as mimi_ref
from gpubench.reference.csm import CSMReference, no_tf32, token_gaps

# requests compared a run
SAMPLE_REQUESTS = 12


def sample(served: List[dict], seed: int,
           n: int = SAMPLE_REQUESTS) -> List[dict]:
    """Up to n finished greedy requests: the one with the most frames, one
    with conversational context where any was served (its longer prompt
    takes another path through the prefill), and the rest drawn from the
    seed."""
    pool = [r for r in served if r["greedy"] and len(r["frames"]) > 0]
    if not pool:
        return []
    longest = max(range(len(pool)), key=lambda i: len(pool[i]["frames"]))
    rest = [i for i in range(len(pool)) if i != longest]
    rng = np.random.default_rng([int(seed) % (1 << 64), 7])
    order = list(rng.permutation(rest))
    pick = order[:max(n - 1, 0)]
    if not any(pool[i].get("context") for i in [longest] + pick):
        with_context = [i for i in order if pool[i].get("context")]
        if with_context and pick:
            pick[-1] = with_context[0]
    return [pool[i] for i in [longest] + sorted(pick)]


def readings(config: dict, seed: int, picked: List[dict], device,
             control: bool = False) -> Dict[str, Optional[float]]:
    """The compared numbers (and with `control`, the control's) over the
    picked requests, each request a dict with "prompt", "mask", "frames"
    (F, K), "audio" (F * frame_size,) and, where it had conversational
    context, "segments" (text rows, mask, audio) before its prompt."""
    out: Dict[str, Optional[float]] = {"token_gap": None, "audio_err": None,
                                       "tokens": 0}
    if not picked:
        return out
    mp = weights.mimi_params(config, seed, device,
                             encoder=any(r.get("segments") for r in picked))
    with no_tf32():
        prompts = [_prompt(r, mp, config, device) for r in picked]
    params = weights.csm_params(config, seed, device,
                                getattr(torch, config.get("dtype",
                                                          "bfloat16")))
    gaps, ctl_gaps = [], []
    with no_tf32():
        ref8 = CSMReference(params, config, bits=8)
        ref4 = CSMReference(params, config, bits=4) if control else None
        del params
        for r, (prompt, mask) in zip(picked, prompts):
            lg = ref8.logits(prompt, mask, r["frames"], device)
            gaps.append(float(token_gaps(lg, r["frames"]).max()))
            out["tokens"] += int(np.asarray(r["frames"]).size)
            if ref4 is not None:
                lg4 = ref4.logits(prompt, mask, r["frames"], device)
                ctl_gaps.append(float(token_gaps(lg, r["frames"],
                                                 lg4).max()))
    del ref8, ref4
    out["token_gap"] = max(gaps)
    if control:
        out["control_token_gap"] = max(ctl_gaps)
    errs, ctl_errs = [], []
    for r in picked:
        codes = torch.from_numpy(np.asarray(r["frames"], np.int64).T[None]
                                 .copy()).to(device)
        with no_tf32():
            want = mimi_ref.decode(mp, config["mimi"], codes)[0, 0]
        errs.append(_rel_err(r["audio"], want))
        if control:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            try:
                tf32 = mimi_ref.decode(mp, config["mimi"], codes)[0, 0]
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
            ctl_errs.append(_rel_err(tf32.cpu().numpy(), want))
    out["audio_err"] = max(errs)
    if control:
        out["control_audio_err"] = max(ctl_errs)
    return out


def _prompt(r: dict, mp: dict, config: dict, device):
    """The request's whole prompt as the reference works it out: each
    context segment's text rows, then the reference encoder's codes of its
    audio, one row a frame, and the all-zero end-of-audio row (audio columns
    masked in); then the request's own rows."""
    k = config["audio_num_codebooks"]
    rows, masks = [], []
    for text, tmask, audio in r.get("segments") or ():
        codes = mimi_ref.encode(mp, config["mimi"], torch.from_numpy(
            np.asarray(audio, np.float32))[None, None].to(device))[0]
        f = codes.shape[1] + 1
        frame = np.zeros((f, k + 1), np.int32)
        frame[:-1, :-1] = codes.T.cpu().numpy()
        mask = np.zeros((f, k + 1), np.int32)
        mask[:, :-1] = 1
        rows += [text, frame]
        masks += [tmask, mask]
    return (np.concatenate(rows + [r["prompt"]]).astype(np.int32),
            np.concatenate(masks + [r["mask"]]).astype(np.int32))


def _rel_err(got, want: torch.Tensor) -> float:
    w = want.float().cpu().numpy()
    g = np.asarray(got, np.float32)
    if g.shape != w.shape:
        return float("inf")
    return float(np.abs(g - w).max() / max(float(np.abs(w).max()), 1e-12))
