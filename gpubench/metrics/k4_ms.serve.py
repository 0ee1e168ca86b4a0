"""Device ms of kernel 4 (`ops.attention.flash_decode_sdpa`,
`csrc/flash_decode.cu`) in one replayed engine block, averaged over the
complete blocks of the traced stretch. Nothing unless every complete block
holds a kernel-4 call in each attention layer (`arch.load(config)
.attention_layers`) of each of its backbone steps: a call is one fused
`flash_decode_kernel` launch or, where the cache is split over blocks, a
scores pass, a values pass and a `flash_decode_merge_kernel`, so a block's
calls are its passes less its merges."""

from gpubench import arch, trace
from gpubench.metrics_common import replays

PASSES = ("flash_decode_kernel",)
MERGES = ("flash_decode_merge_kernel",)


def read(layer: dict):
    reps = replays(layer)
    if not reps:
        return None
    cfg = layer["config"]
    layers = arch.load(cfg).attention_layers(cfg["backbone"])
    ms = 0.0
    for ks, frames in reps:
        passes, merges = trace.named(ks, *PASSES), trace.named(ks, *MERGES)
        if len(passes) - len(merges) != layers * frames:
            return None
        ms += sum(e["dur"] for e in passes + merges) / 1e3
    return ms / len(reps)
