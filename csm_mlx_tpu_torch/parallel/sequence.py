"""Ring attention: sequence parallelism over a "seq" mesh axis (port of
`csm_mlx_tpu/parallel/sequence.py`).

Each rank holds its (B, H, S/n, D) block of Q, K and V. Over n ring steps
it attends its queries to the K/V block that started on rank
(idx - r) mod n while that block travels on to the next rank
(`batch_isend_irecv` over the axis's group, K and V in one message). The
softmax is the online (flash) update in fp32, so the result is exact, with
(S/n, S/n) logits a step. Causality is by block origin: block j adds to
block i iff j <= i, the diagonal block masked elementwise. A fully future
block contributes nothing: JAX where-masks it (an SPMD program cannot skip
a step), each rank here skips its arithmetic, which is the same result,
and passes it on all the same.

Gradients come from `_RingAttention.backward`: with the logsumexp saved
by the forward, dq stays on its rank while each block's dk and dv travel
the ring with it, gather every rank's share and arrive back at the block's
owner (n - 1 hops with K and V, one more with dk and dv alone).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from csm_mlx_tpu_torch.ops.attention import NEG_INF
from csm_mlx_tpu_torch.parallel.mesh import P, axis_sizes, local_shard


class _Ring:
    """The axis's group as a ring: send to the next rank, receive from the
    previous one."""

    def __init__(self, mesh: DeviceMesh, axis: str):
        self.group = mesh.get_group(axis)
        self.n = axis_sizes(mesh)[axis]
        self.idx = mesh.get_local_rank(axis)
        self.next = dist.get_global_rank(self.group, (self.idx + 1) % self.n)
        self.prev = dist.get_global_rank(self.group, (self.idx - 1) % self.n)

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        """x sent to the next rank; returns the previous rank's x."""
        got = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x.contiguous(), self.next, self.group),
               dist.P2POp(dist.irecv, got, self.prev, self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return got


def _block_logits(qg: torch.Tensor, k: torch.Tensor, scale: float,
                  ok: torch.Tensor) -> torch.Tensor:
    logits = torch.einsum("bkgqd,bkld->bkgql", qg, k.float()) * scale
    return torch.where(ok, logits, NEG_INF)


def _positions(idx: int, s_loc: int, device) -> torch.Tensor:
    return idx * s_loc + torch.arange(s_loc, device=device)


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, scale: float, ring: _Ring):
        b, n_heads, s_loc, d = q.shape
        n_kv = k.shape[1]
        group = n_heads // n_kv
        qg = q.reshape(b, n_kv, group, s_loc, d).float()
        q_pos = _positions(ring.idx, s_loc, q.device)
        m = torch.full((b, n_kv, group, s_loc, 1), NEG_INF,
                       dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, n_kv, group, s_loc, d), dtype=torch.float32,
                          device=q.device)
        kv = torch.stack([k, v])
        for r in range(ring.n):
            src = (ring.idx - r) % ring.n
            if r < ring.n - 1:
                nxt = ring.shift(kv)
            if src <= ring.idx:  # a future block adds nothing
                ok = _positions(src, s_loc, q.device)[None, :] <= \
                    q_pos[:, None]
                logits = _block_logits(qg, kv[0], scale, ok)
                m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
                p = torch.where(ok, torch.exp(logits - m_new), 0.0)
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + torch.einsum("bkgql,bkld->bkgqd", p,
                                                kv[1].float())
                m = m_new
            if r < ring.n - 1:
                kv = nxt
        out = acc / torch.clamp(l, min=1e-30)
        lse = m + torch.log(torch.clamp(l, min=1e-30))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.ring = scale, ring
        return out.reshape(b, n_heads, s_loc, d).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        scale, ring = ctx.scale, ctx.ring
        b, n_heads, s_loc, d = q.shape
        n_kv = k.shape[1]
        group = n_heads // n_kv
        qg = q.reshape(b, n_kv, group, s_loc, d).float()
        dog = dout.reshape(b, n_kv, group, s_loc, d).float()
        delta = (dog * out).sum(-1, keepdim=True)
        q_pos = _positions(ring.idx, s_loc, q.device)
        dq = torch.zeros_like(qg)
        # K, V, dK, dV of the block held, fp32 sums travelling with it
        kv = torch.stack([k, v])
        dkv = torch.zeros((2,) + tuple(k.shape), dtype=torch.float32,
                          device=k.device)
        for r in range(ring.n):
            src = (ring.idx - r) % ring.n
            if src <= ring.idx:
                ok = _positions(src, s_loc, q.device)[None, :] <= \
                    q_pos[:, None]
                kf, vf = kv[0].float(), kv[1].float()
                logits = _block_logits(qg, kv[0], scale, ok)
                p = torch.where(ok, torch.exp(logits - lse), 0.0)
                dkv[1] += torch.einsum("bkgql,bkgqd->bkld", p, dog)
                dp = torch.einsum("bkgqd,bkld->bkgql", dog, vf)
                ds = p * (dp - delta)
                dq += torch.einsum("bkgql,bkld->bkgqd", ds, kf) * scale
                dkv[0] += torch.einsum("bkgql,bkgqd->bkld", ds, qg) * scale
            if r < ring.n - 1:
                kv = ring.shift(kv)
            if ring.n > 1:  # the last hop brings each block's sums home
                dkv = ring.shift(dkv)
        return (dq.reshape(q.shape).to(q.dtype), dkv[0].to(k.dtype),
                dkv[1].to(v.dtype), None, None)


def ring_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, mesh: DeviceMesh, axis: str = "seq"
              ) -> torch.Tensor:
    """Causal GQA attention with the sequence sharded over `axis`.

    q: (B, n_heads, S/n, D), k and v: (B, n_kv, S/n, D): this rank's
    blocks (`shard_sequence`), block idx holding positions
    idx*S/n .. (idx+1)*S/n - 1. Returns this rank's (B, n_heads, S/n, D)
    block of the output, in q's dtype. Exact (online softmax): matches
    `ops.attention.sdpa` with a causal mask. Differentiable in q, k and v.
    A length that the axis does not divide raises in `shard_sequence`,
    where JAX's `ring_sdpa` raises it.
    """
    if q.shape[2] == 0 or k.shape[2] != q.shape[2] or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} are not blocks of one sequence")
    return _RingAttention.apply(q, k, v, float(scale), _Ring(mesh, axis))


def shard_sequence(x: torch.Tensor, mesh: DeviceMesh, axis: str = "seq",
                   dim: int = 2) -> torch.Tensor:
    """This rank's block of `x` with dim `dim` sharded over `axis`; the
    length must divide by the axis, as JAX requires."""
    n = axis_sizes(mesh)[axis]
    if x.shape[dim] % n != 0:
        raise ValueError(f"sequence {x.shape[dim]} not divisible by "
                         f"{axis}={n}")
    return local_shard(x, P(*(axis if i == dim else None
                               for i in range(x.ndim))), mesh)
