"""Window-level context parallelism: ring attention over a ``seq`` mesh axis.

Port of ``imagined_speech_translation_tpu.parallel.context``.  The JAX
function shards the time axis of ``(B, H, S, D)`` over a mesh axis with
``shard_map``: each device keeps its ``S / n`` query block and the K/V blocks
travel around the ring (``lax.ppermute``) while an online-softmax carry
(max, sum of exponentials, weighted V, all float32) folds each one in; the
loop's transpose gives the backward.  Here the ranks of the mesh's ``seq``
axis form the ring and the blocks travel by point-to-point send and receive:

* forward: rank ``i`` keeps query block ``i``; K, V and the key validity
  rotate ``n - 1`` times to the next rank; the carry is JAX's, including its
  all-masked guards; the output block and its logsumexp are kept;
* backward: K and V rotate again, and each block's dK and dV accumulators
  travel with it, one step further, back to the block's owner.

The rest of the model runs replicated on the seq ranks, which is the layout
GSPMD gives without further annotations, so :func:`ring_attention` takes the
whole ``(B, H, S, D)`` on every rank, computes its own block and all-gathers
the output.  The gradients of q, k and v come out whole and equal on every
seq rank, so the seq axis needs no gradient all-reduce.

Each block's products are ``torch.matmul`` in float32, as JAX computes them
with ``jnp.einsum`` outside any Pallas kernel.  There is no attention-prob
dropout on this path, as in JAX (``models.layers.MultiHeadAttention`` does
not apply it when ``seq_shards > 1``).

The blocks travel as one float32 buffer per step.  Under NCCL they are
device tensors, sent with ``batch_isend_irecv``; gloo sends host tensors
only, so under gloo a CUDA block is staged through pinned host memory.  The
send and the receive of a step are posted together.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from .tensor_parallel import all_gather


class _State:
    mesh = None


@contextlib.contextmanager
def context_mesh(mesh):
    """Expose ``mesh`` to model code run inside this block:
    ``RegionEncoderConfig.seq_shards > 1`` routes the region encoder's token
    attention through :func:`ring_attention` over its ``seq_axis``.  The mesh
    is process-wide, not per thread (JAX's is per thread): a checkpoint's
    recompute runs on the autograd engine's thread."""
    prev = _State.mesh
    _State.mesh = mesh
    try:
        yield mesh
    finally:
        _State.mesh = prev


def get_context_mesh():
    """The mesh installed by :func:`context_mesh`, or None."""
    return _State.mesh


class _Ring:
    """This rank's place on the ring: index ``idx`` of ``n`` over the global
    ranks ``members``, reduced over ``group``."""

    def __init__(self, mesh, axis: str):
        self.members = mesh.members(axis)
        self.n = len(self.members)
        self.idx = mesh.coords()[axis]
        self.group = mesh.group(axis)
        self.next = self.members[(self.idx + 1) % self.n]
        self.prev = self.members[(self.idx - 1) % self.n]

    def rotate(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """Send ``tensors`` to the next rank and take the previous rank's,
        of the same shapes and dtypes."""
        flat = torch.cat([t.float().reshape(-1) for t in tensors])
        staged = flat.is_cuda and dist.get_backend(self.group) == "gloo"
        if staged:
            flat = torch.empty(flat.shape, pin_memory=True).copy_(flat)
        recv = torch.empty_like(flat)
        ops = [dist.P2POp(dist.isend, flat, self.next, self.group),
               dist.P2POp(dist.irecv, recv, self.prev, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if staged:
            recv = recv.to(tensors[0].device, non_blocking=True)
        out, offset = [], 0
        for t in tensors:
            out.append(recv[offset:offset + t.numel()].view(t.shape).to(t.dtype))
            offset += t.numel()
        return out


def _scores(qb, kb, validb, scale):
    s = torch.matmul(qb, kb.float().transpose(-1, -2)) * scale
    if validb is not None:
        s = s.masked_fill(~validb[None, None, None, :], float("-inf"))
    return s


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_valid, ring, scale):
        n, idx = ring.n, ring.idx
        s_loc = q.shape[-2] // n
        blk = slice(idx * s_loc, (idx + 1) * s_loc)
        qb = q[..., blk, :].float()
        kb, vb = k[..., blk, :].contiguous(), v[..., blk, :].contiguous()
        validb = None if kv_valid is None else kv_valid[blk]
        masked = validb is not None
        b, h, _, d = qb.shape
        m = qb.new_full((b, h, s_loc), float("-inf"))
        l = qb.new_zeros((b, h, s_loc))
        acc = qb.new_zeros((b, h, s_loc, v.shape[-1]))
        for step in range(n):
            s = _scores(qb, kb, validb, scale)
            m_new = torch.maximum(m, s.amax(dim=-1))
            if masked:
                # a block with no valid key keeps m at -inf: shift by a
                # finite stand-in and zero the contributions explicitly
                m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
                p = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]), 0.0)
                corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            else:
                p = torch.exp(s - m_new[..., None])
                corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.matmul(p, vb.float())
            m = m_new
            if step < n - 1:
                kb, vb, *rest = ring.rotate([kb, vb] + ([validb] if masked else []))
                validb = rest[0] if masked else None
        # every query sees a valid key (padding is keys-only), so l > 0; the
        # maximum only guards the all-masked degenerate call
        out = acc / torch.clamp_min(l, 1e-37)[..., None]
        lse = torch.where(l > 0, m + torch.log(torch.clamp_min(l, 1e-37)), float("-inf"))
        ctx.save_for_backward(q, k, v, kv_valid, out, lse)
        ctx.ring, ctx.scale = ring, scale
        return all_gather(out.to(q.dtype), ring.group, dim=-2)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_valid, out, lse = ctx.saved_tensors
        ring, scale = ctx.ring, ctx.scale
        n, idx = ring.n, ring.idx
        s_loc = q.shape[-2] // n
        blk = slice(idx * s_loc, (idx + 1) * s_loc)
        qb, gb = q[..., blk, :].float(), g[..., blk, :].float()
        kb, vb = k[..., blk, :].contiguous(), v[..., blk, :].contiguous()
        validb = None if kv_valid is None else kv_valid[blk]
        masked = validb is not None
        delta = (gb * out).sum(dim=-1, keepdim=True)
        dq = torch.zeros_like(qb)
        dk = torch.zeros_like(kb, dtype=torch.float32)
        dv = torch.zeros_like(vb, dtype=torch.float32)
        for step in range(n):
            s = _scores(qb, kb, validb, scale)
            p = torch.exp(s - lse[..., None])
            if masked:
                p = torch.where(torch.isfinite(s) & torch.isfinite(lse)[..., None], p, 0.0)
            dv = dv + torch.matmul(p.transpose(-1, -2), gb)
            ds = p * (torch.matmul(gb, vb.float().transpose(-1, -2)) - delta)
            dq = dq + torch.matmul(ds, kb.float()) * scale
            dk = dk + torch.matmul(ds.transpose(-1, -2), qb) * scale
            # each accumulator goes on with its block; after the last step
            # one more rotation brings it home to the block's owner
            if step < n - 1:
                kb, vb, dk, dv, *rest = ring.rotate(
                    [kb, vb, dk, dv] + ([validb] if masked else []))
                validb = rest[0] if masked else None
            elif n > 1:
                dk, dv = ring.rotate([dk, dv])
        grads = [all_gather(t, ring.group, dim=-2).to(x.dtype)
                 for t, x in ((dq, q), (dk, k), (dv, v))]
        return (*grads, None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mesh,
                   axis: str = "seq", scale: float | None = None,
                   kv_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Context-parallel attention over ``(B, H, S, D)`` with S split over
    ``mesh``'s ``axis``: the same tensors on every rank of that axis, the
    whole output returned on each.

    ``S`` must be divisible by the axis size.  ``kv_valid`` (``(S,)`` bool)
    excludes key positions from every query's softmax: callers whose true S
    is not a shard multiple zero-pad to one and mask the padded keys; the
    padded query rows give outputs the caller discards."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
    n = mesh.shape[axis]
    if q.shape[-2] % n:
        raise ValueError(f"seq {q.shape[-2]} not divisible by {n} shards")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if kv_valid is not None:
        kv_valid = kv_valid.to(device=k.device, dtype=torch.bool)
    return _RingAttention.apply(q, k, v, kv_valid, _Ring(mesh, axis), scale)
