"""Ring attention: blockwise causal attention with the sequence sharded over
a mesh dim. The port of ray_tpu/parallel/ring_attention.py, with its math.

- Each rank holds one contiguous block of the sequence, q/k/v
  ``[B, S/n, H, D]``.
- Each of the ``n`` ring steps computes one (q-block x kv-block) tile with
  the streaming softmax in float32 (running max ``m``, denominator ``l``,
  numerator ``o``; ``_block_attn_accum``), then passes k/v and their global
  positions to the next rank along the dim (``batch_isend_irecv``).
- The causal mask compares the carried *global* positions, so the result
  does not depend on the block layout; a fully masked row contributes zero.
- The backward (``_RingAttention.backward``) runs the ring the other way:
  each rank keeps its dQ, while each block's dK/dV accumulators travel with
  the block, gather the contribution of every rank they visit and are home
  after ``n`` hops. JAX gets the same by differentiating ``ppermute``. No
  rank ever holds more than one foreign block, so memory per rank stays
  constant in the ring size.

The tiles are plain torch, as the reference's are plain ``jnp`` (no Pallas
kernel is reached).
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ray_tpu_torch.parallel.collectives import _exchange
from ray_tpu_torch.parallel.mesh import axis_ranks

NEG_INF = -1e30


def _block_attn_accum(q, k, v, qpos, kpos, o, m, l):
    """One flash-attention tile: accumulate (o, m, l) with q:[B,Sq,Hq,D] k/v:[B,Sk,Hkv,D]."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, g, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() / math.sqrt(D)
    mask = qpos[:, None, None, :, None] >= kpos[:, None, None, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    # guard fully-masked rows (m_new == NEG_INF): keep them at zero contribution
    alive = m_new > NEG_INF / 2
    m_safe = torch.where(alive, m_new, 0.0)
    correction = torch.where(alive, torch.exp(m - m_safe), 0.0)
    p = torch.exp(torch.where(mask, scores - m_safe[..., None], NEG_INF))
    l_new = l * correction + p.sum(dim=-1)
    pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype), v).float()
    o_new = o * correction[..., None] + pv
    return o_new, m_new, l_new


class _Ring:
    """This rank's neighbours along the sequence dim."""

    def __init__(self, mesh, axis: str):
        self.ranks = axis_ranks(mesh, axis)
        self.n = len(self.ranks)
        me = mesh.get_local_rank(axis)
        self.next, self.prev = self.ranks[(me + 1) % self.n], self.ranks[(me - 1) % self.n]

    def shift(self, tensors, forward: bool = True):
        """Each tensor sent one hop round the ring (to the next rank, or to
        the previous one when not ``forward``), and the neighbour's taken."""
        dst, src = (self.next, self.prev) if forward else (self.prev, self.next)
        return [_exchange(t, dst, src) for t in tensors]


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, qpos, kpos, ring):
        B, Sq, Hq, D = q.shape
        Hkv = k.shape[2]
        g = Hq // Hkv
        o = torch.zeros((B, Hkv, g, Sq, D), dtype=torch.float32, device=q.device)
        m = torch.full((B, Hkv, g, Sq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, Hkv, g, Sq), dtype=torch.float32, device=q.device)
        kb, vb, pb = k, v, kpos
        for i in range(ring.n):
            o, m, l = _block_attn_accum(q, kb, vb, qpos, pb, o, m, l)
            if i + 1 < ring.n:  # the reference's last hop only brings the block home
                kb, vb, pb = ring.shift([kb, vb, pb])
        out = o / torch.clamp(l[..., None], min=1e-30)
        ctx.save_for_backward(q, k, v, qpos, kpos, out, m, l)
        ctx.ring = ring
        # [B,Hkv,g,Sq,D] -> [B,Sq,Hq,D]
        return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, qpos, kpos, out, m, l = ctx.saved_tensors
        ring = ctx.ring
        B, Sq, Hq, D = q.shape
        Hkv = k.shape[2]
        g = Hq // Hkv
        scale = 1.0 / math.sqrt(D)
        qg = q.reshape(B, Sq, Hkv, g, D).float()
        do = dout.reshape(B, Sq, Hkv, g, D).permute(0, 2, 3, 1, 4).float()  # [B,Hkv,g,Sq,D]
        delta = (do * out).sum(dim=-1)  # [B,Hkv,g,Sq]
        alive = (m > NEG_INF / 2)[..., None]
        m_safe = torch.where(alive, m[..., None], 0.0)
        l_safe = torch.clamp(l[..., None], min=1e-30)
        dq = torch.zeros_like(qg)
        kb, vb, pb = k, v, kpos
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for i in range(ring.n):
            s = torch.einsum("bqhgd,bkhd->bhgqk", q.reshape(B, Sq, Hkv, g, D), kb).float() * scale
            mask = (qpos[:, None, None, :, None] >= pb[:, None, None, None, :]) & alive
            p = torch.where(mask, torch.exp(s - m_safe) / l_safe, 0.0)
            dp = torch.einsum("bhgqd,bkhd->bhgqk", do, vb.float())
            ds = p * (dp - delta[..., None]) * scale
            dq += torch.einsum("bhgqk,bkhd->bqhgd", ds, kb.float())
            dk += torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
            dv += torch.einsum("bhgqk,bhgqd->bkhd", p, do)
            if ring.n > 1:
                # the block and its accumulators move on; after n hops they are home
                if i + 1 < ring.n:
                    kb, vb, pb, dk, dv = ring.shift([kb, vb, pb, dk, dv], forward=False)
                else:
                    dk, dv = ring.shift([dk, dv], forward=False)
        return (dq.reshape(B, Sq, Hq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None)


def _ring_attention_sharded(q, k, v, qpos, kpos, ring: _Ring):
    """Causal attention of this rank's block q [B,Sq,Hq,D] against every
    rank's k/v block, positions [B, S_block] global."""
    return _RingAttention.apply(q, k, v, qpos, kpos, ring)


def block_positions(mesh, seq_axis: str, B: int, S_local: int, device) -> torch.Tensor:
    """Global positions [B, S_local] of this rank's contiguous block."""
    start = mesh.get_local_rank(seq_axis) * S_local
    pos = torch.arange(start, start + S_local, dtype=torch.int32, device=device)
    return pos.expand(B, S_local)


def ring_attention(q, k, v, mesh, *, seq_axis: str = "seq", positions=None):
    """Causal ring attention over the mesh's sequence dim.

    q/k/v are this rank's blocks ``[B, S/n, H, D]`` (``positions``, if
    given, the block's global positions ``[B, S/n]``), or DTensors of the
    global ``[B, S, H, D]``, which are laid out sharded on S over
    ``seq_axis`` (replicated on the other dims) and give a DTensor back."""
    if isinstance(q, DTensor):
        placements = [Shard(1) if n == seq_axis else Replicate() for n in mesh.mesh_dim_names]
        local = [t.redistribute(mesh, placements).to_local() for t in (q, k, v)]
        out = ring_attention(*local, mesh, seq_axis=seq_axis, positions=positions)
        return DTensor.from_local(out, mesh, placements, run_check=False, shape=q.shape,
                                  stride=q.stride())
    B, S_local = q.shape[:2]
    if positions is None:
        positions = block_positions(mesh, seq_axis, B, S_local, q.device)
    return _ring_attention_sharded(q, k, v, positions, positions, _Ring(mesh, seq_axis))


def make_ring_attn_fn(mesh, seq_axis: str = "seq"):
    """Adapter with the models.llama attn_fn signature (q, k, v) -> o, on
    this rank's contiguous sequence blocks."""
    ring = _Ring(mesh, seq_axis)

    def attn_fn(q, k, v):
        B, S_local = q.shape[:2]
        pos = block_positions(mesh, seq_axis, B, S_local, q.device)
        return _ring_attention_sharded(q, k, v, pos, pos, ring)

    attn_fn.seq_axis = seq_axis  # the mesh step checks that attention is a ring
    return attn_fn
