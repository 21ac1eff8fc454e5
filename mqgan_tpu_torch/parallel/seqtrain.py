"""Sequence-parallel training on ``torch.distributed``: each crop's time
axis split over the ranks of a seq group (counterpart of the JAX
package's ``seq`` mesh axis, ``mqgan_tpu/parallel/mesh.py``
``train_array_sharding``).

Under GSPMD, XLA inserts the halo exchanges of the sharded convolutions and
the global reductions of the masked pools. In PyTorch each is explicit and
differentiable, and this module holds them:

* ``SeqShard.fetch`` / ``SeqShard.conv``: the halo exchange. A rank gets
  the input frames [a, b) its outputs need, from whichever ranks own them,
  zero-filled past either end of the whole crop (as the conv's padding
  is); the conv then runs unpadded along time. Its backward sends each
  halo's gradient back to its owner, which adds it to its own.
* ``SeqShard.sum`` / ``SeqShard.max``: reductions over the seq group. The
  sum's backward sums the ranks' gradients (every rank computes the same
  function of the reduced value, each for its own frames). The max splits
  its gradient evenly over the tied frames of ALL ranks, as ``amax`` and
  JAX's ``reduce_max`` split it: the tie count is reduced too.

Geometry. A rank of seq index s holds frames [bounds[s], bounds[s + 1]) of
every row; at the input bounds[s] = s * T / N. A layer of kernel k (span
d (k - 1) + 1 with dilation d), stride st and time padding (lo, hi) maps
output frame j to the input window [j st - lo, j st - lo + span). Output
j belongs to the rank that holds input frame j st, its anchor, so the
output bounds are ceil(bounds / st), capped at the output length. After
strided layers a rank may own no output frame; it still runs the layer,
on a window one span wide, and keeps nothing of it, so that every rank
builds the same graph. A window may reach past the nearest neighbour (a
shard shorter than a halo): the exchange is over the whole group.

Transport. One ``all_reduce`` over the seq group per exchange: every rank
knows every rank's window (a function of the bounds and the layer),
writes the frames it owns of every other rank's halo into that rank's
slots of a zero buffer, and the group sums the buffer. Each element has
one writer, so the sum is exact in any dtype (bf16 halos travel as bf16).
The backward is the transpose: each rank writes its halos' gradients into
its own slots, the group sums, and each owner adds what it reads from
every slot to its frames' gradients. Only
``all_reduce`` is used, so gloo runs it on CUDA tensors (ranks that share
one card) and NCCL runs the same code where ranks have cards of their own.
A layer whose windows need no halo (a 1x1 conv) exchanges nothing.

Every rank issues the same collectives in the same order, forward and
backward: the graphs are built alike (no branch on a rank's data), so
autograd runs their backward nodes in one order.
"""

from __future__ import annotations

import datetime
import functools
from dataclasses import dataclass

import torch
import torch.distributed as dist

from mqgan_tpu_torch.parallel.mesh import train_grid


class SeqGroup:
    """This rank's seq group: its index, the group's size, and the
    ``torch.distributed`` group that joins them (None: the default group).
    The primitives of ``SeqShard`` live here, so that one subclass can
    change them for every layer (the tests' rank-local variants)."""

    def __init__(self, index: int, size: int, group=None):
        if not 0 <= index < size:
            raise ValueError(f"seq index {index} not in [0, {size})")
        self.index, self.size, self.group = index, size, group

    @classmethod
    def create(cls, rank: int, world: int, n_seq: int,
               timeout_s: float | None = None) -> "SeqGroup":
        """The seq group of ``rank`` in a data x seq grid of ``world`` ranks,
        seq innermost: one ``new_group`` per data rank, which every rank
        creates in the same order (``torch.distributed``'s rule)."""
        data, n_data, seq = train_grid(rank, world, n_seq)
        if n_data == 1:
            return cls(seq, n_seq)
        kw = {} if timeout_s is None else {
            "timeout": datetime.timedelta(seconds=timeout_s)}
        mine = None
        for d in range(n_data):
            g = dist.new_group(list(range(d * n_seq, (d + 1) * n_seq)), **kw)
            if d == data:
                mine = g
        return cls(seq, n_seq, mine)

    def shard(self, total: int) -> "SeqShard":
        """The even split of ``total`` frames (which N divides)."""
        if total % self.size:
            raise ValueError(f"{total} frames do not divide over {self.size} "
                             "sequence-parallel ranks")
        step = total // self.size
        return SeqShard(self, tuple(i * step for i in range(self.size + 1)))

    def all_reduce_(self, t: torch.Tensor, op=None) -> torch.Tensor:
        """The transport: ``t`` reduced in place over the group (SUM unless
        ``op``)."""
        if self.size > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op,
                            group=self.group)
        return t

    def fetch(self, x, dim, bounds, need):
        return _Exchange.apply(x, self, dim, bounds, need)

    def sum(self, x):
        return _Sum.apply(x, self)

    def max(self, x, dim):
        return _Max.apply(x, dim, self)


@functools.lru_cache(maxsize=4096)
def window_plan(bounds: tuple, need: tuple) -> tuple:
    """The halo slots of an exchange: per rank r, the (lo, hi, offset)
    segments of its window ``need[r]`` = [a, e) that lie in the crop
    [0, bounds[-1]) but outside r's own frames (left of them, then right),
    each at ``offset`` in the flat buffer; and the buffer's width."""
    total, plan, width = bounds[-1], [], 0
    for r, (a, e) in enumerate(need):
        own_lo, own_hi = bounds[r], bounds[r + 1]
        segs = []
        for lo, hi in ((max(a, 0), min(e, own_lo)), (max(a, own_hi), min(e, total))):
            if lo < hi:
                segs.append((lo, hi, width))
                width += hi - lo
        plan.append(tuple(segs))
    return tuple(plan), width


def _pieces(a: int, e: int, bounds: tuple, r: int) -> tuple:
    """[a, e) cut at 0, r's own range and the crop's end: (zeros before 0,
    left halo, own, right halo, zeros past the end) as (lo, hi) pairs."""
    cuts = (0, bounds[r], bounds[r + 1], bounds[-1])
    edges = (a,) + tuple(min(max(c, a), e) for c in cuts) + (e,)
    return tuple(zip(edges[:-1], edges[1:]))


class _Exchange(torch.autograd.Function):
    """x: this rank's frames along ``dim`` (bounds[s] .. bounds[s + 1]) ->
    its window need[s] of the whole crop, zero-filled outside it."""

    @staticmethod
    def forward(ctx, x, group, dim, bounds, need):
        ctx.group, ctx.dim, ctx.bounds, ctx.need = group, dim, bounds, need
        s = group.index
        plan, width = window_plan(bounds, need)
        start = bounds[s]
        buf = None
        if width:
            shape = list(x.shape)
            shape[dim] = width
            buf = x.new_zeros(shape)
            for r, segs in enumerate(plan):
                if r == s:
                    continue
                for lo, hi, off in segs:
                    o_lo, o_hi = max(lo, start), min(hi, bounds[s + 1])
                    if o_lo < o_hi:
                        buf.narrow(dim, off + o_lo - lo, o_hi - o_lo).copy_(
                            x.narrow(dim, o_lo - start, o_hi - o_lo))
            group.all_reduce_(buf)
        a, e = need[s]
        slots = {(lo, hi): off for lo, hi, off in plan[s]}
        parts = []
        for i, (lo, hi) in enumerate(_pieces(a, e, bounds, s)):
            if lo >= hi:
                continue
            if i == 2:
                parts.append(x.narrow(dim, lo - start, hi - lo))
            elif i in (1, 3):
                parts.append(buf.narrow(dim, slots[(lo, hi)], hi - lo))
            else:
                shape = list(x.shape)
                shape[dim] = hi - lo
                parts.append(x.new_zeros(shape))
        if not parts:
            shape = list(x.shape)
            shape[dim] = 0
            return x.new_zeros(shape)
        return torch.cat(parts, dim=dim) if len(parts) > 1 else parts[0].clone()

    @staticmethod
    def backward(ctx, g):
        group, dim, bounds, need = ctx.group, ctx.dim, ctx.bounds, ctx.need
        s = group.index
        start, stop = bounds[s], bounds[s + 1]
        plan, width = window_plan(bounds, need)
        a, e = need[s]
        shape = list(g.shape)
        shape[dim] = stop - start
        gx = g.new_zeros(shape)
        lo, hi = _pieces(a, e, bounds, s)[2]
        if lo < hi:
            gx.narrow(dim, lo - start, hi - lo).add_(g.narrow(dim, lo - a, hi - lo))
        if width:
            shape[dim] = width
            buf = g.new_zeros(shape)
            for lo, hi, off in plan[s]:
                buf.narrow(dim, off, hi - lo).copy_(g.narrow(dim, lo - a, hi - lo))
            group.all_reduce_(buf)
            for r, segs in enumerate(plan):
                if r == s:
                    continue
                for lo, hi, off in segs:
                    o_lo, o_hi = max(lo, start), min(hi, stop)
                    if o_lo < o_hi:
                        gx.narrow(dim, o_lo - start, o_hi - o_lo).add_(
                            buf.narrow(dim, off + o_lo - lo, o_hi - o_lo))
        return gx, None, None, None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce_(g.contiguous().clone()), None


class _Max(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        m = group.all_reduce_(x.amax(dim).contiguous(), dist.ReduceOp.MAX)
        ctx.group, ctx.dim = group, dim
        ctx.save_for_backward(x == m.unsqueeze(dim))
        return m

    @staticmethod
    def backward(ctx, g):
        (ties,) = ctx.saved_tensors
        count = ties.sum(ctx.dim, dtype=torch.float32)
        buf = ctx.group.all_reduce_(torch.cat([g.float().reshape(-1),
                                               count.reshape(-1)]))
        gs, n = buf.split(g.numel())
        scale = (gs / n).view(g.shape).unsqueeze(ctx.dim).to(g.dtype)
        return ties.to(g.dtype) * scale, None, None


@dataclass(frozen=True)
class SeqShard:
    """This rank's frames of a time-sharded batch at one level of a model:
    rank r of ``group`` holds global frames [bounds[r], bounds[r + 1])."""

    group: SeqGroup
    bounds: tuple

    @property
    def start(self) -> int:
        return self.bounds[self.group.index]

    @property
    def stop(self) -> int:
        return self.bounds[self.group.index + 1]

    @property
    def local(self) -> int:
        return self.stop - self.start

    @property
    def total(self) -> int:
        return self.bounds[-1]

    @property
    def is_last(self) -> bool:
        return self.group.index == self.group.size - 1

    def padded(self, total: int) -> "SeqShard":
        """The same split with the crop extended to ``total`` frames, the
        pad frames the last rank's."""
        return SeqShard(self.group, self.bounds[:-1] + (total,))

    def window(self, kernel: int, stride: int = 1, pad=(0, 0),
               dilation: int = 1) -> tuple:
        """(the output's shard, every rank's input window (a, e)) of a
        layer along time (see the module's docstring)."""
        bounds, need = _window(self.bounds, kernel, stride, tuple(pad), dilation)
        return SeqShard(self.group, bounds), need

    def fetch(self, x: torch.Tensor, dim: int, need: tuple) -> torch.Tensor:
        """This rank's window ``need[index]`` of the whole crop along
        ``dim``, every rank asking for its own (the halo exchange)."""
        return self.group.fetch(x, dim, self.bounds, need)

    def conv(self, x: torch.Tensor, dim: int, kernel: int, fn, stride: int = 1,
             pad=(0, 0), dilation: int = 1) -> tuple:
        """(y, y's shard): ``fn``, a layer with no time padding, over this
        rank's window of x along ``dim``, cut to the outputs it owns."""
        out, need = self.window(kernel, stride, pad, dilation)
        y = fn(self.fetch(x, dim, need))
        return y.narrow(dim, 0, out.local), out

    def upsample2(self, x: torch.Tensor, dim: int, out: "SeqShard") -> torch.Tensor:
        """Nearest x2 along ``dim`` onto the frames of shard ``out`` (frame i
        is input frame i // 2)."""
        need = []
        for r in range(self.group.size):
            oa, oe = out.bounds[r], out.bounds[r + 1]
            need.append((oa // 2, (oe + 1) // 2 if oe > oa else oa // 2))
        need = tuple(need)
        a = need[self.group.index][0]
        w = self.fetch(x, dim, need).repeat_interleave(2, dim=dim)
        return w.narrow(dim, out.start - 2 * a if out.local else 0, out.local)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return self.group.sum(x)

    def max(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The max over ``dim`` of every rank's frames."""
        return self.group.max(x, dim)

    def take(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's frames of a whole-crop tensor (a mask)."""
        return x.narrow(dim, self.start, self.local)

    def pad_mask(self, lengths: torch.Tensor) -> torch.Tensor:
        """(B, local) True where the global frame index >= the row's
        length: this rank's frames of the full pad mask."""
        pos = torch.arange(self.start, self.stop, device=lengths.device)
        return pos[None, :] >= lengths[:, None]

    def local_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        """Each row's valid frames among this rank's, a prefix of them."""
        return (lengths - self.start).clamp(0, self.local).to(lengths.dtype)


@functools.lru_cache(maxsize=4096)
def _window(bounds, kernel, stride, pad, dilation):
    lo, hi = pad
    span = dilation * (kernel - 1) + 1
    t_out = (bounds[-1] + lo + hi - span) // stride + 1
    if t_out < 1:
        raise ValueError(f"{bounds[-1]} frames are too few for a window of "
                         f"{span} with padding {pad}")
    out = tuple(min(-(-b // stride), t_out) for b in bounds[:-1]) + (t_out,)
    need = []
    for r in range(len(bounds) - 1):
        oa, oe = out[r], out[r + 1]
        a = oa * stride - lo
        need.append((a, a + (max(oe - oa, 1) - 1) * stride + span))
    return out, tuple(need)
