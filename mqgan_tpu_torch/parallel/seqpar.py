"""Sequence-parallel decode and re-encode of one long clip (counterpart of
``mqgan_tpu/parallel/seqpar.py``).

The clip's time axis is cut into n halo'd windows, one per entry of a
device list (parallel/mesh.py), and each window keeps only its interior:

* window i starts at ``s_i = clip(i * chunk - halo_l, 0, t_pad - w)`` with
  ``w = min(chunk + halo_l + halo_r, t_pad)`` and keeps its frames
  ``[i * chunk - s_i, i * chunk - s_i + chunk)``; chunk, halo_l, w and
  t_pad are multiples of ``2 ** refiner_depth``, so every start sits on the
  refiner's pooling grid (core/chunking.py ``halo_align``). The clamp binds
  only at the clip's ends, where it gives more context, never less.
* a frame is padded iff its clip position is >= the row's length, in the
  full pass and in every window alike, so a window's own lengths are
  ``clip(length - s_i, 0, w)``, a contiguous prefix as the block kernel
  takes it.
* decode is time-local: with ``decoder_halos`` its kept frames equal a
  full-length decode. Re-encode runs the whole encode -> FSQ -> decode
  pipeline on windows with the composed ``generator_halos``, and the
  encoder's non-causal blocks pool their CBAM statistics over each
  window's interior frames that are valid (each clip frame counted once)
  and combine the windows' sums and maxima, as JAX psums and pmaxes them
  over its mesh axis, so the gate equals the full pass's. On the card each
  such block runs the split launch of ``csrc/residual_block.cu``.

Windows meet at each of those reductions in one of two ways:

* stacked (``stack=True``, the default): the windows that share a device
  are stacked along the batch axis and run as one batch, one launch per
  kernel; their partial statistics reduce by a reshape-sum and -max over
  the window axis.
* threads: each group of windows (a distinct device, or with
  ``stack=False`` each list entry) runs on a host thread of its own, and
  the groups meet at a barrier inside ``reduce``: their partials are summed
  and max-reduced on the first device and copied back.

The plan needs the exact mixers: the Chebyshev mode fits its polynomial to
each call's own range, so a window's fit would differ from the full pass's
(``ValueError`` for a model with ``poly_mixers``). Outputs are gathered on
the first device.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass

import torch

from mqgan_tpu_torch.core.chunking import decoder_halos, generator_halos, halo_align
from mqgan_tpu_torch.parallel.mesh import local_devices, replicate


@dataclass(frozen=True)
class SeqPlan:
    """Static geometry of one sequence-parallel call."""

    n: int  # windows
    t: int  # true clip length (frames)
    chunk: int  # kept frames per window
    t_pad: int  # n * chunk
    halo_l: int
    halo_r: int
    window: int  # chunk + halo_l + halo_r, clamped to t_pad

    @property
    def redundancy(self) -> float:
        """Extra computed frames / kept frames (the halos' overhead)."""
        return self.n * self.window / max(self.t_pad, 1) - 1.0

    def geometry(self, i: int) -> tuple:
        """(start, interior offset) of window i."""
        s = min(max(i * self.chunk - self.halo_l, 0), self.t_pad - self.window)
        return s, i * self.chunk - s


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _plan(t: int, n: int, halo_l: int, halo_r: int, align: int) -> SeqPlan:
    chunk = _round_up(max(1, math.ceil(t / n)), align)
    t_pad = chunk * n
    # windows larger than the padded clip degenerate to full-length passes
    # in every window (exact, only redundant): short clips or few frames a
    # window
    window = min(chunk + halo_l + halo_r, t_pad)
    return SeqPlan(n, t, chunk, t_pad, halo_l, halo_r, window)


def plan_seq_decode(t: int, n: int, kernel_sizes, refiner_depth: int,
                    mixer_kernel: int = 5) -> SeqPlan:
    halo_l, halo_r = decoder_halos(tuple(kernel_sizes), refiner_depth,
                                   mixer_kernel)
    return _plan(t, n, halo_l, halo_r, halo_align(refiner_depth))


def plan_seq_reencode(t: int, n: int, kernel_sizes, refiner_depth: int,
                      mixer_kernel: int = 5) -> SeqPlan:
    """Like ``plan_seq_decode`` with the composed encode + decode halos: the
    leftmost token a kept frame's decode reads carries the encoder's conv
    context inside the window too."""
    halo_l, halo_r = generator_halos(tuple(kernel_sizes), refiner_depth,
                                     mixer_kernel)
    return _plan(t, n, halo_l, halo_r, halo_align(refiner_depth))


MEET_TIMEOUT_S = 600.0


class _Meet:
    """Where the groups' partial statistics meet, one reduction at a time:
    each group posts its (sum, max), the first sums and max-reduces them on
    its device in group order, and each takes the totals back to its own
    device."""

    def __init__(self, n_groups: int, home: torch.device):
        # a group that never arrives breaks the barrier instead of hanging
        self.barrier = threading.Barrier(n_groups, timeout=MEET_TIMEOUT_S)
        self.parts: list = [None] * n_groups
        self.home = home
        self.total = None

    def __call__(self, g: int, s: torch.Tensor, m: torch.Tensor) -> tuple:
        self.parts[g] = (s, m)
        self.barrier.wait()
        if g == 0:
            s_t, m_t = (p.to(self.home) for p in self.parts[0])
            for s_g, m_g in self.parts[1:]:
                s_t = s_t + s_g.to(self.home)
                m_t = torch.maximum(m_t, m_g.to(self.home))
            self.total = (s_t, m_t)
        self.barrier.wait()
        return tuple(p.to(s.device) for p in self.total)


def _group_reduce(n_windows: int, b: int, meet: _Meet | None, g: int):
    """``reduce(sum, max)`` of a group of ``n_windows`` stacked windows of
    ``b`` rows each."""

    def reduce(s: torch.Tensor, m: torch.Tensor) -> tuple:
        s = s.reshape(n_windows, b, -1).sum(dim=0)
        m = m.reshape(n_windows, b, -1).amax(dim=0)
        if meet is not None:
            s, m = meet(g, s, m)
        return s.repeat(n_windows, 1), m.repeat(n_windows, 1)

    return reduce


def _groups(devices: list, stack: bool) -> list:
    """[(device, [window indices])]: windows stacked by device, in order of
    first appearance, or one group per window."""
    if not stack:
        return [(d, [i]) for i, d in enumerate(devices)]
    groups: dict = {}
    for i, d in enumerate(devices):
        groups.setdefault(d, []).append(i)
    return list(groups.items())


def _run_groups(groups: list, fn) -> list:
    """fn(g, device, windows, meet) for every group: in this thread for
    one group, else one thread a group; the first error is raised."""
    if len(groups) == 1:
        d, wins = groups[0]
        return [_on_device(d, fn, 0, d, wins, None)]
    meet = _Meet(len(groups), groups[0][0])
    results: list = [None] * len(groups)
    errors: list = [None] * len(groups)

    def work(g):
        d, wins = groups[g]
        try:
            results[g] = _on_device(d, fn, g, d, wins, meet)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors[g] = e
            meet.barrier.abort()

    threads = [threading.Thread(target=work, args=(g,), daemon=True)
               for g in range(len(groups))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    raised = [e for e in errors if e is not None]
    if raised:  # the cause first, the barriers it broke after
        raised.sort(key=lambda e: isinstance(e, threading.BrokenBarrierError))
        raise raised[0]
    return results


def _on_device(device: torch.device, fn, *args):
    with torch.no_grad():
        if device.type == "cuda":
            with torch.cuda.device(device):
                return fn(*args)
        return fn(*args)


def _windows(plan: SeqPlan, x: torch.Tensor, lengths: torch.Tensor,
             wins: list, device: torch.device, stats: bool) -> tuple:
    """The stacked windows ``wins`` of x (B, t_pad, ...) on ``device``:
    (inputs (n*B, w, ...), pad mask (n*B, w), stats mask or None)."""
    w = plan.window
    x = x.to(device)
    lengths = lengths.to(device)
    local = torch.arange(w, device=device)
    xs, masks, stats_masks = [], [], []
    for i in wins:
        s, off = plan.geometry(i)
        xs.append(x[:, s:s + w])
        mask = (s + local)[None, :] >= lengths[:, None]
        masks.append(mask)
        if stats:
            interior = (local >= off) & (local < off + plan.chunk)
            stats_masks.append(mask | ~interior[None, :])
    return (torch.cat(xs, dim=0).contiguous(), torch.cat(masks, dim=0),
            torch.cat(stats_masks, dim=0) if stats else None)


def _kept(plan: SeqPlan, outs: tuple, wins: list, b: int) -> dict:
    """{window: its kept interior of each output}."""
    kept = {}
    for j, i in enumerate(wins):
        _, off = plan.geometry(i)
        kept[i] = tuple(o[j * b:(j + 1) * b, off:off + plan.chunk] for o in outs)
    return kept


def _prepare(model, x, lengths, devices, replicas, plan_fn):
    if model.poly_mixers:
        raise ValueError("sequence-parallel serving needs the exact mixers: "
                         "a window's Chebyshev fit differs from the full "
                         "pass's")
    devices = local_devices(devices)
    b, t = x.shape[0], x.shape[1]
    plan = plan_fn(t, len(devices), model.kernel_sizes, model.refiner_depth)
    pad = torch.zeros((b, plan.t_pad - t) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    x = torch.cat([x, pad], dim=1)
    lengths = torch.as_tensor(lengths).to(torch.int64).clamp(max=t)
    replicas = replicas if replicas is not None else replicate(model, devices)
    return devices, plan, x, lengths, replicas


def _gather(plan: SeqPlan, results: list, home: torch.device) -> tuple:
    kept = {}
    for r in results:
        kept.update(r)
    n_out = len(kept[0])
    return tuple(torch.cat([kept[i][k].to(home) for i in range(plan.n)],
                           dim=1)[:, :plan.t] for k in range(n_out))


def seq_parallel_decode(model, indices, lengths, devices=None, *,
                        stack: bool = True, replicas: dict | None = None):
    """indices (B, T) int -> refined mel (B, T, mel), the time axis in
    windows over ``devices`` (None: every visible card), equal to a
    full-length decode with the padded convention. ``replicas``: a
    ``{device: model}`` made once by parallel/mesh.py ``replicate`` (else
    made per call)."""
    indices = torch.as_tensor(indices)
    devices, plan, idx, lengths, replicas = _prepare(
        model, indices, lengths, devices, replicas, plan_seq_decode)
    b = idx.shape[0]

    def run(g, device, wins, meet):
        win, mask, _ = _windows(plan, idx, lengths, wins, device, stats=False)
        return _kept(plan, (replicas[device].decode(win, mask),), wins, b)

    return _gather(plan, _run_groups(_groups(devices, stack), run),
                   devices[0])[0]


def seq_parallel_reencode(model, mel, lengths, devices=None,
                          return_recon: bool = False, *, stack: bool = True,
                          replicas: dict | None = None):
    """mel (B, T, mel) -> (tokens (B, T) int32, x_post (B, T, mel)), with
    ``return_recon`` (tokens, x_recon, x_post): encode -> FSQ -> decode on
    windows over ``devices`` (None: every visible card), each window the
    whole pipeline, equal to one full-length pass (the encoder's CBAM
    statistics reduced over the windows)."""
    mel = torch.as_tensor(mel)
    devices, plan, x, lengths, replicas = _prepare(
        model, mel, lengths, devices, replicas, plan_seq_reencode)
    b = x.shape[0]
    groups = _groups(devices, stack)

    def run(g, device, wins, meet):
        m = replicas[device]
        win, mask, stats_mask = _windows(plan, x, lengths, wins, device,
                                         stats=True)
        idx = m.encode(win, mask, stats_mask,
                       _group_reduce(len(wins), b, meet, g))
        post, recon = m.decode(idx, mask, return_recon=True)
        return _kept(plan, (idx, recon, post) if return_recon else (idx, post),
                     wins, b)

    return _gather(plan, _run_groups(groups, run), devices[0])
