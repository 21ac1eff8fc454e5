"""Sequence-parallel training (``parallel/seqtrain.py``): the crop's time
axis split over the ranks of a seq group.

First, without processes (the ranks are threads that meet at a barrier
for each collective): the halo exchange behind a sharded conv against a
slice of the full conv, forward and gradient, for kernel, stride, padding
and N, shards shorter than a halo and ranks that own no output frame
included; the x2 upsample; the sum and the max over the group, whose
gradient splits over the tied frames of every rank.

Then the GAN step on gloo ranks (CPU) at the tiny config of
tests/test_torch_dp_step.py, T=32, B=8, from the same seeded JAX init
trees, dropout and FSQ noise inert, on three grids: seq 2, seq 4 (JAX's own
8-frame shards, shorter than the patch discriminator's time strides reach)
and data 2 x seq 2. The batch is ragged: a row of 5 valid frames ends
inside seq rank 0's shard, another is a zero-length fill row. Three steps
of each variant (warmup; GAN; GAN + feature matching; the same with
``grad_accum 2``) on seq 2, GAN + feature matching on seq 4 and its
``grad_accum 2`` run on data 2 x seq 2 are held to the one-process port
step on the whole batch at tests/test_torch_dp_step.py's gates, and the
ranks end bit-equal; seq 2's warmup and GAN + feature matching cells and
the seq 4 and data 2 x seq 2 cells are held to the JAX step on their
(n_data, n_seq) mesh of the conftest's virtual devices at
tests/test_torch_gan_step.py's gates. The teeth: the first step with each
shard zero-padded at its edges (no exchange), and with rank-local pooled
statistics, each misses the one-process gates."""

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from mqgan_tpu_torch.core.config import TrainConfig
from mqgan_tpu_torch.parallel import multihost
from mqgan_tpu_torch.parallel.dp import DataParallel
from mqgan_tpu_torch.parallel.mesh import batch_rows, frame_range, train_grid
from mqgan_tpu_torch.parallel.seqtrain import SeqGroup, window_plan
from mqgan_tpu_torch.train.state import create_train_state
from mqgan_tpu_torch.train.step import build_models, make_train_step
from tests.test_torch_dp_step import MODELS, _lrs, check_one_process, check_updates

MEL, T, STEPS = 16, 32, 3
LENGTHS = np.array([32, 5, 24, 32, 16, 0, 12, 27], np.int32)
# name: (train_d, use_fm, grad_accum)
VARIANTS = {"warmup": (False, False, 1), "gan": (True, False, 1),
            "gan_fm": (True, True, 1), "gan_fm_accum2": (True, True, 2)}
# name: ((data ranks, seq ranks), its variants); the grids of one world
# size run in one launch
GRIDS = {"seq2": ((1, 2), tuple(VARIANTS)), "seq4": ((1, 4), ("gan_fm",)),
         "data2_seq2": ((2, 2), ("gan_fm_accum2",))}
CELLS = [(g, v) for g, (_, names) in GRIDS.items() for v in names]
# the cells that also run in JAX on their grid's mesh: every grid, and on
# seq 2 the step without and with the discriminator (each JAX compile takes
# 10-20 s of CPU; the gan and grad_accum 2 variants meet JAX's mesh step on
# seq 4 and data 2 x seq 2, and JAX's one-device step in
# tests/test_torch_gan_step.py and tests/test_torch_dp_step.py)
JAX_CELLS = (("seq2", "warmup"), ("seq2", "gan_fm"), ("seq4", "gan_fm"),
             ("data2_seq2", "gan_fm_accum2"))
TEETH_GRID = "seq4"


# --- the exchange without processes -----------------------------------------

class _Barrier:
    def __init__(self, n):
        self.barrier = threading.Barrier(n, timeout=60)
        self.slots = [None] * n


class ThreadGroup(SeqGroup):
    """A seq group whose ranks are threads of this process: each
    collective stacks the ranks' tensors at a barrier and reduces them in
    rank order."""

    def __init__(self, index, size, meet):
        super().__init__(index, size)
        self.meet = meet

    def all_reduce_(self, t, op=None):
        m = self.meet
        m.slots[self.index] = t.clone()
        m.barrier.wait()
        if op == dist.ReduceOp.MAX:
            r = torch.stack(m.slots).amax(0)
        else:
            r = m.slots[0].clone()
            for other in m.slots[1:]:
                r += other
        m.barrier.wait()
        return t.copy_(r)


def on_threads(n, fn):
    """``fn(group)`` on n threads, one a rank; their results in rank order."""
    meet, out, errors = _Barrier(n), [None] * n, []

    def run(i):
        try:
            torch.set_num_threads(1)
            out[i] = fn(ThreadGroup(i, n, meet))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            meet.barrier.abort()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


# (T, N, kernel, stride, padding)
GEOMETRY = [
    (32, 4, 3, 1, (1, 1)),  # a block's SAME conv
    (32, 4, 5, 1, (4, 0)),  # a causal conv
    (8, 4, 7, 1, (3, 3)),  # SAM's 7 taps over 2-frame shards: past the neighbour
    (32, 4, 5, 2, (2, 2)),  # a strided discriminator conv
    (12, 4, 3, 2, (1, 1)),  # strided over 3-frame shards
    (6, 3, 7, 4, (3, 3)),  # a rank with no output frame
    (40, 2, 2, 2, (0, 0)),  # the refiner's pool, a shard edge off its grid
    (5, 5, 3, 1, (1, 1)),  # one frame a rank
]


@pytest.mark.parametrize("t,n,k,stride,pad", GEOMETRY)
def test_exchange_is_a_slice_of_the_full_conv(t, n, k, stride, pad):
    rng = np.random.default_rng(t * 100 + n * 10 + k)
    x = torch.from_numpy(rng.standard_normal((2, 3, t)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 3, k)).astype(np.float32))
    xf = x.clone().requires_grad_()
    full = F.conv1d(F.pad(xf, pad), w, stride=stride)
    up = torch.from_numpy(rng.standard_normal(full.shape).astype(np.float32))
    (full * up).sum().backward()

    def rank(group):
        shard = group.shard(t)
        xl = x[..., shard.start:shard.stop].clone().requires_grad_()
        y, out = shard.conv(xl, 2, k, lambda xw: F.conv1d(xw, w, stride=stride),
                            stride=stride, pad=pad)
        (y * up[..., out.start:out.stop]).sum().backward()
        return y.detach(), xl.grad, out.bounds

    res = on_threads(n, rank)
    bounds = res[0][2]
    assert all(r[2] == bounds for r in res)
    assert bounds[0] == 0 and bounds[-1] == full.shape[-1]
    assert list(bounds) == sorted(bounds)
    torch.testing.assert_close(torch.cat([r[0] for r in res], -1), full.detach(),
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(torch.cat([r[1] for r in res], -1), xf.grad,
                               rtol=0, atol=1e-5)


def test_window_plan_reaches_past_the_neighbour():
    """SAM's 7 taps over 2-frame shards: rank 1's window [-1, 7) takes
    frames 0-1 from rank 0 and 4-6 from ranks 2 and 3, reaching past its
    neighbour; frame -1 is the crop's edge, zero-filled, in no slot."""
    shard = SeqGroup(1, 4).shard(8)
    out, need = shard.window(7, 1, (3, 3))
    assert out.bounds == (0, 2, 4, 6, 8)
    assert need == ((-3, 5), (-1, 7), (1, 9), (3, 11))
    plan, width = window_plan(shard.bounds, need)
    assert plan == (((2, 5, 0),), ((0, 2, 3), (4, 7, 5)),
                    ((1, 4, 8), (6, 8, 11)), ((3, 6, 13),))
    assert width == 16


@pytest.mark.parametrize("t,n", [(16, 4), (12, 3), (4, 4)])
def test_upsample_is_a_slice_of_the_full_repeat(t, n):
    """Nearest x2 from a pooled level's shards onto the finer level's,
    whose edges need not sit on the pooling grid."""
    rng = np.random.default_rng(t + n)
    x = torch.from_numpy(rng.standard_normal((2, t // 2, 3)).astype(np.float32))
    xf = x.clone().requires_grad_()
    full = xf.repeat_interleave(2, dim=1)
    up = torch.from_numpy(rng.standard_normal(full.shape).astype(np.float32))
    (full * up).sum().backward()

    def rank(group):
        fine = group.shard(t)
        coarse = fine.window(2, 2)[0]
        xl = x[:, coarse.start:coarse.stop].clone().requires_grad_()
        y = coarse.upsample2(xl, 1, fine)
        (y * up[:, fine.start:fine.stop]).sum().backward()
        return y.detach(), xl.grad

    res = on_threads(n, rank)
    torch.testing.assert_close(torch.cat([r[0] for r in res], 1), full.detach())
    torch.testing.assert_close(torch.cat([r[1] for r in res], 1), xf.grad)


def test_sum_and_max_split_gradients_over_every_rank():
    """The max's gradient splits evenly over the tied frames of all ranks
    (here a row's max sits on one frame of each of two ranks), as amax's
    does in one pass; the sum's reaches every rank's frames."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 8, 4)).astype(np.float32))
    x[0, 1, :] = x[0, 6, :] = 9.0  # ties across ranks 0 and 1 (of 2)
    x[1, 2, 0] = x[1, 3, 0] = 7.0  # ties inside one rank
    xf = x.clone().requires_grad_()
    g_max = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
    g_sum = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
    ((xf.amax(1) * g_max).sum() + (xf.sum(1) * g_sum).sum()).backward()

    for n in (2, 4):
        def rank(group):
            shard = group.shard(8)
            xl = x[:, shard.start:shard.stop].clone().requires_grad_()
            m, s = shard.max(xl, 1), shard.sum(xl.sum(1))
            # every rank computes the same function of the reduced values;
            # the loss is the ranks' sum, so each takes 1/n of it
            ((m * g_max).sum() / n + (s * g_sum).sum() / n).backward()
            return m.detach(), s.detach(), xl.grad

        res = on_threads(n, rank)
        torch.testing.assert_close(res[0][0], xf.amax(1).detach())
        torch.testing.assert_close(res[-1][1], xf.sum(1).detach())
        torch.testing.assert_close(torch.cat([r[2] for r in res], 1), xf.grad)


# --- the train step on gloo ranks -------------------------------------------

class NoExchange(SeqGroup):
    """Each shard zero-padded at its edges: the window's frames that the
    rank does not own are zeros (a conv over independent chunks)."""

    def fetch(self, x, dim, bounds, need):
        a, e = need[self.index]
        start, stop = bounds[self.index], bounds[self.index + 1]
        lo, hi = min(max(start, a), e), max(min(stop, e), min(max(start, a), e))
        own = x.narrow(dim, lo - start, hi - lo)
        return F.pad(own.movedim(dim, -1), (lo - a, e - hi)).movedim(-1, dim)


class LocalStats(SeqGroup):
    """Rank-local pooled statistics (each rank's own sums, counts and
    maxima)."""

    def sum(self, x):
        return x

    def max(self, x, dim):
        return x.amax(dim)


def run_steps(cfg_d, weights, mel, lengths, train_d, grad_accum, dp=None, seq=None,
              steps=STEPS):
    """``steps`` steps of the port from ``weights``: each step's metrics,
    the first step's gradients (after the reduction), the final
    state_dicts and LeCam."""
    cfg = TrainConfig.from_dict(cfg_d)
    models = build_models(cfg)
    for m, sd in zip(models, weights):
        m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    state = create_train_state(*models, cfg.training, torch.device("cpu"))
    state.dropout_rng = state.fsq_rng = None
    state.replicate_()
    step = make_train_step(cfg, train_d=train_d, grad_accum=grad_accum, dp=dp, seq=seq)
    mods = dict(zip(MODELS, (state.gen, state.patch, state.multibin)))
    out = {"metrics": []}
    for i in range(steps):
        m = step(state, torch.from_numpy(mel), torch.from_numpy(lengths))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["grads"] = {name: {n: (np.zeros(p.shape, np.float32) if p.grad is None
                                       else p.grad.numpy().copy())
                                   for n, p in mod.named_parameters()}
                            for name, mod in mods.items()}
    out["params"] = {name: {k: v.numpy().copy() for k, v in mod.state_dict().items()}
                     for name, mod in mods.items()}
    out["lecam"] = (float(state.lecam.ema_real), float(state.lecam.ema_fake))
    return out


def _rank(rank, world, device, grids, cases, mel, lengths):
    """One gloo rank: every variant of every grid of this world size on
    this rank's rows and frames; the teeth's first step on TEETH_GRID."""
    torch.set_num_threads(1)
    out = {}
    for grid in grids:
        (n_data, n_seq), names = GRIDS[grid]
        group = SeqGroup.create(rank, world, n_seq, timeout_s=60)
        data, _, s = train_grid(rank, world, n_seq)
        rows, frames = batch_rows(len(lengths), data, n_data), frame_range(T, s, n_seq)
        x, lens = np.ascontiguousarray(mel[rows][:, frames]), lengths[rows]
        dp = DataParallel(rank, world, n_seq)
        for name in names:
            cfg_d, weights, train_d, accum = cases[name]
            out[grid, name] = run_steps(cfg_d, weights, x, lens, train_d, accum, dp,
                                        group)
        if grid == TEETH_GRID:
            cfg_d, weights, train_d, accum = cases["gan_fm"]
            for cls in (NoExchange, LocalStats):
                out[cls.__name__] = run_steps(
                    cfg_d, weights, x, lens, train_d, accum, dp,
                    cls(group.index, group.size, group.group), steps=1)
    return out


def _jax_run(fn, cfg_d, variables, mel, lengths, store, n_data, n_seq):
    """STEPS JAX steps on an (n_data, n_seq) mesh of the conftest's virtual
    devices: rows over data, time over seq, the state replicated."""
    import jax
    import jax.numpy as jnp

    from mqgan_tpu.core import config as jcfg
    from mqgan_tpu.parallel.mesh import make_mesh, state_shardings, train_array_sharding
    from mqgan_tpu.train import state as jstate

    gv, pv, mv = variables
    js, _, _ = jstate.create_train_state(
        gen_variables=gv, patch_variables=pv, multibin_variables=mv,
        training_cfg=jcfg.TrainConfig.from_dict(cfg_d).training,
        rng=jax.random.key(3))
    mesh = make_mesh(n_data=n_data, n_seq=n_seq)
    js = jax.device_put(js, state_shardings(mesh, js))
    metrics, grads = [], None
    for i in range(STEPS):
        js, jm = fn(js, jax.device_put(jnp.asarray(mel), train_array_sharding(mesh, 3)),
                    jax.device_put(jnp.asarray(lengths), train_array_sharding(mesh, 1)))
        metrics.append({k: float(v) for k, v in jax.device_get(jm).items()})
        if i == 0:
            jax.block_until_ready(js)
            grads = dict(store)
    return jax.device_get(js), metrics, grads


def _jax_step(cfg_d, train_d, grad_accum, store, n_data, n_seq):
    """The JAX train step (on its mesh under grad_accum, as the JAX trainer
    builds it) whose optimizers record their gradients in ``store``."""
    from mqgan_tpu.core import config as jcfg
    from mqgan_tpu.parallel.mesh import make_mesh
    from mqgan_tpu.train import step as jstep
    from tests.test_torch_gan_step import _recording

    make_opt = jstep.make_optimizers
    mesh = make_mesh(n_data=n_data, n_seq=n_seq) if grad_accum > 1 else None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstep, "make_optimizers", lambda c: tuple(
            _recording(tx, store, k) for tx, k in zip(make_opt(c), ("gen", "disc"))))
        return jstep.make_train_step(jcfg.TrainConfig.from_dict(cfg_d),
                                     train_d=train_d, donate=False,
                                     grad_accum=grad_accum, mesh=mesh)


@pytest.fixture(scope="module")
def runs():
    """Every grid on its gloo ranks (one launch per world size), the
    one-process step of every variant, and the JAX steps of JAX_CELLS on
    their grids' meshes (compiled in threads while the ranks run)."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from mqgan_tpu_torch.utils.params import state_dict_from_jax
    from tests.test_torch_gan_step import jax_init, tiny_config_dict

    rng = np.random.default_rng(12)
    mel = rng.standard_normal((len(LENGTHS), T, MEL)).astype(np.float32)
    mel *= (np.arange(T)[None, :, None] < LENGTHS[:, None, None])
    cases, init, by_fm = {}, {}, {}
    for name, (train_d, use_fm, accum) in VARIANTS.items():
        cfg_d = tiny_config_dict(use_fm=use_fm)
        if use_fm not in by_fm:
            _, variables, _ = jax_init(cfg_d, jnp.asarray(mel), jnp.asarray(LENGTHS))
            models = build_models(TrainConfig.from_dict(cfg_d))
            weights = [{k: v.numpy() for k, v in state_dict_from_jax(
                            tree["params"], mod, tree.get("batch_stats")).items()}
                       for tree, mod in zip(jax.device_get(variables), models)]
            by_fm[use_fm] = (variables, weights)
        variables, weights = by_fm[use_fm]
        cases[name] = (cfg_d, weights, train_d, accum)
        init[name] = (variables, dict(zip(MODELS, weights)))
    worlds = {}
    for grid, ((n_data, n_seq), _) in GRIDS.items():
        worlds.setdefault(n_data * n_seq, []).append(grid)
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(8) as pool:
        # JAX's dropout inert, as tests/test_train_step.py does
        mp.setattr(fnn.Dropout, "__call__",
                   lambda self, x, deterministic=None, rng=None: x)
        launches = {n: pool.submit(multihost.launch, _rank, ["cpu"] * n,
                                   (grids, cases, mel, LENGTHS), timeout_s=240,
                                   group_timeout_s=120)
                    for n, grids in worlds.items()}
        jax_runs = {}
        for grid, name in JAX_CELLS:
            (n_data, n_seq), _ = GRIDS[grid]
            cfg_d, _, train_d, accum = cases[name]
            store = {}
            fn = _jax_step(cfg_d, train_d, accum, store, n_data, n_seq)
            jax_runs[grid, name] = pool.submit(_jax_run, fn, cfg_d, init[name][0],
                                               mel, LENGTHS, store, n_data, n_seq)
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            one = {name: run_steps(cfg_d, weights, mel, LENGTHS, train_d, accum)
                   for name, (cfg_d, weights, train_d, accum) in cases.items()}
        finally:
            torch.set_num_threads(n)
        ranks = {}
        for n, grids in worlds.items():
            for r, res in enumerate(launches[n].result()):
                ranks[n, r] = res
        jax_runs = {k: f.result() for k, f in jax_runs.items()}
    return {"cases": cases, "init": init, "ranks": ranks, "one": one, "jax": jax_runs}


def _ranks_of(runs, grid):
    (n_data, n_seq), _ = GRIDS[grid]
    return [runs["ranks"][n_data * n_seq, r] for r in range(n_data * n_seq)]


@pytest.mark.parametrize("grid,name", CELLS)
def test_seq_ranks_equal_one_process(runs, grid, name):
    ranks = _ranks_of(runs, grid)
    got, want = ranks[0][grid, name], runs["one"][name]
    cfg_d, _, train_d, _ = runs["cases"][name]
    check_one_process(f"{grid}/{name}", got, want)
    check_updates(name, got, want, runs["init"][name][1], _lrs(cfg_d, train_d))
    for other in ranks[1:]:  # the ranks end bit-equal
        theirs = other[grid, name]
        for model, sd in got["params"].items():
            for k, v in sd.items():
                assert np.array_equal(theirs["params"][model][k], v), (grid, name, model, k)
        assert theirs["metrics"] == got["metrics"]


@pytest.mark.parametrize("teeth", ["NoExchange", "LocalStats"])
def test_no_exchange_and_local_statistics_break_the_gates(runs, teeth):
    """Zero-padded shard edges, and rank-local pooled statistics, are not
    the one-process step on this batch: the first step's losses miss the
    1e-6 gate tenfold, and its gradients miss theirs."""
    got = _ranks_of(runs, TEETH_GRID)[0][teeth]
    want = runs["one"]["gan_fm"]
    g, w = got["metrics"][0], want["metrics"][0]
    assert max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-6)
               for k in ("loss_recon_pre", "loss_d", "loss_gan", "loss_fm")) > 1e-5
    assert any(np.abs(got["grads"][model][n] - gw).max()
               > 1e-5 * max(1.0, float(np.abs(gw).max()))
               for model, grads in want["grads"].items() for n, gw in grads.items())


@pytest.mark.parametrize("grid,name", JAX_CELLS)
def test_seq_ranks_equal_the_jax_mesh_step(runs, grid, name):
    from mqgan_tpu_torch.utils.params import state_dict_from_jax

    cfg_d, _, train_d, _ = runs["cases"][name]
    init = runs["init"][name][1]
    js, jmetrics, jgrads = runs["jax"][grid, name]
    got = _ranks_of(runs, grid)[0][grid, name]
    for m_got, m_want in zip(got["metrics"], jmetrics):
        for key in ("loss_g_total", "loss_recon_pre", "loss_recon_post", "loss_gan",
                    "loss_fm", "loss_d", "codebook_usage", "codebook_perplexity",
                    "learning_rate"):
            want = m_want[key]
            assert abs(m_got[key] - want) <= 1e-5 * max(abs(want), 1e-6) + 1e-12, (
                grid, name, key, m_got[key], want)
    models = dict(zip(MODELS, build_models(TrainConfig.from_dict(cfg_d))))
    want_grads = {"gen": {k: v.numpy() for k, v in state_dict_from_jax(
        jgrads["gen"], models["gen"]).items()}}
    want_params = {"gen": {k: v.numpy() for k, v in state_dict_from_jax(
        js.gen_params, models["gen"]).items()}}
    for key in ("patch", "multibin"):
        stats = js.disc_stats[key]
        want_params[key] = {k: v.numpy() for k, v in state_dict_from_jax(
            js.disc_params[key], models[key], stats).items()}
        if train_d:
            want_grads[key] = {
                k: v.numpy() for k, v in state_dict_from_jax(
                    jgrads["disc"][key], models[key], stats).items()
                if k in dict(models[key].named_parameters())}
    for model, grads in want_grads.items():
        for n, g in grads.items():
            tol = 1e-4 * max(1.0, float(np.abs(g).max()))
            np.testing.assert_allclose(got["grads"][model][n], g, rtol=0, atol=tol,
                                       err_msg=f"{grid}/{name} grad {model}.{n}")
    for model, sd in want_params.items():
        for k, v in sd.items():
            np.testing.assert_allclose(got["params"][model][k], v, rtol=0, atol=3e-4,
                                       err_msg=f"{grid}/{name} param {model}.{k}")
    check_updates(name, got, {"grads": want_grads, "params": want_params}, init,
                  _lrs(cfg_d, train_d))
    np.testing.assert_allclose(got["lecam"], (float(js.lecam.ema_real),
                                              float(js.lecam.ema_fake)), rtol=0, atol=3e-4)
