"""The data-parallel GAN step on two gloo ranks (CPU) against the one-process
port step on the whole batch and against the JAX step on an ``n_data=2``
mesh of the conftest's virtual devices, at the tiny config of
tests/test_torch_gan_step.py, dropout and FSQ noise inert, from the same
seeded JAX init trees.

The batch is ragged and split unevenly: rank 0's rows hold 120 valid
frames, rank 1's 40 (two of them zero-length fill rows), so a rank that
divides by its own count gets another loss and another gradient. Three
steps of each variant (warmup; GAN; GAN + feature matching; GAN + feature
matching with ``grad_accum 2``). Against the one-process step: losses
within 1e-6 relative, the first step's gradients within 1e-5 * max(1,
max|g|), parameters after three steps within 3e-4, each weight's update
within lr / 10 where its gradient is live, LeCam within 1e-6; the ranks end
bit-equal. Against JAX: tests/test_torch_gan_step.py's gates. The teeth:
the same run with rank-local denominators (what a DDP-style average
computes) breaks the one-process gates."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from mqgan_tpu_torch.core.config import TrainConfig
from mqgan_tpu_torch.parallel import multihost
from mqgan_tpu_torch.parallel.dp import DataParallel, all_reduce_
from mqgan_tpu_torch.parallel.mesh import batch_rows
from mqgan_tpu_torch.train.state import create_train_state
from mqgan_tpu_torch.train.step import build_models, make_train_step

MEL, T, STEPS = 16, 32, 3
LENGTHS = np.array([32, 32, 24, 32, 16, 0, 24, 0], np.int32)
# name: (train_d, use_fm, grad_accum, rank-local denominators)
VARIANTS = {"warmup": (False, False, 1, False), "gan": (True, False, 1, False),
            "gan_fm": (True, True, 1, False), "gan_fm_accum2": (True, True, 2, False),
            "gan_fm_local": (True, True, 1, True)}
MODELS = ("gen", "patch", "multibin")


class RankLocal(DataParallel):
    """What a DDP-style average computes: each rank's loss denominators
    count its own rows, and the gradients and loss metrics are averaged
    over the ranks (the LeCam sums stay summed)."""

    def count_lengths(self, lengths):
        return lengths

    def reduce_grads_(self, params):
        params = list(params)
        nbytes = super().reduce_grads_(params)
        torch._foreach_div_([p.grad for p in params], float(self.world))
        return nbytes

    def reduce_metrics_(self, tensors):
        tensors = list(tensors)
        nbytes = all_reduce_(tensors)
        torch._foreach_div_(tensors, float(self.world))
        return nbytes


def run_steps(cfg_d, weights, mel, lengths, train_d, grad_accum, dp):
    """STEPS steps of the port from ``weights`` (numpy state_dicts);
    returns the metrics of each step, the first step's gradients (after
    the ranks' reduction), the final state_dicts and LeCam."""
    cfg = TrainConfig.from_dict(cfg_d)
    models = build_models(cfg)
    for m, sd in zip(models, weights):
        m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    state = create_train_state(*models, cfg.training, torch.device("cpu"))
    state.dropout_rng = state.fsq_rng = None
    state.replicate_()
    step = make_train_step(cfg, train_d=train_d, grad_accum=grad_accum, dp=dp)
    out = {"metrics": []}
    for i in range(STEPS):
        m = step(state, torch.from_numpy(mel), torch.from_numpy(lengths))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["grads"] = {
                name: {n: (np.zeros(p.shape, np.float32) if p.grad is None
                           else p.grad.numpy().copy())
                       for n, p in mod.named_parameters()}
                for name, mod in zip(MODELS, (state.gen, state.patch, state.multibin))}
    out["params"] = {name: {k: v.numpy().copy() for k, v in mod.state_dict().items()}
                     for name, mod in zip(MODELS, (state.gen, state.patch, state.multibin))}
    out["lecam"] = (float(state.lecam.ema_real), float(state.lecam.ema_fake))
    return out


def _rank(rank, world, device, cases, mel, lengths):
    """One gloo rank: every variant on this rank's rows."""
    torch.set_num_threads(1)
    rows = batch_rows(len(lengths), rank, world)
    return {name: run_steps(cfg_d, weights, mel[rows], lengths[rows], train_d,
                            accum, (RankLocal if local else DataParallel).current())
            for name, (cfg_d, weights, train_d, accum, local) in cases.items()}


def _fail(name, a, b):
    """Is two ranks' run ``a`` outside the one-process gates of ``b``?"""
    try:
        check_one_process(name, a, b)
    except AssertionError:
        return True
    return False


def check_one_process(name, got, want, cfg_d=None):
    for m_got, m_want in zip(got["metrics"], want["metrics"]):
        for key, v in m_want.items():
            assert abs(m_got[key] - v) <= 1e-6 * max(abs(v), 1e-6), (name, key, m_got[key], v)
    for model, grads in want["grads"].items():
        for n, g in grads.items():
            tol = 1e-5 * max(1.0, float(np.abs(g).max()))
            np.testing.assert_allclose(got["grads"][model][n], g, rtol=0, atol=tol,
                                       err_msg=f"{name} grad {model}.{n}")
    for model, sd in want["params"].items():
        for k, v in sd.items():
            np.testing.assert_allclose(got["params"][model][k], v, rtol=0, atol=3e-4,
                                       err_msg=f"{name} param {model}.{k}")
    np.testing.assert_allclose(got["lecam"], want["lecam"], rtol=0, atol=1e-6)


def check_updates(name, got, want, init, lrs):
    """Each weight's update over the run within lr / 10 of the reference's
    where the reference's first gradient is live."""
    for model, grads in want["grads"].items():
        lr = lrs[model]
        for n, g in grads.items():
            live = np.abs(g) > 1e-4 * max(1.0, float(np.abs(g).max()))
            if not live.any():
                continue
            d_got = (got["params"][model][n] - init[model][n])[live]
            d_want = (want["params"][model][n] - init[model][n])[live]
            np.testing.assert_allclose(d_got, d_want, rtol=0, atol=0.1 * lr,
                                       err_msg=f"{name} update {model}.{n}")


def _jax_step(cfg_d, train_d, grad_accum, store):
    """The JAX train step whose optimizers record their gradients in
    ``store`` (the optimizers are built here, not at trace time)."""
    from mqgan_tpu.core import config as jcfg
    from mqgan_tpu.train import step as jstep
    from tests.test_torch_gan_step import _recording

    make_opt = jstep.make_optimizers
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstep, "make_optimizers", lambda c: tuple(
            _recording(tx, store, k) for tx, k in zip(make_opt(c), ("gen", "disc"))))
        return jstep.make_train_step(jcfg.TrainConfig.from_dict(cfg_d),
                                     train_d=train_d, donate=False,
                                     grad_accum=grad_accum)


def _jax_run(fn, cfg_d, variables, mel, lengths, store):
    """STEPS JAX steps on an n_data=2 mesh: the batch sharded over two of
    the conftest's virtual devices, the state replicated."""
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
    mesh = make_mesh(n_data=2)
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


@pytest.fixture(scope="module")
def runs():
    """Every variant on two gloo ranks, in one process, and in JAX on the
    mesh (the JAX steps compile in threads while the ranks run); the
    shared init weights."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from mqgan_tpu_torch.utils.params import state_dict_from_jax
    from tests.test_torch_gan_step import jax_init, tiny_config_dict

    rng = np.random.default_rng(11)
    mel = rng.standard_normal((len(LENGTHS), T, MEL)).astype(np.float32)
    mel *= (np.arange(T)[None, :, None] < LENGTHS[:, None, None])
    cases, init, by_fm = {}, {}, {}
    for name, (train_d, use_fm, accum, local) in VARIANTS.items():
        cfg_d = tiny_config_dict(use_fm=use_fm)
        if use_fm not in by_fm:
            _, variables, _ = jax_init(cfg_d, jnp.asarray(mel), jnp.asarray(LENGTHS))
            models = build_models(TrainConfig.from_dict(cfg_d))
            weights = [{k: v.numpy() for k, v in state_dict_from_jax(
                            tree["params"], mod, tree.get("batch_stats")).items()}
                       for tree, mod in zip(jax.device_get(variables), models)]
            by_fm[use_fm] = (variables, weights)
        variables, weights = by_fm[use_fm]
        cases[name] = (cfg_d, weights, train_d, accum, local)
        init[name] = (variables, dict(zip(MODELS, weights)))
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(5) as pool:
        # JAX's dropout inert, as tests/test_train_step.py does
        mp.setattr(fnn.Dropout, "__call__",
                   lambda self, x, deterministic=None, rng=None: x)
        ranks = pool.submit(multihost.launch, _rank, ["cpu", "cpu"],
                            (cases, mel, LENGTHS), timeout_s=120, group_timeout_s=60)
        jax_runs = {}
        for name, (cfg_d, _, train_d, accum, local) in cases.items():
            if not local:
                store = {}
                fn = _jax_step(cfg_d, train_d, accum, store)
                jax_runs[name] = pool.submit(_jax_run, fn, cfg_d, init[name][0],
                                             mel, LENGTHS, store)
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            one = {name: run_steps(cfg_d, weights, mel, LENGTHS, train_d, accum, None)
                   for name, (cfg_d, weights, train_d, accum, local) in cases.items()
                   if not local}
        finally:
            torch.set_num_threads(n)
        ranks = ranks.result()
        jax_runs = {name: f.result() for name, f in jax_runs.items()}
    return {"cases": cases, "init": init, "ranks": ranks, "one": one, "mel": mel,
            "jax": jax_runs}


def _lrs(cfg_d, train_d):
    cfg = TrainConfig.from_dict(cfg_d).training
    lr_d = cfg.lr * cfg.lr_d_factor if train_d else 0.0
    return {"gen": cfg.lr * min(1.0, 1.0 / cfg.warmup_steps),
            "patch": lr_d, "multibin": lr_d}


@pytest.mark.parametrize("name", ["warmup", "gan", "gan_fm", "gan_fm_accum2"])
def test_two_ranks_equal_one_process(runs, name):
    got, other = runs["ranks"][0][name], runs["ranks"][1][name]
    want = runs["one"][name]
    cfg_d, _, train_d, _, _ = runs["cases"][name]
    check_one_process(name, got, want)
    check_updates(name, got, want, runs["init"][name][1], _lrs(cfg_d, train_d))
    for model, sd in got["params"].items():  # the ranks end bit-equal
        for k, v in sd.items():
            assert np.array_equal(other["params"][model][k], v), (name, model, k)
    assert got["metrics"] == other["metrics"]


def test_rank_local_denominators_break_the_gates(runs):
    """What a DDP-style average computes (each rank's own masked means,
    gradients averaged) is not the one-process step on this batch."""
    local = runs["ranks"][0]["gan_fm_local"]
    want = runs["one"]["gan_fm"]
    assert _fail("gan_fm_local", local, want)
    # and the losses of the first step are already off
    got_l, want_l = local["metrics"][0], want["metrics"][0]
    assert abs(got_l["loss_recon_pre"] - want_l["loss_recon_pre"]) > 1e-3 * want_l["loss_recon_pre"]


@pytest.mark.parametrize("name", ["warmup", "gan", "gan_fm", "gan_fm_accum2"])
def test_two_ranks_equal_the_jax_mesh_step(runs, name):
    from mqgan_tpu_torch.utils.params import state_dict_from_jax

    cfg_d, _, train_d, _, _ = runs["cases"][name]
    init = runs["init"][name][1]
    js, jmetrics, jgrads = runs["jax"][name]
    got = runs["ranks"][0][name]
    for m_got, m_want in zip(got["metrics"], jmetrics):
        for key in ("loss_g_total", "loss_recon_pre", "loss_recon_post", "loss_gan",
                    "loss_fm", "loss_d", "codebook_usage", "codebook_perplexity",
                    "learning_rate"):
            want = m_want[key]
            assert abs(m_got[key] - want) <= 1e-5 * max(abs(want), 1e-6) + 1e-12, (
                name, key, m_got[key], want)
    cfg = TrainConfig.from_dict(cfg_d)
    models = dict(zip(MODELS, build_models(cfg)))
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
                                       err_msg=f"{name} grad {model}.{n}")
    for model, sd in want_params.items():
        for k, v in sd.items():
            np.testing.assert_allclose(got["params"][model][k], v, rtol=0, atol=3e-4,
                                       err_msg=f"{name} param {model}.{k}")
    check_updates(name, got, {"grads": want_grads, "params": want_params}, init,
                  _lrs(cfg_d, train_d))
    np.testing.assert_allclose(got["lecam"], (float(js.lecam.ema_real),
                                              float(js.lecam.ema_fake)), rtol=0, atol=3e-4)
    assert bool(js.lecam.initialized) == train_d

