"""The port's GAN train step against the JAX package's, on a tiny config:
one warmup step, one GAN step and one GAN step with feature matching, each
for three steps from the same JAX init trees, with dropout and FSQ noise
inert on both sides (JAX: rates 0 and flax's Dropout patched to the
identity, as tests/test_train_step.py does; the port: rates 0 and no
generator). Loss terms within 1e-5 relative and the first step's
gradients within 1e-4 * max(1, max|g|); parameters, spectral-norm stats and
LeCam after three steps at lr 1e-4 within 3e-4 (Adam turns a gradient that
is 0 up to rounding into a +-lr step); and each side's update over the three
steps (weights minus their init) within a tenth of its first step's learning
rate of JAX's, on the weights whose first gradient is not 0 up to that
rounding, so that an optimizer that does not step fails."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqgan_tpu.core import config as jcfg
from mqgan_tpu.train import state as jstate
from mqgan_tpu.train import step as jstep
from mqgan_tpu_torch.core.config import TrainConfig
from mqgan_tpu_torch.train.state import create_train_state
from mqgan_tpu_torch.train.step import build_models, make_train_step
from mqgan_tpu_torch.utils.params import state_dict_from_jax

MEL, T, B = 16, 32, 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's side: these shapes gain nothing
    from more, and the suite's parallel workers share the machine's cores.
    Restored after each test (the other test files' setting stays)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_config_dict(use_fm=False, **gen_kw):
    """tests/test_train_step.py's tiny config as a YAML-shaped dict, with
    dropout and FSQ noise at rate 0."""
    patch_hidden = [4, 4, 8] if use_fm else [4, 8]
    mb_hidden = [4, 4, 4] if use_fm else [4, 4]
    gen = dict(channels=[8, 12], kernel_sizes=[3], dropout=0.0,
               fsq_levels=[8, 5, 5, 5], fsq_noise_dropout=0.0,
               refiner_base_channels=4, refiner_depth=2)
    gen.update(gen_kw)
    return {
        "data": {"crop_len": [T], "batch_size": B},
        "model": {
            "mel_channels": MEL, "generator": gen,
            "discriminator_patch": {
                "hidden_channels": patch_hidden,
                "kernel_sizes": [3] * (len(patch_hidden) + 1),
                "strides": [[1, 2]] + [[2, 2]] * (len(patch_hidden) - 1) + [[1, 1]]},
            "discriminator_multibin": {
                "hidden_channels": mb_hidden,
                "kernel_sizes": [3] * (len(mb_hidden) + 1),
                "n_bins": 2, "n_no_strides": 1},
        },
        "training": {"warmup_steps": 10, "use_fm_loss": use_fm,
                     "discriminator_train_start_epoch": 2},
    }


def seeded_tree(abstract, seed):
    """Numpy weights for an init tree's shapes (``jax.eval_shape`` of the
    models' init: tracing, no compile): normal kernels with variance
    1/fan_in, weight-norm g = ||v||, small biases, APTx beta 1 gamma 0.5,
    spectral-norm u normal and sigma 1."""
    rng = np.random.default_rng(seed)

    def fill(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = fill(v)
            elif k in ("kernel", "v", "embedding"):
                fan_in = int(np.prod(v.shape[:-1])) or 1
                out[k] = (rng.standard_normal(v.shape) / np.sqrt(fan_in)).astype(np.float32)
            elif k == "bias":
                out[k] = (0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            elif k.endswith("/u"):
                out[k] = rng.standard_normal(v.shape).astype(np.float32)
            else:  # g, beta, gamma, sigma: set below
                out[k] = np.ones(v.shape, np.float32)
        if "v" in out and "g" in out:
            axes = tuple(range(out["v"].ndim - 1))
            out["g"] = np.sqrt((out["v"] ** 2).sum(axis=axes)).astype(np.float32)
        if "gamma" in out:
            out["gamma"] = np.full_like(out["gamma"], 0.5)
        return out

    return fill(abstract)


def jax_init(cfg_d, mel, lengths):
    """The JAX config, the models' weights (seeded numpy trees in the shapes
    of their init) and a fresh TrainState."""
    cfg = jcfg.TrainConfig.from_dict(cfg_d)
    variables = []
    for i, model in enumerate(jstep.build_models(cfg)):
        shapes = jax.eval_shape(model.init, jax.random.key(0), mel, lengths)
        variables.append(seeded_tree(jax.tree.map(lambda x: x, shapes), i))
    gv, pv, mv = variables
    state, _, _ = jstate.create_train_state(
        gen_variables=gv, patch_variables=pv, multibin_variables=mv,
        training_cfg=cfg.training, rng=jax.random.key(3))
    return cfg, (gv, pv, mv), state


def port_state(cfg_d, variables, grad_accum_ok=True):
    """The port's TrainState with the JAX init weights, dropout inert."""
    cfg = TrainConfig.from_dict(cfg_d)
    gen, patch, mb = build_models(cfg)
    gv, pv, mv = jax.device_get(variables)
    gen.load_state_dict(state_dict_from_jax(gv["params"], gen))
    patch.load_state_dict(state_dict_from_jax(pv["params"], patch, pv["batch_stats"]))
    mb.load_state_dict(state_dict_from_jax(mv["params"], mb, mv["batch_stats"]))
    state = create_train_state(gen, patch, mb, cfg.training, torch.device("cpu"))
    state.dropout_rng = state.fsq_rng = None
    return cfg, state


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((B, T, MEL)).astype(np.float32)
    lengths = np.array([T, T - 5, T, T - 1], np.int32)
    return mel, lengths


def _recording(tx, store, key):
    """An optax transformation that is ``tx`` and also records the
    gradients it is given (through a host callback)."""
    import optax

    def update(updates, state, params=None):
        jax.debug.callback(
            lambda u: store.__setitem__(key, jax.tree.map(np.asarray, u)), updates)
        return tx.update(updates, state, params)

    return optax.GradientTransformation(tx.init, update)


@pytest.fixture
def inert_jax_dropout(monkeypatch):
    import flax.linen as fnn

    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)


def _grads(module):
    """Each parameter's gradient; none is 0 (the generator's hidden_proj
    feeds only the detached refiner input)."""
    return {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for n, p in module.named_parameters()}


def run_both(train_d, use_fm, monkeypatch, steps=3):
    """Run ``steps`` steps on both sides; returns everything compared."""
    store = {}
    make_opt = jstep.make_optimizers
    monkeypatch.setattr(jstep, "make_optimizers", lambda c: tuple(
        _recording(tx, store, k) for tx, k in zip(make_opt(c), ("gen", "disc"))))
    cfg_d = tiny_config_dict(use_fm=use_fm)
    mel, lengths = inputs()
    jcfg_, variables, js = jax_init(cfg_d, jnp.asarray(mel), jnp.asarray(lengths))
    pcfg, ps = port_state(cfg_d, variables)
    jfn = jstep.make_train_step(jcfg_, train_d=train_d, donate=False)
    pfn = make_train_step(pcfg, train_d=train_d)
    init = {key: {n: p.detach().clone() for n, p in mod.named_parameters()}
            for key, mod in (("gen", ps.gen), ("patch", ps.patch),
                             ("multibin", ps.multibin))}
    history = []
    for i in range(steps):
        js, jm = jfn(js, jnp.asarray(mel), jnp.asarray(lengths))
        pm = pfn(ps, torch.from_numpy(mel), torch.from_numpy(lengths))
        grads = {"gen": _grads(ps.gen)}
        if train_d:
            grads["disc"] = {**{f"patch.{n}": g for n, g in _grads(ps.patch).items()},
                             **{f"multibin.{n}": g
                                for n, g in _grads(ps.multibin).items()}}
        history.append((jax.device_get(jm), pm, dict(store), grads))
    return jcfg_, js, ps, history, init


def _close(got, want, tol, what):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=0, err_msg=what)


def check_updates(ps, init, want_params, want_grads, lr, what):
    """The port's update of each weight (final minus init) against JAX's
    within lr / 10, leaving out the weights whose first-step gradient is
    within the gradient gate of 0 (Adam's step there has the rounding's
    sign)."""
    for name, p in ps.named_parameters():
        g = want_grads[name].float()
        live = g.abs() > 1e-4 * max(1.0, float(g.abs().max()))
        if not bool(live.any()):
            continue
        got = (p.detach() - init[name])[live]
        want = (want_params[name] - init[name])[live]
        _close(got, want, 0.1 * lr, f"{what} update {name}")


def check_step(js, ps, history, train_d, init, cfg):
    for jm, pm, _, _ in history:
        for key in ("loss_g_total", "loss_recon_pre", "loss_recon_post",
                    "loss_gan", "loss_fm", "loss_d", "codebook_usage",
                    "codebook_perplexity", "learning_rate"):
            want = float(jm[key])
            got = float(pm[key])
            assert abs(got - want) <= 1e-5 * max(abs(want), 1e-6) + 1e-12, (key, got, want)
    # the first step's gradients (both sides start from the same weights)
    _, _, jgrads, pgrads = history[0]
    want_gen = state_dict_from_jax(jgrads["gen"], ps.gen)
    for name, g in pgrads["gen"].items():
        w = want_gen[name]
        _close(g, w, 1e-4 * max(1.0, float(w.abs().max())), f"grad {name}")
    if train_d:
        # (the stats only complete the tree: no gradient is read from them)
        stats = jax.device_get(js.disc_stats)
        want_d = {f"{key}.{k}": v for key, mod in (("patch", ps.patch),
                                                   ("multibin", ps.multibin))
                  for k, v in state_dict_from_jax(jgrads["disc"][key], mod,
                                                  stats[key]).items()}
        for name, g in pgrads["disc"].items():
            w = want_d[name]
            _close(g, w, 1e-4 * max(1.0, float(w.abs().max())), f"grad {name}")
    # parameters, spectral stats and LeCam after the last step
    params = jax.device_get(js.gen_params)
    want_gen_params = state_dict_from_jax(params, ps.gen)
    for name, v in want_gen_params.items():
        _close(ps.gen.state_dict()[name], v, 3e-4, f"param {name}")
    lr = cfg.training.lr
    check_updates(ps.gen, init["gen"], want_gen_params, want_gen,
                  lr * min(1.0, 1.0 / cfg.training.warmup_steps), "gen")
    for key, mod in (("patch", ps.patch), ("multibin", ps.multibin)):
        want = state_dict_from_jax(jax.device_get(js.disc_params[key]), mod,
                                   jax.device_get(js.disc_stats[key]))
        for name, v in want.items():
            _close(mod.state_dict()[name], v, 3e-4, f"{key} {name}")
        if train_d:
            check_updates(mod, init[key], want,
                          {n: want_d[f"{key}.{n}"] for n, _ in mod.named_parameters()},
                          lr * cfg.training.lr_d_factor, key)
    for field in ("ema_real", "ema_fake"):
        _close(getattr(ps.lecam, field), getattr(js.lecam, field), 3e-4, field)
    assert bool(ps.lecam.initialized) == bool(js.lecam.initialized) == train_d
    assert ps.step == int(js.step) == len(history)


@pytest.mark.parametrize("train_d,use_fm", [(False, False), (True, False),
                                            (True, True)],
                         ids=["warmup", "gan", "gan_fm"])
def test_step_matches_jax(train_d, use_fm, monkeypatch, inert_jax_dropout):
    cfg, js, ps, history, init = run_both(train_d, use_fm, monkeypatch)
    check_step(js, ps, history, train_d, init, cfg)
