"""PyTorch port: MelMixer2D (plain version of the mixer kernel, and the
Chebyshev poly path) against the JAX package (fp32, CPU); the wrappers'
checks and routes; and the kernels' arithmetic (csrc/mel_mixer.cu) replayed
in torch against the plain versions."""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqgan_tpu.core.masking import sequence_mask
from mqgan_tpu.nn.mixer2d import MelMixer2D as JaxMixer
from mqgan_tpu.ops.mixer_poly import poly_mixer_apply as jax_poly_apply
from mqgan_tpu_torch.nn.mixer2d import MelMixer2D
from mqgan_tpu_torch.ops import _cuda, mixer_kernels, mixer_poly
from mqgan_tpu_torch.ops.mixer_kernels import MixerWeights, mel_mixer_plain
from mqgan_tpu_torch.ops.mixer_poly import fused_poly_mixer, poly_mixer_apply
from mqgan_tpu_torch.utils.params import state_dict_from_jax
from tests.test_torch_bridge import max_err, perturb, to_numpy_tree

TOL = 1e-4
B, T, C, P = 3, 37, 128, 32
LENGTHS = (T, 20, 1)


def _setup(rng, **jax_kw):
    x = (rng.standard_normal((B, T, C)) * 0.5).astype(np.float32)
    mask = sequence_mask(T, jnp.asarray(LENGTHS))
    jmod = JaxMixer(features=P, **jax_kw)
    tree = perturb(to_numpy_tree(
        jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), mask, True)), rng)
    return x, mask, jmod, tree


def _port(tree, **kw):
    mod = MelMixer2D(P, **kw)
    mod.load_state_dict(state_dict_from_jax(tree, mod))
    return mod


def test_exact_mixer_matches_jax_xla_and_pallas(rng):
    x, mask, jmod, tree = _setup(rng)
    xla = np.asarray(jmod.apply({"params": tree}, jnp.asarray(x), mask, True))
    pallas = np.asarray(JaxMixer(features=P, fused=True).apply(
        {"params": tree}, jnp.asarray(x), mask, True))
    with torch.no_grad():
        got = _port(tree)(torch.from_numpy(x),
                          torch.from_numpy(np.array(mask))).numpy()
    print(f"max err vs XLA {max_err(got, xla):.3e}, "
          f"vs Pallas {max_err(got, pallas):.3e}")
    np.testing.assert_allclose(got, xla, atol=TOL)
    np.testing.assert_allclose(got, pallas, atol=TOL)
    # padded rows are exactly the conv_out bias
    np.testing.assert_array_equal(
        got[np.asarray(mask)], np.float32(tree["conv_out"]["bias"][0]))


def test_plain_mixer_time_chunks_do_not_change_the_result(rng, monkeypatch):
    x, mask, _, tree = _setup(rng)
    mod = _port(tree)
    args = (torch.from_numpy(x), torch.from_numpy(np.array(mask)))
    with torch.no_grad():
        whole = mod(*args)
        # one frame of hidden per chunk: 37 chunks
        monkeypatch.setattr(mixer_kernels, "HIDDEN_CHUNK_BYTES", B * C * P * 4)
        chunked = mod(*args)
    torch.testing.assert_close(chunked, whole, atol=1e-6, rtol=1e-6)


def test_poly_mixer_apply_matches_jax(rng):
    z = (rng.standard_normal((B, T, C)) * 0.7).astype(np.float32)
    mask = np.arange(T)[None, :] >= np.asarray(LENGTHS)[:, None]
    z[mask] = 0.0
    w1 = rng.standard_normal(P).astype(np.float32)
    b1 = (rng.standard_normal(P) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal(P) * 0.2).astype(np.float32)
    b2 = np.float32(0.05)
    want = np.asarray(jax_poly_apply(jnp.asarray(z), jnp.asarray(mask),
                                     jnp.asarray(w1), jnp.asarray(b1),
                                     jnp.asarray(w2), jnp.asarray(b2)))
    got = poly_mixer_apply(torch.from_numpy(z), torch.from_numpy(mask),
                           *(torch.from_numpy(a) for a in (w1, b1, w2)),
                           torch.tensor(b2)).numpy()
    print(f"max err vs JAX poly {max_err(got, want):.3e}")
    np.testing.assert_allclose(got, want, atol=TOL)


def test_poly_mixer_module_matches_jax(rng):
    x, mask, jmod, tree = _setup(rng, poly_approx=True)
    want = np.asarray(jmod.apply({"params": tree}, jnp.asarray(x), mask, True))
    with torch.no_grad():
        got = _port(tree, poly_approx=True)(
            torch.from_numpy(x), torch.from_numpy(np.array(mask))).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("poly", [False, True])
def test_mixer_training_mode_raises(poly):
    with pytest.raises(NotImplementedError):
        MelMixer2D(4, poly_approx=poly)(torch.zeros(1, 4, 8),
                                        deterministic=False)


# --- the Chebyshev mode from the mixer's input, against JAX's module


def _jax_and_port(rng, p, x, lengths, **kw):
    """JAX's MelMixer2D output and the port's module on the same perturbed
    weights (features p)."""
    t = x.shape[1]
    mask = sequence_mask(t, jnp.asarray(lengths))
    jmod = JaxMixer(features=p, **kw)
    tree = perturb(to_numpy_tree(
        jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), mask, True)), rng)
    want = np.asarray(jmod.apply({"params": tree}, jnp.asarray(x), mask, True))
    mod = MelMixer2D(p, poly_approx=kw.get("poly_approx", False))
    mod.load_state_dict(state_dict_from_jax(tree, mod))
    return want, mod, tree


@pytest.mark.parametrize("case", ["ragged", "all_equal", "p384"])
def test_poly_plain_from_input_matches_jax(rng, case):
    """fused_poly_mixer on CPU tensors (the plain poly_mixer_plain) against
    JAX's MelMixer2D(poly_approx=True): ragged lengths down to one frame, a
    plane whose masked values are all equal (half clamps to 1e-6), P=384."""
    p, lengths = P, LENGTHS
    x = (rng.standard_normal((B, T, C)) * 0.5).astype(np.float32)
    if case == "all_equal":
        x[:] = 0.0  # every frame valid: the plane is the dw bias everywhere
        lengths = (T,) * B
    if case == "p384":
        p, lengths = 384, (T, 9, 1)
    want, mod, tree = _jax_and_port(rng, p, x, lengths, poly_approx=True)
    lens = torch.tensor(lengths, dtype=torch.int32)
    with torch.no_grad():
        w = mod.kernel_weights()
        got = fused_poly_mixer(torch.from_numpy(x), lens, w).numpy()
        if case == "all_equal":
            s = torch.nn.functional.conv2d(
                torch.from_numpy(x)[:, None], w.dwk[None, None], w.consts[:1],
                padding=2)
            assert float(s.max() - s.min()) == 0.0
    print(f"{case}: max err vs JAX poly module {max_err(got, want):.3e}")
    np.testing.assert_allclose(got, want, atol=TOL)
    pad = np.arange(T)[None, :] >= np.asarray(lengths)[:, None]
    np.testing.assert_array_equal(
        got[pad], np.float32(tree["conv_out"]["bias"][0]))


def test_exact_plain_matches_jax_at_p384_ragged(rng):
    x = (rng.standard_normal((B, T, C)) * 0.5).astype(np.float32)
    lengths = (T, 9, 1)
    want, mod, _ = _jax_and_port(rng, 384, x, lengths)
    with torch.no_grad():
        got = mel_mixer_plain(torch.from_numpy(x),
                              torch.tensor(lengths, dtype=torch.int32),
                              mod.kernel_weights()).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_poly_module_on_cpu_routes_to_the_plain_version(monkeypatch):
    calls = []
    plain = mixer_poly.poly_mixer_plain

    def spy(*args, **kw):
        calls.append(args[0].device.type)
        return plain(*args, **kw)

    monkeypatch.setattr(mixer_poly, "poly_mixer_plain", spy)
    _cuda.COUNTERS.reset()
    with torch.no_grad():
        out = MelMixer2D(8, poly_approx=True)(torch.randn(2, 6, 16))
    assert calls == ["cpu"] and out.shape == (2, 6, 16)
    assert _cuda.COUNTERS.snapshot() == {}


def _weights(k=5, p=8):
    return MixerWeights(dwk=torch.ones(k, k), consts=torch.zeros(4),
                        w1=torch.ones(p), b1=torch.zeros(p), w2=torch.ones(p))


@pytest.mark.parametrize("call", [
    "exact_taps_even", "exact_taps_9", "exact_p_4096", "exact_p_0",
    "exact_meta_device", "poly_taps_9", "poly_degree_0", "poly_degree_1024",
    "poly_meta_device"])
def test_mixer_wrappers_raise_outside_the_kernels(call):
    mode, _, what = call.partition("_")
    x = torch.zeros(1, 4, 8)
    lengths = torch.tensor([4], dtype=torch.int32)
    w, kw = _weights(), {}
    if what == "taps_even":
        w = _weights(k=4)
    elif what == "taps_9":
        w = _weights(k=9)
    elif what == "p_4096":
        w = _weights(p=4096)
    elif what == "p_0":
        w = _weights(p=0)
    elif what == "degree_0":
        kw = {"degree": 0}
    elif what == "degree_1024":
        kw = {"degree": 1024}
    elif what == "meta_device":
        x = x.to("meta")
    fn = mixer_kernels.fused_mel_mixer if mode == "exact" else fused_poly_mixer
    with pytest.raises(ValueError):
        fn(x, lengths, w, **kw)


# --- the kernels' arithmetic, replayed in torch (the card's approximate ex2
# and rcp are taken as exact here; the kernel's own error is held on the
# card by chip_smoke.py)

TWO_LOG2E = np.float32(2.0 / math.log(2.0))


def _fma(a, b, c):
    """fp32 fused multiply-add (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _rcp_newton(h):
    r = _fma(torch.full_like(h, -32.0 / 17.0), h, torch.full_like(h, 48.0 / 17.0))
    e = _fma(-h, r, torch.ones_like(h))
    r = _fma(r, e, r)
    e = _fma(-h, r, torch.ones_like(h))
    return _fma(r, _fma(e, e, e), r)


def _zs_tanh(zs, sfu):
    a = zs.abs()
    u = torch.exp2(-a)
    h = _fma(torch.full_like(u, 0.5), u, torch.full_like(u, 0.5))
    r = 1.0 / h if sfu else _rcp_newton(h)
    return a * (r - 1.0)


def test_mixer_newton_reciprocal_is_fp32_accurate():
    h = torch.linspace(0.5, 1.0, 100_001, dtype=torch.float32)
    rel = ((_rcp_newton(h).double() * h.double()) - 1.0).abs().max()
    assert float(rel) <= 2.0 ** -22


@pytest.mark.parametrize("sfu", [True, False])
def test_mixer_z_tanh_z_evaluation_within_its_budget(sfu):
    z = torch.linspace(-12.0, 12.0, 200_001, dtype=torch.float32)
    z = torch.cat([z, torch.tensor([0.0, 1e-30, -1e-7, 80.0, -200.0])])
    got = _zs_tanh((TWO_LOG2E * z.double()).float(), sfu).double() / float(TWO_LOG2E)
    want = z.double() * torch.tanh(z.double())
    err = (got - want).abs()
    assert bool((err <= z.double().abs() * 2.0 ** -20 + 1e-30).all()), float(err.max())


def _kernel_const(name):
    src = (Path(mixer_poly.__file__).parents[1] / "csrc" / "mel_mixer.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("taps", [3, 5, 7])
def test_exact_kernel_decomposition_matches_plain(rng, taps):
    """The kernel's prescaled weights (2 log2e w1, 2 log2e b1, w2 / 2 log2e),
    |zs| (r - 1) per evaluation and the rows' reciprocal split (kSfuRows of
    a thread's kRows consecutive frames through the SFU), replayed against
    mel_mixer_plain at tap counts the kernel is built for."""
    x, mask, _, tree = _setup(rng, kernel_size=taps)
    mod = _port(tree, kernel_size=taps)
    w = mod.kernel_weights()
    xt = torch.from_numpy(x)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    with torch.no_grad():
        want = mel_mixer_plain(xt, lengths, w)
        k = w.dwk.shape[0]
        s = torch.nn.functional.conv2d(xt[:, None], w.dwk[None, None],
                                       padding=k // 2)[:, 0] + w.consts[0]
        valid = (torch.arange(T)[None, :] < lengths[:, None]).float()[..., None]
        s = s * valid
        w1s, b1s = TWO_LOG2E * w.w1, TWO_LOG2E * w.b1
        w2s = w.w2 / TWO_LOG2E
        rows, sfu_rows = _kernel_const("kRows"), _kernel_const("kSfuRows")
        # a thread's row r is frame t0 + kRows threadIdx.y + r
        sfu_frame = (torch.arange(T) % rows) < sfu_rows
        acc = torch.zeros_like(s)
        for p in range(P):
            zs = _fma(w1s[p].expand_as(s), s, b1s[p].expand_as(s))
            q = torch.where(sfu_frame[None, :, None], _zs_tanh(zs, True),
                            _zs_tanh(zs, False))
            acc = _fma(w2s[p].expand_as(q), q, acc)
        a_lin, b_lin = w.consts[2], w.consts[3]
        got = (a_lin * s + b_lin + 0.5 * acc) * valid + w.consts[1]
    assert 0 < sfu_rows < rows and w.dwk.shape == (taps, taps)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_poly_kernel_clenshaw_form_matches_plain(rng):
    """The last pass's recurrence, b1 <- fma(2t, b1, c_k - b2) and fma(t,
    b1, c_0 - b2), against the plain _clenshaw on a degree-160 fit."""
    z = torch.from_numpy((rng.standard_normal(4096) * 0.7).astype(np.float32))
    w1, b1, w2 = (torch.from_numpy(rng.standard_normal(P).astype(np.float32) * s)
                  for s in (1.0, 0.1, 0.2))
    nodes = torch.cos((torch.arange(4096) + 0.5) * (math.pi / 4096))
    coef = mixer_poly._chebyshev_fit(
        mixer_poly.mixer_scalar_g(nodes, w1, b1, w2, 0.05), 160)
    t = nodes.roll(1) * 0.9 + 0.05 * z.tanh()  # points of [-1, 1]
    two_t = 2.0 * t
    c1, c2 = torch.zeros_like(t), torch.zeros_like(t)
    for kk in range(160, 0, -1):
        c1, c2 = _fma(two_t, c1, coef[kk] - c2), c1
    got = _fma(t, c1, coef[0] - c2)
    want = mixer_poly._clenshaw(t, coef)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_mixer_tile_constants_match_the_kernel_source():
    const = _kernel_const
    assert const("kRowGroups") * const("kRows") == mixer_poly.TILE_T
    assert const("kTileC") == mixer_poly.TILE_C
    assert const("kMaxCoef") - 1 == mixer_poly.MAX_POLY_DEGREE
    assert 2 * const("kMaxPad") + 1 == mixer_kernels.MAX_DW_K


def test_sass_loop_counts_reads_the_inner_loop():
    """chip_smoke.py phase 2's reader of ``cuobjdump -sass``: the loop of a
    backward branch with the most MUFU.EX2 (exact) or FFMA (Chebyshev), per
    evaluation, and the template variant from the mangled name."""
    from chip_smoke import sass_loop_counts

    sass = """
        Function : _ZN12_GLOBAL__N_116mel_mixer_kernelI13__nv_bfloat16Li5EEEvPKT_
        /*0000*/                   LDC R1, c[0x0][0x28] ;  /* 0x00000a00ff017b82 */
.L_x_1:
        /*0010*/                   FFMA R2, R3, R4, R5 ;  /* 0x0 */
        /*0020*/              @P1 BRA `(.L_x_1) ;  /* 0x0 */
.L_x_3:
        /*0030*/                   LDS.128 R4, [R2] ;  /* 0x0 */
        /*0040*/                   FFMA R5, R4, R3, R6 ;  /* 0x0 */
        /*0050*/                   MUFU.EX2 R7, -|R5| ;  /* 0x0 */
        /*0060*/                   FFMA R8, R7, 0.5, 0.5 ;  /* 0x0 */
        /*0070*/                   MUFU.RCP R9, R8 ;  /* 0x0 */
        /*0080*/                   FADD.FTZ R9, R9, -1 ;  /* 0x0 */
        /*0090*/                   FMUL R9, |R5|, R9 ;  /* 0x0 */
        /*00a0*/                   FFMA R10, R6, R9, R10 ;  /* 0x0 */
        /*00b0*/              @P0 BRA `(.L_x_3) ;  /* 0x0 */
        /*00c0*/                   EXIT ;
        Function : _ZN12_GLOBAL__N_116poly_eval_kernelIfEEvPKT_
        /*0000*/                   LDS R4, [R2] ;  /* 0x0 */
        /*0010*/                   FADD R5, R4, -R3 ;  /* 0x0 */
        /*0020*/                   FFMA R6, R7, R6, R5 ;  /* 0x0 */
        /*0030*/              @P0 BRA 0x0 ;  /* 0x0 */
"""
    (kind, variant, evals, counts, ops), poly = sass_loop_counts(sass)
    assert (kind, variant, evals) == ("exact", "bf16 taps=5", 1)
    assert counts == {"MUFU.EX2": 1, "MUFU.RCP": 1, "MUFU other": 0, "FP32": 5,
                      "other": 2}
    assert ops["MUFU"] == 2 and ops["LDS"] == 1
    assert poly[:3] == ("poly", "fp32", 1) and poly[3]["FP32"] == 2
