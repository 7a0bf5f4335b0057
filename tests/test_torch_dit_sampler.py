"""The port's DiT, schedule and DDPM sampler against the JAX package.

Tolerances: fp32 2e-5 (same math, another summation order); the bf16
forward 5e-2 relative to the output scale (bf16 rounds at other places in
the two frameworks).

The block stack regrouped for kernel E (``dit.glue_blocks``: each GEMM or
attention output through one ``ops.dit_glue`` function, a block's last
residual add paired with the next block's norm1) runs the eager ops on the
CPU and gives ``dit_block``'s stack bit for bit; ``dit.glue_fused`` sends
the CPU, grad with operands that require it, a model-split mesh and
dropout to the eager stack, and raises where it would take E at widths E
does not take."""

from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ditto_tts_tpu.core.config import DiTConfig
from ditto_tts_tpu.diffusion import sampler as jsampler
from ditto_tts_tpu.diffusion import schedule as jschedule
from ditto_tts_tpu.models import dit as jdit
from ditto_tts_tpu.nn import core as jcore
from ditto_tts_tpu.ops import rope as jrope

from ditto_tts_tpu_torch.diffusion import sampler as tsampler
from ditto_tts_tpu_torch.diffusion import schedule as tschedule
from ditto_tts_tpu_torch.models import dit as tdit
from ditto_tts_tpu_torch.nn import core as tcore
from ditto_tts_tpu_torch.ops import rope as trope
from ditto_tts_tpu_torch.params import tree_map

from _torch_port_util import assert_close, jx, to_torch_cfg, tt

SMALL = DiTConfig(hidden_dim=128, num_layers=2, num_heads=2, time_dim=32,
                  text_dim=128, diffusion_steps=100, max_token_length=64)


def _dit_case(cfg, seed=0, b=2, s=24, st=7):
    params = jdit.init_ditto(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.hidden_dim)).astype(np.float32)
    text = rng.standard_normal((b, st, cfg.text_dim)).astype(np.float32)
    t = rng.integers(0, cfg.diffusion_steps, (b,))
    tp = tree_map(lambda a: tt(np.asarray(a)), params)
    return params, tp, x, text, t


@pytest.mark.parametrize("ref_compat", [False, True])
def test_ditto_forward_fp32(ref_compat):
    cfg = SMALL.replace(ref_compat=ref_compat)
    params, tp, x, text, t = _dit_case(cfg)
    want = jdit.ditto_forward(params, cfg, jx(x), jx(text), jx(t))
    got = tdit.ditto_forward(tp, to_torch_cfg(cfg), tt(x), tt(text), tt(t))
    assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_ditto_forward_prepared_equals_unprepared():
    """The per-request hoisting (cast blocks, cross K/V, RoPE) matches the
    JAX scanned path with prepare_blocks + prepare_cross_kv."""
    cfg = SMALL.replace(scan_blocks=True)
    params, tp, x, text, t = _dit_case(cfg, seed=1)
    prep = jdit.prepare_blocks(params, cfg)
    ckv = jdit.prepare_cross_kv(prep, cfg, jx(text))
    want = jdit.ditto_forward(params, cfg, jx(x), jx(text), jx(t),
                              prepared_blocks=prep, cross_kv=ckv)
    tcfg = to_torch_cfg(cfg)
    tprep = tdit.prepare(tp, tcfg, tt(text), x.shape[1])
    got = tdit.ditto_forward(tp, tcfg, tt(x), tt(text), tt(t),
                             prepared=tprep)
    assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_ditto_forward_bf16():
    cfg = SMALL.replace(compute_dtype="bfloat16")
    params, tp, x, text, t = _dit_case(cfg, seed=2)
    want = np.asarray(jdit.ditto_forward(params, cfg, jx(x), jx(text),
                                         jx(t)))
    got = tdit.ditto_forward(tp, to_torch_cfg(cfg), tt(x), tt(text), tt(t))
    assert got.dtype == torch.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-2 * scale)


def test_global_adaln_and_primitives():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = rng.standard_normal((8, 16)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    assert_close(tcore.dense({"weight": tt(w), "bias": tt(b)}, tt(x)),
                 jcore.dense({"weight": jx(w), "bias": jx(b)}, jx(x)),
                 rtol=1e-5, atol=1e-5)
    g = rng.standard_normal(16).astype(np.float32)
    assert_close(tcore.layer_norm({"weight": tt(g), "bias": tt(g)}, tt(x)),
                 jcore.layer_norm({"weight": jx(g), "bias": jx(g)}, jx(x)),
                 rtol=1e-5, atol=1e-5)
    assert_close(tcore.layer_norm({}, tt(x)), jcore.layer_norm({}, jx(x)),
                 rtol=1e-5, atol=1e-5)
    cos, sin = jrope.rope_tables(5, 8)
    tcos, tsin = trope.rope_tables(5, 8)
    xr = x.reshape(2, 5, 2, 8)
    assert_close(trope.apply_rope(tt(xr), tcos, tsin),
                 jrope.apply_rope(jx(xr), cos, sin), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ref_compat", [False, True])
def test_schedule_and_q_sample(ref_compat):
    js = jschedule.NoiseSchedule.cosine(1000)
    ts = tschedule.NoiseSchedule.cosine(1000)
    assert_close(ts.betas, js.betas, rtol=0, atol=0)
    assert_close(ts.alphas_cumprod, js.alphas_cumprod, rtol=1e-5, atol=1e-7)
    rng = np.random.default_rng(4)
    x0 = rng.standard_normal((3, 6, 4)).astype(np.float32)
    nz = rng.standard_normal((3, 6, 4)).astype(np.float32)
    t = np.array([0, 500, 999])
    want = jschedule.q_sample(js, jx(x0), jx(t), jx(nz),
                              ref_compat=ref_compat)
    got = tschedule.q_sample(ts, tt(x0), tt(t), tt(nz),
                             ref_compat=ref_compat)
    assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_respaced_timesteps():
    for n in (1, 4, 50, 1000):
        np.testing.assert_array_equal(
            tsampler.respaced_timesteps(1000, n),
            jsampler.respaced_timesteps(1000, n))


@pytest.mark.parametrize("prediction_type,clip,atol", [
    ("eps", None, 1e-4), ("v", None, 1e-4), ("x0", None, 1e-4),
    ("eps", 1.0, 1e-3)])
def test_ddpm_sample_with_noise_seq(prediction_type, clip, atol):
    """The same toy model and the same per-step noise give the same
    trajectory. The first reverse step divides by sqrt(alpha_t) ~ 1e-2
    (and clip_denoised by sqrt(abar_t) ~ 1.6e-4), which scales fp32
    round-off (~6e-8) to the stated atol, relative to the trajectory's
    scale (the eps toy grows to ~4e3)."""
    rng = np.random.default_rng(5)
    k, b, s, h = 8, 2, 5, 3
    x_init = rng.standard_normal((b, s, h)).astype(np.float32)
    noise = rng.standard_normal((k, b, s, h)).astype(np.float32)
    w = (0.3 * rng.standard_normal((h, h))).astype(np.float32)
    taus = jsampler.respaced_timesteps(100, k)

    def jmodel(x, t):
        return jnp.tanh(x @ jx(w)) + 1e-3 * t[:, None, None]

    def tmodel(x, t):
        return torch.tanh(x @ tt(w)) + 1e-3 * t[:, None, None]

    want = jsampler.ddpm_sample(
        jmodel, jax.random.key(0), jx(x_init),
        jschedule.NoiseSchedule.cosine(100), taus, noise_seq=jx(noise),
        clip_denoised=clip, prediction_type=prediction_type)
    got = tsampler.ddpm_sample(
        tmodel, tt(x_init), tschedule.NoiseSchedule.cosine(100), taus,
        noise_seq=tt(noise), clip_denoised=clip,
        prediction_type=prediction_type)
    scale = max(float(np.abs(np.asarray(want)).max()), 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=atol * scale)


def test_ddpm_sample_generator_is_deterministic():
    ts = tschedule.NoiseSchedule.cosine(100)
    taus = tsampler.respaced_timesteps(100, 5)
    x = torch.zeros(1, 4, 3)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tsampler.ddpm_sample(lambda v, t: 0.1 * v, x, ts, taus,
                                    generator=g)

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ref_compat", [False, True])
def test_glue_blocks_give_the_eager_stack_bit_for_bit(monkeypatch,
                                                      compute_dtype,
                                                      ref_compat):
    cfg = to_torch_cfg(SMALL.replace(ref_compat=ref_compat,
                                     compute_dtype=compute_dtype,
                                     num_layers=3))
    _, tp, x, text, t = _dit_case(SMALL.replace(num_layers=3), seed=6)
    with torch.no_grad():
        want = tdit.ditto_forward(tp, cfg, tt(x), tt(text), tt(t))
        monkeypatch.setattr(tdit, "glue_fused", lambda *a, **k: True)
        got = tdit.ditto_forward(tp, cfg, tt(x), tt(text), tt(t))
    assert got.dtype == want.dtype and torch.equal(got, want)


_CARD_X = SimpleNamespace(is_cuda=True, requires_grad=False)


@pytest.mark.parametrize("case,fused", [
    ("cpu", False), ("card", True), ("card_under_grad_params_need_it", False),
    ("card_under_grad_nothing_needs_it", True), ("card_x_needs_grad", False),
    ("card_model_split_mesh", False), ("card_data_only_mesh", True),
    ("card_dropout", False), ("card_head_not_taken", ValueError),
    ("cpu_head_not_taken", False)])
def test_glue_fused_sends_what_e_cannot_run_to_the_eager_stack(case, fused):
    """``glue_fused`` on the CPU and, for its other conditions, on a
    stand-in for a CUDA x (the positive cases show the stand-in passes
    the device test); a width E does not take raises on the card rather
    than run the eager stack there."""
    cfg = to_torch_cfg(SMALL.replace(compute_dtype="bfloat16"))
    w = torch.zeros(4, 4)
    x, kw, grad = _CARD_X, {}, False
    if case == "cpu":
        x = torch.zeros(2, 3, cfg.hidden_dim)
    elif case == "card_under_grad_params_need_it":
        w, grad = w.requires_grad_(), True
    elif case == "card_under_grad_nothing_needs_it":
        grad = True
    elif case == "card_x_needs_grad":
        x, grad = SimpleNamespace(is_cuda=True, requires_grad=True), True
    elif case.endswith("mesh"):
        kw["mesh"] = SimpleNamespace(model=2 if "split" in case else 1,
                                     data=4)
    elif case == "card_dropout":
        kw["dropout"] = True
    if case.endswith("head_not_taken"):    # heads of 24: halves of 12 bf16
        cfg = to_torch_cfg(SMALL.replace(compute_dtype="bfloat16",
                                         hidden_dim=96, num_heads=4))
    if case == "cpu_head_not_taken":
        x = torch.zeros(2, 3, cfg.hidden_dim)
    with torch.set_grad_enabled(grad):
        operands = {"blocks": [{"w": w}], "rope": (torch.zeros(2),)}
        if fused is ValueError:
            with pytest.raises(ValueError, match="head width 24"):
                tdit.glue_fused(cfg, x, operands, **kw)
        else:
            assert tdit.glue_fused(cfg, x, operands, **kw) is fused


def test_cpu_training_forward_runs_the_eager_stack(monkeypatch):
    """On the CPU, under grad with parameters that require it, the forward
    and its gradient run ``dit_block``'s ops, never ``glue_blocks``."""
    def refuse(*a, **k):
        raise AssertionError("glue_blocks ran")

    monkeypatch.setattr(tdit, "glue_blocks", refuse)
    cfg = to_torch_cfg(SMALL)
    _, tp, x, text, t = _dit_case(SMALL, seed=7)
    tp = tree_map(lambda a: a.requires_grad_(), tp)
    out = tdit.ditto_forward(tp, cfg, tt(x), tt(text), tt(t))
    out.square().mean().backward()
    assert tp["blocks"][0]["norm1"]["weight"].grad is not None
