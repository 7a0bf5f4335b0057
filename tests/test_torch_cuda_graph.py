"""The graphed denoising step (``infer/step_graph.py``) on the card: the
sampler with the DiT forward captured once and replayed for every step
gives the eager loop's bits (``ddpm_sample`` / ``ddim_sample`` over a plain
``model_fn`` around ``ditto_forward``, the same generator seed), at a tiny
width, at ditto-base's 10 s / B=1 shape and at ditto-ref's one fp32 head
of 768; a shape's first request (its step 0 the eager warm-up) and the
next (every step replayed) alike. ``kernels.launches`` counts what the
eager loop counts; two parameter trees of one shape each give their own
output; B=1, B=8, B=1 in turns each match their eager result; the served
request equals itself with the step eager; the ``sampler`` span says
``graph="captured"`` over one ``sampler.capture``; under grad the step
stays eager. VALL-E's AR decode step, graphed once a request and
replayed for every token, gives the eager loop's tokens and logits bit for
bit, a shape's first request and the next alike. The DiT's glue runs on kernel E (``models/dit.py:glue_blocks``)
wherever the step is graphed, so these hold E's graphed replays to its
eager calls; beside them, E's forward against the eager ops' forward
(``dit_block``): relative RMS at most 1e-2 in bf16 (a one-ulp difference
of a layer_norm output, carried through 12 blocks) and 1e-5 in fp32; the
``sampler`` span says ``glue="fused"``, and ``glue="eager"`` under grad
with parameters that require it. Every test skips without a CUDA card
(the ``dev`` fixture decides, at run time). On the card, where JAX is absent and
tests/conftest.py cannot load:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_graph.py
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ditto_tts_tpu_torch import kernels
from ditto_tts_tpu_torch import params as tparams
from ditto_tts_tpu_torch.config import (DiTConfig, PipelineConfig,
                                        SamplerConfig, ref_trained_dit_config,
                                        serving_config)
from ditto_tts_tpu_torch.diffusion.sampler import ddim_sample, ddpm_sample
from ditto_tts_tpu_torch.infer import generator as gen_mod
from ditto_tts_tpu_torch.infer import step_graph
from ditto_tts_tpu_torch.models import dit as dit_mod
from ditto_tts_tpu_torch.utils.profiling import recording

TINY = DiTConfig(hidden_dim=32, num_layers=2, num_heads=2, time_dim=16,
                 text_dim=32, diffusion_steps=100, max_token_length=64,
                 compute_dtype="bfloat16")
BASE = serving_config().dit                  # 12 x 768, 12 heads, bf16
REF = ref_trained_dit_config()               # 5 x 768, one head, fp32


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cfg(dit: DiTConfig, steps: int) -> PipelineConfig:
    return PipelineConfig(dit=dit, sampler=SamplerConfig(num_steps=steps))


def _dit_params(dit: DiTConfig, seed: int, dev):
    return tparams.tree_map(lambda a: torch.from_numpy(a).to(dev),
                            tparams.fill_spec(tparams._dit_spec(dit), seed))


def _inputs(dit: DiTConfig, b: int, frames: int, text: int, seed: int, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, frames, dit.hidden_dim), generator=g, device=dev)
    emb = torch.randn((b, text, dit.text_dim), generator=g, device=dev)
    return x, emb


def _eager(tree, cfg, x, emb, seed, kind="ddpm"):
    """The eager loop: the sampler over a plain ``model_fn``."""
    schedule, taus = gen_mod._schedule(cfg, None)
    with torch.inference_mode():
        prep = dit_mod.prepare(tree, cfg.dit, emb, x.shape[1])

        def model_fn(xx, t):
            return dit_mod.ditto_forward(tree, cfg.dit, xx, emb, t,
                                         prepared=prep)

        kw = dict(generator=torch.Generator(device=x.device).manual_seed(
            seed), clip_denoised=cfg.sampler.clip_denoised,
            prediction_type=cfg.dit.prediction_type)
        if kind == "ddim":
            return ddim_sample(model_fn, x, schedule, taus,
                               eta=cfg.sampler.ddim_eta, **kw)
        return ddpm_sample(model_fn, x, schedule, taus, **kw)


def _graphed(tree, cfg, x, emb, seed, kind="ddpm"):
    schedule, taus = gen_mod._schedule(cfg, None)
    with torch.inference_mode():
        return gen_mod._sample(
            SimpleNamespace(dit=tree), cfg, schedule, taus, x, emb,
            kind=kind, generator=torch.Generator(device=x.device).manual_seed(
                seed))


def _warm(x, emb, cfg) -> bool:
    """Whether the shape was already run in this process."""
    d = step_graph._devices.get(x.device.index)
    key = ((cfg.dit, tuple(emb.shape), emb.dtype), tuple(x.shape), x.dtype,
           (x.shape[0],), torch.int64)
    return d is not None and key in d.warm


def _same(a, b):
    """Equal bits, and finite (a respacing too short for the schedule makes
    every value NaN, which would compare unequal and prove nothing)."""
    torch.cuda.synchronize()
    assert bool(torch.isfinite(b).all())
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("kind", ["ddpm", "ddim"])
@pytest.mark.parametrize("name,dit,b,frames,text,steps", [
    ("tiny_bf16", TINY, 2, 40, 9, 8),
    ("tiny_fp32", dataclasses.replace(TINY, compute_dtype="float32"), 3, 37,
     5, 8),
    ("base_10s_b1", BASE, 1, 750, 64, 50),
    ("ref_10s_b1", REF, 1, 750, 64, 50)])
def test_graphed_sampler_is_the_eager_loop_bit_for_bit(dev, kind, name, dit,
                                                       b, frames, text,
                                                       steps):
    cfg = _cfg(dit, steps)
    tree = _dit_params(dit, 0, dev)
    x, emb = _inputs(dit, b, frames, text, 1, dev)
    want = _eager(tree, cfg, x, emb, 2, kind)
    # the shape's first request (step 0 may be the warm-up), then the next
    for _ in range(2):
        got = _graphed(tree, cfg, x, emb, 2, kind)
        assert _same(got, want), (got.float() - want.float()).abs().max()
        assert _warm(x, emb, cfg)


def test_first_request_of_a_shape_warms_up_then_replays(dev):
    cfg = _cfg(TINY, 8)
    tree = _dit_params(TINY, 3, dev)
    x, emb = _inputs(TINY, 2, 41, 11, 4, dev)
    assert not _warm(x, emb, cfg)
    want = _eager(tree, cfg, x, emb, 5)
    first = _graphed(tree, cfg, x, emb, 5)
    assert _warm(x, emb, cfg)
    second = _graphed(tree, cfg, x, emb, 5)
    assert _same(first, want) and _same(second, want)


def test_launches_are_counted_per_replay(dev):
    """A 50-step DDPM at ditto-base's 10 s / B=1 shape counts kernel A's
    24 launches a step (12 layers, self and cross), 1200 a request, and
    kernel E's 73 a step (6 a block and the first norm), 3650 a request,
    on the shape's first request and on the next."""
    cfg = _cfg(BASE, 50)
    tree = _dit_params(BASE, 0, dev)
    x, emb = _inputs(BASE, 1, 750, 63, 7, dev)
    for _ in range(2):
        kernels.reset_launches()
        _graphed(tree, cfg, x, emb, 8)
        torch.cuda.synchronize()
        assert kernels.launches == {"attention": 1200, "conv1d": 0,
                                    "act_conv": 0, "snake": 0,
                                    "dit_glue": 3650, "kv_decode": 0}
    kernels.reset_launches()
    _eager(tree, cfg, x, emb, 8)
    assert kernels.launches["attention"] == 1200
    assert kernels.launches["dit_glue"] == 3650


def test_two_parameter_trees_each_give_their_own_output(dev):
    cfg = _cfg(TINY, 8)
    trees = [_dit_params(TINY, s, dev) for s in (10, 11)]
    x, emb = _inputs(TINY, 2, 40, 9, 12, dev)
    want = [_eager(t, cfg, x, emb, 13) for t in trees]
    assert not torch.equal(want[0], want[1])
    for t, w in [*zip(trees, want), (trees[0], want[0])]:
        assert _same(_graphed(t, cfg, x, emb, 13), w)


def test_batches_in_turns_each_match_their_eager_result(dev):
    cfg = _cfg(BASE, 50)
    tree = _dit_params(BASE, 0, dev)
    for b in (1, 8, 1):
        x, emb = _inputs(BASE, b, 750, 64, 20 + b, dev)
        assert _same(_graphed(tree, cfg, x, emb, 30),
                     _eager(tree, cfg, x, emb, 30)), b


def test_every_step_replays_under_one_capture(dev):
    k = 5
    cfg = _cfg(TINY, k)
    tree = _dit_params(TINY, 0, dev)
    x, emb = _inputs(TINY, 2, 40, 9, 1, dev)
    for _ in range(2):
        with recording() as rec:
            _graphed(tree, cfg, x, emb, 2)
        spans = rec.spans()
        names = [s["name"] for s in spans]
        assert names == ["sampler", "sampler.capture",
                         *["sampler.step"] * k]
        assert spans[0]["attrs"]["graph"] == "captured"
        assert spans[0]["attrs"]["glue"] == "fused"
        assert all(s["parent"] == 0 for s in spans[1:])
        assert spans[1]["end_ns"] <= spans[2]["start_ns"]


def test_under_grad_the_step_stays_eager(dev):
    cfg = _cfg(TINY, 8)
    tree = _dit_params(TINY, 0, dev)
    x, emb = _inputs(TINY, 2, 40, 9, 1, dev)
    schedule, taus = gen_mod._schedule(cfg, None)
    with recording() as rec, torch.enable_grad():
        got = gen_mod._sample(
            SimpleNamespace(dit=tree), cfg, schedule, taus, x, emb,
            generator=torch.Generator(device=dev).manual_seed(2))
    names = [s["name"] for s in rec.spans()]
    assert "sampler.capture" not in names
    assert rec.spans()[0]["attrs"]["graph"] == "eager"
    assert _same(got, _eager(tree, cfg, x, emb, 2))


def test_served_request_equals_itself_with_the_step_eager(dev, monkeypatch):
    """A default 10 s / B=1 request through the serving entry point, graphed
    and with ``engages`` false, bit for bit, with the default path's exact
    launches (A 1200, B 90, C 54, D 55, E 3650) either way."""
    cfg = serving_config()
    params = tparams.init_generator_params(cfg, 0).to(dev)
    rng = np.random.default_rng(0)
    audio = (0.05 * rng.standard_normal((1, 1, 240000))).astype(np.float32)
    mask = np.ones((1, 240000), np.int32)
    text = rng.integers(0, 50257, (1, 64))
    serve = gen_mod.build_synthesize_pipelined(cfg)
    want_launches = {"attention": 1200, "conv1d": 90, "act_conv": 54,
                     "snake": 55, "dit_glue": 3650, "kv_decode": 0}

    def request():
        kernels.reset_launches()
        out = serve(params, audio, mask, text,
                    torch.Generator(device=dev).manual_seed(9))
        torch.cuda.synchronize()
        assert kernels.launches == want_launches
        return out

    graphed = [request(), request()]
    monkeypatch.setattr(step_graph, "engages", lambda x: False)
    eager = request()
    assert _same(graphed[0], eager) and _same(graphed[1], eager)


def _rel_rms(got, want):
    torch.cuda.synchronize()
    d = (got.float() - want.float()).square().mean().sqrt()
    return (d / want.float().square().mean().sqrt()).item()


@pytest.mark.parametrize("name,dit,b,launches,bound", [
    ("base_10s_b2", BASE, 2, 73, 1e-2), ("ref_10s_b2", REF, 2, 31, 1e-5)])
def test_fused_forward_is_the_eager_forward_within_its_bound(
        dev, monkeypatch, name, dit, b, launches, bound):
    """``ditto_forward`` with the glue on kernel E against the eager ops
    (``glue_fused`` false), at 10 s, several timesteps."""
    tree = _dit_params(dit, 0, dev)
    x, emb = _inputs(dit, b, 750, 64, 3, dev)
    t = torch.tensor([999, 400][:b], device=dev)
    with torch.inference_mode():
        prep = dit_mod.prepare(tree, dit, emb, x.shape[1])
        kernels.reset_launches()
        fused = dit_mod.ditto_forward(tree, dit, x, emb, t, prepared=prep)
        assert kernels.launches["dit_glue"] == launches
        monkeypatch.setattr(dit_mod, "glue_fused", lambda *a, **k: False)
        eager = dit_mod.ditto_forward(tree, dit, x, emb, t, prepared=prep)
    assert kernels.launches["dit_glue"] == launches
    assert bool(torch.isfinite(fused).all())
    assert _rel_rms(fused, eager) <= bound, _rel_rms(fused, eager)


@pytest.mark.parametrize("name,dit", [("base", BASE), ("ref", REF)])
def test_graphed_fused_step_equals_its_eager_call(dev, name, dit):
    """One step's forward captured with kernel E in it, replayed on a new
    input, gives the eager fused call's bits on that input."""
    tree = _dit_params(dit, 1, dev)
    x, emb = _inputs(dit, 1, 750, 64, 5, dev)
    x2 = _inputs(dit, 1, 750, 64, 6, dev)[0]
    t = torch.tensor([500], device=dev)
    with torch.inference_mode():
        prep = dit_mod.prepare(tree, dit, emb, x.shape[1])

        def forward(xx, tt):
            return dit_mod.ditto_forward(tree, dit, xx, emb, tt,
                                         prepared=prep)

        model_fn = step_graph.capture(forward, x, t, ("glue", name))
        model_fn(x, t)
        kernels.reset_launches()
        got = model_fn(x2, t).clone()
        assert kernels.launches["dit_glue"] == 1 + 6 * dit.num_layers
        assert _same(got, forward(x2, t))


def test_under_grad_with_parameters_that_require_it_the_glue_is_eager(
        dev, monkeypatch):
    """The sampler under grad with parameters that require grad runs the
    eager ops (``glue="eager"``, no E launch): the bits of the same
    sampler with ``glue_fused`` false."""
    cfg = _cfg(TINY, 8)
    tree = _dit_params(TINY, 0, dev)
    x, emb = _inputs(TINY, 2, 40, 9, 1, dev)
    schedule, taus = gen_mod._schedule(cfg, None)
    with monkeypatch.context() as m:
        m.setattr(dit_mod, "glue_fused", lambda *a, **k: False)
        want = _graphed(tree, cfg, x, emb, 2)
    grad_tree = tparams.tree_map(lambda a: a.clone().requires_grad_(), tree)
    kernels.reset_launches()
    with recording() as rec, torch.enable_grad():
        got = gen_mod._sample(
            SimpleNamespace(dit=grad_tree), cfg, schedule, taus, x, emb,
            generator=torch.Generator(device=dev).manual_seed(2))
    attrs = rec.spans()[0]["attrs"]
    assert attrs["graph"] == "eager" and attrs["glue"] == "eager"
    assert kernels.launches["dit_glue"] == 0
    assert _same(got.detach(), want)


def test_replayed_valle_decode_is_the_eager_loop_bit_for_bit(dev):
    """VALL-E's AR over a KV cache at heads of 64 (2 layers of 256, 60
    tokens a row): the replayed decode step's tokens and logits equal the
    eager loop's, for a shape's first request (step 0 eager) and the next
    (every step replayed); the ``ar`` span says ``graph="captured"``."""
    from ditto_tts_tpu_torch.config import (CodecConfig, ValleModelConfig,
                                            VallePipelineConfig,
                                            ValleSamplerConfig)
    cfg = VallePipelineConfig(
        model=ValleModelConfig(d_model=256, nhead=4, num_layers=2,
                               ffn_dim=512, num_phonemes=40,
                               codebook_size=64),
        sampler=ValleSamplerConfig(generated_frames=60, top_k=8),
        codec=CodecConfig(num_filters=4, dimension=16, codebook_size=64,
                          num_codebooks_used=8))
    params = tparams.init_valle_params(cfg, 2)
    params = tparams.ValleParams(**{
        f: tparams.tree_map(lambda t: t.to(dev), getattr(params, f))
        for f in ("ar", "nar", "codec")})
    st = gen_mod.build_stage_fns(cfg)
    g = torch.Generator(device=dev).manual_seed(3)
    text = torch.randint(0, 40, (3, 9), generator=g, device=dev)
    codes = torch.randint(0, 64, (3, 8, 17), generator=g, device=dev)

    def ar(seed, graphed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        if graphed:
            with torch.inference_mode():
                return st["ar"](params, text, codes, gen, logits=True)
        return st["ar"](params, text, codes, gen, logits=True)

    for seed in (5, 6):
        with recording() as rec:
            tok, lg = ar(seed, True)
        spans = rec.spans()
        assert [s["attrs"]["graph"] for s in spans
                if s["name"] == "ar"] == ["captured"]
        assert sum(s["name"] == "ar.capture" for s in spans) == 1
        with torch.enable_grad():
            tok_e, lg_e = ar(seed, False)
        assert torch.equal(tok, tok_e) and torch.equal(lg, lg_e)
        assert bool((tok < 64).all())
