"""F5-TTS on the card: kernel A at F5's sequence length (2,343 frames, not
a multiple of 64) against the plain attention; F5's guided step captured
as one CUDA graph (``infer/step_graph.py``) equal to the eager step bit for
bit at the published widths (22 x 1024, B = 1, 2 x 1 rows); an F5 request
at the published widths counting one A launch a block a step and its
vocoder's C and D launches; and DiTTo's served request keeping its
launches (A 1200, B 90, C 54, D 55, E 3650) beside the F5 chain. Every test skips without a
CUDA card (the ``dev`` fixture decides, at run time). On the card, where
JAX is absent and tests/conftest.py cannot load:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_f5_cuda.py
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ditto_tts_tpu_torch import kernels
from ditto_tts_tpu_torch import params as tparams
from ditto_tts_tpu_torch.config import F5PipelineConfig, serving_config
from ditto_tts_tpu_torch.infer import generator as gen_mod
from ditto_tts_tpu_torch.infer import step_graph
from ditto_tts_tpu_torch.models import f5 as f5_mod
from ditto_tts_tpu_torch.ops.attention import attention, attention_plain

F5 = F5PipelineConfig()
S = F5.total_frames                          # 2343


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _f5_params(dev):
    spec = tparams.f5_spec(F5)
    g = torch.Generator(device=dev).manual_seed(0)

    def draw(node):
        if isinstance(node, tuple):
            shape, kind, scale = node
            if kind == "u":
                return (torch.rand(shape, generator=g, device=dev) * 2 - 1) \
                    * scale
            if kind == "n":
                return torch.randn(shape, generator=g, device=dev) * scale
            return torch.full(shape, 1.0 if kind == "1" else 0.0,
                              device=dev)
        if isinstance(node, dict):
            return {k: draw(node[k]) for k in sorted(node)}
        return [draw(v) for v in node]

    return tparams.F5Params(**draw(spec))


def test_kernel_a_at_f5_length_matches_the_plain_attention(dev):
    assert S == 2343 and S % 64
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn((2, 16, S, 64), generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    kernels.reset_launches()
    got = attention(q, k, v)
    assert kernels.launches["attention"] == 1
    want = attention_plain(q, k, v)
    err = (got.float() - want.float()).norm() / want.float().norm()
    assert float(err) < 1e-2
    # the last, partial tile of queries and of keys is exact too
    tail = (got[:, :, -7:].float() - want[:, :, -7:].float()).abs().max()
    assert float(tail) < 2e-2


def test_graphed_guided_step_is_the_eager_step_bit_for_bit(dev):
    params = _f5_params(dev)
    g = torch.Generator(device=dev).manual_seed(2)
    p = 937
    with torch.inference_mode():
        cond = F.pad(torch.randn((1, p, 100), generator=g, device=dev),
                     (0, 0, 0, S - p))
        ids = torch.randint(0, 2545, (1, 384), generator=g, device=dev)
        text2 = f5_mod.text_embed(params.dit["text_embed"], F5.dit, ids, S)
        prep = f5_mod.prepare(params.dit, F5.dit, cond, text2)

        def forward(y, t):
            return f5_mod.velocity(params.dit, F5.dit, y, t, prep, 2.0)

        y = torch.randn((1, S, 100), generator=g, device=dev)
        t = torch.full((1,), 0.3, device=dev)
        eager = forward(y, t).clone()
        model_fn = step_graph.capture(forward, y, t, ("f5-test", S))
        first = model_fn(y, t).clone()
        replay = model_fn(y.clone(), t.clone()).clone()
        again = model_fn(y.clone(), t.clone()).clone()
        torch.cuda.synchronize()
    assert torch.equal(first, eager)
    assert torch.equal(replay, eager) and torch.equal(again, eager)
    assert torch.isfinite(eager).all()


def test_f5_request_launches_kernel_a_once_a_block_a_step(dev):
    params = _f5_params(dev)
    cfg = F5.replace(sampler=F5.sampler.replace(steps=4))
    rng = np.random.default_rng(3)
    audio = (0.05 * rng.standard_normal((1, 1, 240000))).astype(np.float32)
    ids = rng.integers(0, 2545, (1, 384))
    serve = gen_mod.build_synthesize_pipelined(cfg)
    outs = []
    for _ in range(2):
        kernels.reset_launches()
        outs.append(serve(params, audio, None, ids,
                          torch.Generator(device=dev).manual_seed(5)))
        torch.cuda.synchronize()
        assert kernels.launches["attention"] == 22 * 4
        assert kernels.launches["act_conv"] == 54
        assert kernels.launches["snake"] == 55
    assert outs[0].shape == (1, (S - 937) * 256)
    assert torch.equal(outs[0], outs[1])


def test_dittos_served_request_keeps_its_launches(dev):
    cfg = serving_config()
    params = tparams.init_generator_params(cfg, 0).to(dev)
    rng = np.random.default_rng(0)
    audio = (0.05 * rng.standard_normal((1, 1, 240000))).astype(np.float32)
    serve = gen_mod.build_synthesize_pipelined(cfg)
    kernels.reset_launches()
    serve(params, audio, np.ones((1, 240000), np.int32),
          rng.integers(0, 50257, (1, 64)),
          torch.Generator(device=dev).manual_seed(9))
    torch.cuda.synchronize()
    assert kernels.launches == {"attention": 1200, "conv1d": 90,
                                "act_conv": 54, "snake": 55,
                                "dit_glue": 3650, "kv_decode": 0}
