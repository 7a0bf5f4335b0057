"""VALL-E on the port (``models/valle.py``, ``infer/valle.py``), held on the
CPU to the plain fp32 reference (``tests/_valle_reference.py``) at a tiny
size: 2 layers of width 64, 4 heads of 16, 8 codebooks of 32 codes, 16
phonemes, on seeded random weights. Also kernel A's plain version with a
prefix and with per-row device lengths against an explicitly masked
softmax, the top-k draw, and the entry point's determinism per seed."""

import dataclasses
import math

import pytest
import torch

import _torch_port_util  # noqa: F401  (one CPU thread a worker)
import _valle_reference as ref
from ditto_tts_tpu_torch.config import (CodecConfig, ValleModelConfig,
                                        VallePipelineConfig,
                                        ValleSamplerConfig)
from ditto_tts_tpu_torch.infer.generator import (build_stage_fns,
                                                 build_synthesize_pipelined)
from ditto_tts_tpu_torch.models import valle as valle_mod
from ditto_tts_tpu_torch.ops.attention import attention, attention_plain
from ditto_tts_tpu_torch.params import init_valle_params
from ditto_tts_tpu_torch.utils.profiling import recording

B, T, P, N = 2, 5, 6, 10


def _cfg(dtype="float32", frames=N):
    return VallePipelineConfig(
        model=ValleModelConfig(d_model=64, nhead=4, num_layers=2, ffn_dim=128,
                               num_phonemes=16, codebook_size=32,
                               compute_dtype=dtype),
        sampler=ValleSamplerConfig(generated_frames=frames, top_k=5),
        codec=CodecConfig(num_filters=4, dimension=16, codebook_size=32,
                          num_codebooks_used=8))


def _inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    audio = 0.05 * torch.randn((B, 1, 320 * P), generator=g)
    text = torch.randint(0, 16, (B, T), generator=g)
    return audio, text


@pytest.fixture(scope="module")
def served():
    """The stages of one fp32 request, with the logits that drew it."""
    cfg = _cfg()
    params = init_valle_params(cfg, 3)
    audio, text = _inputs()
    st = build_stage_fns(cfg)
    with torch.inference_mode():
        codes, lat = st["encode"](params, audio)
        tokens, ar_lg = st["ar"](params, text, codes,
                                 torch.Generator().manual_seed(5),
                                 logits=True)
        gen, nar_lg = st["nar"](params, text, codes, tokens, logits=True)
    return dict(cfg=cfg, params=params, text=text, codes=codes, lat=lat,
                tokens=tokens, ar_lg=ar_lg, gen=gen, nar_lg=nar_lg)


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_ar_prefill_and_cached_decode_match_the_full_forward(served):
    s = served
    model = dataclasses.asdict(s["cfg"].model)
    want = ref.decoded_logits(s["params"].ar, model, s["text"],
                              s["codes"][:, 0], s["tokens"])
    assert s["ar_lg"].shape == want.shape == (B, N, 33)
    assert _rel(s["ar_lg"], want) < 1e-5
    # every token is one of the top 5 of its logits, never EOS
    top = torch.topk(s["ar_lg"], 5, dim=-1).indices
    assert bool((top == s["tokens"][..., None]).any(-1).all())
    assert bool((s["tokens"] < 32).all())


@pytest.mark.parametrize("stage", range(2, 9))
def test_nar_stage_logits_match_the_reference(served, stage):
    s = served
    model = dataclasses.asdict(s["cfg"].model)
    want = ref.nar_logits(s["params"].nar, model, stage, s["text"],
                          s["codes"], s["gen"])
    got = s["nar_lg"][stage - 2]
    assert got.shape == want.shape == (B, N, 32)
    assert _rel(got, want) < 1e-5
    assert torch.equal(s["gen"][:, stage - 1], got.argmax(-1))


def test_bf16_blocks_stay_near_the_reference():
    cfg = _cfg("bfloat16")
    params = init_valle_params(cfg, 4)
    audio, text = _inputs(1)
    st = build_stage_fns(cfg)
    model = dataclasses.asdict(cfg.model)
    with torch.inference_mode():
        codes, _ = st["encode"](params, audio)
        tokens, lg = st["ar"](params, text, codes,
                              torch.Generator().manual_seed(2), logits=True)
        gen, nar_lg = st["nar"](params, text, codes, tokens, logits=True)
    want = ref.decoded_logits(params.ar, model, text, codes[:, 0], tokens)
    assert _rel(lg, want) < 3e-2
    want = ref.nar_logits(params.nar, model, 5, text, codes, gen)
    assert _rel(nar_lg[3], want) < 3e-2


def _masked_softmax(q, k, v, visible):
    sc = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    sc = sc.masked_fill(~visible, float("-inf"))
    return torch.softmax(sc, dim=-1) @ v


@pytest.mark.parametrize("prefix", [0, 3, 7, 12])
def test_attention_plain_prefix_causal(prefix):
    g = torch.Generator().manual_seed(prefix)
    q, k, v = (torch.randn((2, 3, 12, 16), generator=g) for _ in range(3))
    r, c = torch.arange(12)[:, None], torch.arange(12)[None]
    want = _masked_softmax(q, k, v, (c <= r) | (c < prefix))
    got = attention(q, k, v, causal=True, prefix=prefix)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("lengths", [[5], [1, 9, 16]])
def test_attention_plain_device_lengths(lengths):
    g = torch.Generator().manual_seed(len(lengths))
    b = 3
    q = torch.randn((b, 2, 1, 16), generator=g)
    k, v = (torch.randn((b, 2, 16, 16), generator=g) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32)
    per_row = lens.expand(b) if lens.numel() == 1 else lens
    visible = torch.arange(16)[None] < per_row[:, None, None, None]
    want = _masked_softmax(q, k, v, visible)
    got = attention(q, k, v, kv_lens=lens)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="no backward"):
        attention(q.requires_grad_(), k, v, kv_lens=lens)


def test_attention_plain_without_masks_is_unchanged():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 2, 9, 16), generator=g) for _ in range(3))
    assert torch.equal(attention(q, k, v, causal=True),
                       attention_plain(q, k, v, causal=True))
    assert torch.equal(attention(q, k, v, causal=True, prefix=0),
                       attention_plain(q, k, v, causal=True))


def test_top_k_draw_follows_its_distribution():
    """Gumbel-max over the top k: every draw among the k, EOS never, and
    the frequencies near softmax over the k."""
    logits = torch.tensor([[2.0, 1.0, 0.5, -1.0, 3.0, -5.0]]).repeat(4000, 1)
    bias = torch.zeros(6)
    bias[4] = float("-inf")
    seed = torch.tensor([12345, 678], dtype=torch.int64)
    lanes = torch.arange(4000 * 3).view(4000, 3)
    got = valle_mod.sample_top_k(logits, seed, torch.tensor([7]), lanes, 3,
                                 1.0, bias)
    assert set(got.tolist()) <= {0, 1, 2}
    want = torch.softmax(torch.tensor([2.0, 1.0, 0.5]), 0)
    freq = torch.bincount(got, minlength=3)[:3].float() / 4000
    assert float((freq - want).abs().max()) < 0.03
    u = valle_mod.uniforms(seed, torch.tensor([7]), lanes)
    assert float(u.min()) > 0 and float(u.max()) < 1


def test_entry_point_deterministic_per_seed_with_spans():
    cfg = _cfg("bfloat16", frames=6)
    params = init_valle_params(cfg, 1)
    audio, text = _inputs(2)
    serve = build_synthesize_pipelined(cfg, device="cpu")
    with recording() as rec:
        w1 = serve(params, audio, None, text,
                   torch.Generator().manual_seed(1))
    assert w1.shape == (B, 6 * 320)
    w2 = serve(params, audio, None, text, torch.Generator().manual_seed(1))
    w3 = serve(params, audio, None, text, torch.Generator().manual_seed(2))
    assert torch.equal(w1, w2) and not torch.equal(w1, w3)
    names = [s["name"] for s in rec.spans()]
    assert names.count("ar.step") == 6 and names.count("nar.stage") == 7
    for name in ("request", "encode", "ar", "ar.prefill", "nar",
                 "codec_decode"):
        assert name in names
    ar = next(s for s in rec.spans() if s["name"] == "ar")
    assert ar["attrs"]["graph"] == "eager"
    got = {c["name"]: c["value"] for c in rec.counters()}
    assert got["ar_tokens"] == B * 6
    assert got["kv_cache_bytes"] == 2 * 2 * B * 4 * (T + P + 6 - 1) * 16 * 2
    # the staged chain gives the entry point's waveform
    st = build_stage_fns(cfg)
    with torch.inference_mode():
        codes, _ = st["encode"](params, audio)
        tokens = st["ar"](params, text, codes,
                          torch.Generator().manual_seed(1))
        wave = st["codec_decode"](params, st["nar"](params, text, codes,
                                                     tokens))
    assert torch.equal(wave, w1)


def test_valle_takes_no_ditto_sampler_options():
    with pytest.raises(ValueError, match="num_steps"):
        build_synthesize_pipelined(_cfg(), num_steps=4, device="cpu")
    with pytest.raises(ValueError, match="sampler_kind"):
        build_stage_fns(_cfg(), sampler_kind="ddim")


def test_config_round_trips_through_json():
    cfg = _cfg("bfloat16")
    assert VallePipelineConfig.from_json(cfg.to_json()) == cfg
