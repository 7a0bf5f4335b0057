"""F5-TTS v1 on the port (``models/f5.py``, ``diffusion/flow.py``, the F5
chain of ``infer/generator.py``, ``params.py``'s spec and importer, the
interleaved RoPE of ``ops/rope.py``), held on the CPU at a tiny width, in
fp32, against the plain reference ``tests/_f5_reference.py`` written from
F5's equations: one guided velocity, four swayed Euler steps, the whole
request through the mel and a tiny BigVGAN (the benchmark's plain
BigVGAN, ``benchmark/reference/vocoder.py``, on the reference's side),
the RoPE against its closed form, GRN and the conv position embedding
alone, and the importer on a state_dict with F5's names."""

import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import _f5_reference as ref  # noqa: E402
from benchmark.reference import vocoder as voc_ref  # noqa: E402
from benchmark.work import act_conv as act_conv_work  # noqa: E402
from ditto_tts_tpu_torch.config import (  # noqa: E402
    F5DiTConfig, F5PipelineConfig, FlowSamplerConfig, VocoderConfig)
from ditto_tts_tpu_torch.diffusion.flow import sway_times  # noqa: E402
from ditto_tts_tpu_torch.infer.generator import (  # noqa: E402
    build_stage_fns, build_synthesize_pipelined)
from ditto_tts_tpu_torch.models import f5 as f5_mod  # noqa: E402
from ditto_tts_tpu_torch.ops.rope import (  # noqa: E402
    apply_rope_interleaved, rope_tables_interleaved)
from ditto_tts_tpu_torch.params import (  # noqa: E402
    F5Params, import_f5_state_dict, init_f5_params)

CFG = F5PipelineConfig(
    dit=F5DiTConfig(dim=64, depth=2, heads=4, dim_head=16, text_dim=32,
                    text_num_embeds=50, conv_layers=2, conv_pos_groups=4,
                    time_freq_dim=32, compute_dtype="float32"),
    sampler=FlowSamplerConfig(steps=4, fix_duration=0.5),
    vocoder=VocoderConfig(upsample_initial_channel=192,
                          compute_dtype="float32", carry_dtype="float32"))
D = dataclasses.asdict(CFG)
N = CFG.total_frames                       # 46 frames of 0.5 s
SAMPLES = 4800                             # a 0.2 s prompt: 18 mel frames


def rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.fixture(scope="module")
def case():
    torch.manual_seed(0)
    params = init_f5_params(CFG, 3)
    audio = 0.05 * torch.randn(2, 1, SAMPLES)
    ids = torch.randint(0, CFG.dit.text_num_embeds, (2, 12))
    ids[1, 8:] = -1                        # a shorter text, padded
    return params, audio, ids


def _cond(params, audio):
    cond, _ = build_stage_fns(CFG)["mel"](params, audio)
    return cond


def test_guided_velocity_equals_the_reference(case):
    params, audio, ids = case
    st = build_stage_fns(CFG)
    cond = _cond(params, audio)
    text2 = st["text_encode"](params, ids, N)
    y = torch.randn(2, N, CFG.dit.mel_dim)
    t = torch.full((2,), 0.37)
    got = st["velocity"](params, cond, text2, y, t)
    want = ref.velocity({"dit": params.dit}, D["dit"], D["sampler"], cond,
                        ids, y, 0.37, None)
    assert got.shape == (2, N, CFG.dit.mel_dim)
    assert rel(got, want) < 1e-5


def test_four_swayed_euler_steps_equal_the_reference(case):
    params, audio, ids = case
    st = build_stage_fns(CFG)
    cond = _cond(params, audio)
    got = st["sampler"](params, cond, st["text_encode"](params, ids, N),
                        torch.Generator().manual_seed(5))
    y0 = torch.randn((2, N, CFG.dit.mel_dim),
                     generator=torch.Generator().manual_seed(5))
    want = ref.flow({"dit": params.dit}, D["dit"], D["sampler"], cond, ids,
                    y0, None)
    assert torch.equal(got[:, :cond.shape[1]], cond)
    assert rel(got, want) < 1e-5
    t = sway_times(4, -1.0)
    assert torch.equal(t, ref.times(D["sampler"]))
    assert float(t[0]) == 0.0 and float(t[-1]) == 1.0
    assert float(t[1]) < 0.25 / 2          # sway -1 crowds the early steps


def test_the_whole_tiny_request_equals_the_reference(case):
    params, audio, ids = case
    wave = build_synthesize_pipelined(CFG, device="cpu")(
        params, audio, None, ids, torch.Generator().manual_seed(9))
    y0 = torch.randn((2, N, CFG.dit.mel_dim),
                     generator=torch.Generator().manual_seed(9))
    voc = D["vocoder"]

    def vocoder(m):
        fused = [w for w, _ in act_conv_work.fused_stage_widths(
            voc, m.shape[-1])]
        return voc_ref.forward(params.vocoder, voc, m, "float32", fused)

    cond, full, want = ref.request({"dit": params.dit}, D, audio, ids, y0,
                                   vocoder)
    p = cond.shape[1]
    assert p == 18 and wave.shape == (2, (N - p) * 256)
    st = build_stage_fns(CFG)
    got_cond, rms = st["mel"](params, audio)
    assert rel(got_cond, cond) < 1e-5
    assert rel(wave, want) < 1e-4
    # the noise prompts (RMS 0.05) are lifted to 0.1 and scaled back
    assert torch.allclose(rms, audio.square().mean(dim=(1, 2)).sqrt())


def test_interleaved_rope_is_the_complex_rotation():
    s, d = 37, 16
    x = torch.randn(2, s, 3, d, dtype=torch.float64)
    cos, sin = rope_tables_interleaved(s, d, dtype=torch.float64)
    got = apply_rope_interleaved(x, cos, sin)
    z = torch.view_as_complex(x.unflatten(-1, (d // 2, 2)).contiguous())
    f = 1.0 / 10000.0 ** (torch.arange(0, d, 2, dtype=torch.float64) / d)
    ang = torch.arange(s, dtype=torch.float64)[:, None] * f[None]
    want = torch.view_as_real(z * torch.polar(torch.ones_like(ang), ang)[
        None, :, None]).flatten(-2)
    assert torch.allclose(got, want, atol=1e-6)
    rc, rs = ref.rotary(s, d, "cpu")
    assert torch.allclose(cos.float(), rc, atol=1e-6)
    assert torch.allclose(sin.float(), rs, atol=1e-6)


def test_grn_and_the_conv_position_embedding_alone(case):
    params, _, _ = case
    blk = params.dit["text_embed"]["blocks"][0]
    h = torch.randn(2, 23, 2 * CFG.dit.text_dim)
    assert rel(f5_mod.grn(blk["grn"], h), ref.grn(blk["grn"], h)) < 1e-6
    # the norm runs over time: scaling one frame moves every frame's Nx
    h2 = h.clone()
    h2[:, 0] *= 3.0
    assert not torch.allclose(f5_mod.grn(blk["grn"], h2)[:, 5],
                              f5_mod.grn(blk["grn"], h)[:, 5])
    emb = params.dit["input_embed"]
    x = torch.randn(2, 23, CFG.dit.dim)
    g = CFG.dit.conv_pos_groups
    got = torch.nn.functional.mish(f5_mod._conv(
        emb["conv2"], torch.nn.functional.mish(f5_mod._conv(
            emb["conv1"], x, g)), g))
    assert rel(got, ref.conv_position(emb, x, g, None)) < 1e-6


def _f5_names(tree, cfg: F5DiTConfig, prefix: str):
    """The drawn tree under F5's own module names (written here from
    F5's modules, not from the importer)."""
    sd = {}

    def put(name, p):
        for k, v in p.items():
            sd[f"{prefix}{name}.{k}"] = v.numpy()

    put("time_embed.time_mlp.0", tree["time_embed"]["fc1"])
    put("time_embed.time_mlp.2", tree["time_embed"]["fc2"])
    sd[prefix + "text_embed.text_embed.weight"] = \
        tree["text_embed"]["embed"]["weight"].numpy()
    for i, b in enumerate(tree["text_embed"]["blocks"]):
        pre = f"text_embed.text_blocks.{i}"
        for k in ("dwconv", "norm", "pwconv1", "pwconv2"):
            put(f"{pre}.{k}", b[k])
        for k in ("gamma", "beta"):
            sd[f"{prefix}{pre}.grn.{k}"] = \
                b["grn"][k].reshape(1, 1, -1).numpy()
    put("input_embed.proj", tree["input_embed"]["proj"])
    put("input_embed.conv_pos_embed.conv1d.0", tree["input_embed"]["conv1"])
    put("input_embed.conv_pos_embed.conv1d.2", tree["input_embed"]["conv2"])
    for i, b in enumerate(tree["blocks"]):
        pre = f"transformer_blocks.{i}"
        put(f"{pre}.attn_norm.linear", b["attn_norm"])
        for k in ("to_q", "to_k", "to_v"):
            put(f"{pre}.attn.{k}", b[k])
        put(f"{pre}.attn.to_out.0", b["to_out"])
        put(f"{pre}.ff.ff.0.0", b["ff1"])
        put(f"{pre}.ff.ff.2", b["ff2"])
    put("norm_out.linear", tree["norm_out"])
    put("proj_out", tree["proj_out"])
    sd[prefix + "rotary_embed.inv_freq"] = \
        torch.ones(cfg.dim_head // 2).numpy()
    return sd


@pytest.mark.parametrize("prefix", ["", "ema_model.transformer."])
def test_importer_reads_f5_names_into_the_reference_output(case, prefix):
    params, audio, ids = case
    sd = _f5_names(params.dit, CFG.dit, prefix)
    imported = F5Params(dit=import_f5_state_dict(sd, CFG.dit),
                        vocoder=params.vocoder)
    st = build_stage_fns(CFG)
    cond = _cond(imported, audio)
    y = torch.randn(2, N, CFG.dit.mel_dim)
    got = st["velocity"](imported, cond, st["text_encode"](imported, ids, N),
                         y, torch.full((2,), 0.8))
    want = ref.velocity({"dit": params.dit}, D["dit"], D["sampler"], cond,
                        ids, y, 0.8, None)
    assert rel(got, want) < 1e-5
    assert not math.isnan(float(got.abs().max()))


def test_served_request_records_its_spans_and_the_stages_compose(case):
    """The request's spans in order; the stages give the served waveform
    bit for bit (the benchmark's check reruns them so)."""
    from ditto_tts_tpu_torch.utils.profiling import recording
    params, audio, ids = case
    serve = build_synthesize_pipelined(CFG, device="cpu")
    with recording() as rec:
        wave = serve(params, audio, torch.ones(2, SAMPLES), ids,
                     torch.Generator().manual_seed(4))
    names = [s["name"] for s in rec.spans()]
    assert names == ["request", "mel", "text_encode", "sampler",
                     *["sampler.step"] * CFG.sampler.steps, "vocoder"]
    assert rec.spans()[3]["attrs"]["graph"] == "eager"
    st = build_stage_fns(CFG)
    with torch.inference_mode():
        cond, rms = st["mel"](params, audio)
        full = st["sampler"](params, cond, st["text_encode"](params, ids, N),
                             torch.Generator().manual_seed(4))
        again = st["loudness"](st["vocoder"](
            params, full[:, cond.shape[1]:].transpose(1, 2)), rms)
    assert torch.equal(again, wave)
    with pytest.raises(ValueError, match="one length"):
        mask = torch.ones(2, SAMPLES)
        mask[0, -5:] = 0
        serve(params, audio, mask, ids, torch.Generator().manual_seed(4))


@pytest.mark.parametrize("builder", [build_stage_fns,
                                     build_synthesize_pipelined])
@pytest.mark.parametrize("option", [{"sampler_kind": "ddim"},
                                    {"cond_by_audio": True},
                                    {"ref_compat": True}])
def test_f5_builders_refuse_dittos_sampler_options(builder, option):
    """An option of DiTTo's sampler raises with an F5 configuration; the
    defaults build F5's chain."""
    where = {} if builder is build_stage_fns else {"device": "cpu"}
    with pytest.raises(ValueError, match=next(iter(option))):
        builder(CFG, **option, **where)
    assert builder(CFG, **where) is not None
