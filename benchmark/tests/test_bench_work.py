"""The operation and byte counts of ``benchmark/work`` at the cells'
shapes, against counts worked out by hand here."""

import json

import pytest

from benchmark import core
from benchmark.work import act_conv, attention, codec, dit, peaks, vocoder


def _pipe(name):
    return json.loads((core.BENCH / "configs" / f"{name}.json").read_text())[
        "pipeline"]


BASE, REF = _pipe("ditto-base"), _pipe("ditto-ref")


def test_frames_of_a_ten_second_prompt():
    assert codec.frames(BASE["codec"], 240000) == 750        # hop 320
    # reflect pad 384 each side, 1024-sample frames every 256
    assert codec.mel_frames(BASE["vocoder"], 240000) == (240000 + 768
                                                         - 1024) // 256 + 1
    assert vocoder.output_samples(BASE["vocoder"], 937) == 937 * 256


def test_attention_call_by_hand():
    f, b = attention.call(8, 12, 750, 750, 64, "bfloat16")
    assert f == 2 * 2 * 8 * 12 * 750 * 750 * 64
    assert b == 2 * (8 * 12 * 750 * 64) * 4          # q, k, v, out in bf16
    f, b = attention.call(8, 12, 750, 64, 64, "float32")
    assert b == 4 * (2 * 8 * 12 * 750 * 64 + 2 * 8 * 12 * 64 * 64)


def test_dit_step_by_hand():
    tok, h, m = 8 * 750, 768, 3072
    layer = (2 * tok * h * 3 * h              # q, k, v
             + 4 * 8 * 12 * 750 * 750 * 64    # self-attention products
             + 3 * 2 * tok * h * h            # self out, cross q, cross out
             + 4 * 8 * 12 * 750 * 64 * 64     # cross-attention products
             + 3 * 2 * tok * h * m)           # fc1, gate, fc2
    blocks, other = dit.step_flops(BASE["dit"], 8, 750, 64)
    assert blocks == 12 * layer == 1_708_867_584_000
    assert other == 2 * 2 * tok * h * h + 2 * 8 * (2 * 256 * 256
                                                   + 256 * 2 * h
                                                   + h * 2 * h)
    # the reference's DiT: 5 layers, one head of 768, no self out_proj
    ref_layer = layer - 2 * tok * h * h
    assert dit.step_flops(REF["dit"], 8, 750, 64)[0] == 5 * ref_layer
    assert dit.request_flops(BASE["dit"], 8, 64) == 12 * 2 * 2 * 8 * 64 * h * h
    calls = dit.attention_calls(BASE["dit"], 8, 750, 64)
    assert len(calls) == 24 and calls[0] == attention.call(
        8, 12, 750, 750, 64, "bfloat16")


def test_train_step_counts_remat_attention_once_more():
    d = dict(BASE["dit"], remat_blocks=True,
             remat_policy="dots_with_no_batch_dims_saveable")
    blocks, other = dit.step_flops(d, 8, 750, 750)
    fwd = blocks + other + dit.request_flops(d, 8, 750)
    again = 12 * (4 * 8 * 12 * 750 * 750 * 64 * 2)  # self + cross, St = 750
    assert dit.train_step_flops(d, 8, 750, 750) == 3 * fwd + again


def test_vocoder_by_hand():
    v, f = BASE["vocoder"], 937
    widths = [768, 384, 192, 96, 48, 24]
    t = [f * 4, f * 16, f * 32, f * 64, f * 128, f * 256]
    assert vocoder.stages(v, f) == list(zip(widths, t))
    total = 2 * 8 * f * 100 * 1536 * 7
    cin, tin = 1536, f
    for w, tt, k in zip(widths, t, (8, 8, 4, 4, 4, 4)):
        total += 2 * 8 * tin * cin * w * k
        total += sum(6 * 2 * 8 * tt * w * w * rk for rk in (3, 7, 11))
        cin, tin = w, tt
    total += 2 * 8 * t[-1] * 24 * 7
    assert vocoder.flops(v, 8, f) == total


def test_act_conv_pairs_by_hand():
    v, f = BASE["vocoder"], 937
    assert act_conv.fused_stage_widths(v, f) == [(384, f * 16), (192, f * 32),
                                                 (96, f * 64)]
    calls = act_conv.calls(v, 8, f)
    assert len(calls) == 3 * 3 * 6                   # 54 a forward
    w, t, k = 384, f * 16, 3
    assert calls[0][0] == 2 * 8 * w * w * k * t + 56 * 8 * w * t
    assert calls[0][1] == 2 * (2 * 8 * w * t + w * w * k) + 4 * 3 * w
    other = dict(v, aa_impl="polyphase")
    assert act_conv.calls(other, 8, f) == []


def test_codec_by_hand():
    c = BASE["codec"]
    # decoder: 128 -> 512 conv k7, LSTM 2 x 512, four up stages, final conv
    t, total, ch = 750, 2 * 8 * 750 * 128 * 512 * 7, 512
    total += 2 * 2 * 8 * 750 * 4 * 512 * 1024
    for r in (8, 5, 4, 2):
        total += 2 * 8 * t * ch * (ch // 2) * 2 * r
        t, ch = t * r, ch // 2
        total += 2 * 8 * t * (ch * (ch // 2) * 3 + (ch // 2) * ch + ch * ch)
    total += 2 * 8 * t * 32 * 1 * 7
    assert codec.decode_flops(c, 8, 750) == total
    assert codec.vq_flops(8, 750, 768, 1024) == 2 * 8 * 2 * 750 * 768 * 1024


@pytest.mark.parametrize("dt,peak", [("bfloat16", 989e12),
                                     ("float32", 67e12), ("tf32", 495e12)])
def test_least_seconds_takes_the_larger_bound(dt, peak):
    assert peaks.least_seconds(peak, 0, dt) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 3.35e12, dt) == pytest.approx(1.0)
    assert peaks.least_seconds(peak, 2 * 3.35e12, dt) == pytest.approx(2.0)
