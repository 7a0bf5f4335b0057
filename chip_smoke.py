#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's DiTTo serving chain on one NVIDIA H100.

    python3 chip_smoke.py        (from the root of a checkout; one CUDA card)

Phases (any failure exits non-zero and prints no result line):
  1. device   the card's name and power limit (nvidia-smi), torch / CUDA
  2. build    nvcc builds kernels A, B, C, D from ditto_tts_tpu_torch/csrc/
              (one nvcc per source, all at once); each kernel's registers
              and spills (ptxas) and tensor-core instructions (cuobjdump
              -sass, which the toolkit must have), which must be in every
              bf16 kernel of A, B and C (*_kernel_tc) and in none of their
              fp32 kernels, the weight reorder, or D
  3. kernels  each kernel against its plain PyTorch version at the paths'
              shapes, bf16 and fp32, with the stated tolerance (A at the
              DiT's four shapes; B at every bf16 shape class of the vocoder
              (kernel_bench.CONV_SHAPES), the SEANet shapes, and as the
              whole-batch conv #4 and its B=1 gate; C, also with the
              residual epilogue at widths 48 / 24; D in both modes, on
              [B, C, T] and [B, T, C], with a ragged T and T < 8); kernel
              and library times (device ms of a replayed CUDA graph), the
              plain version's, and the bound
  4. serving  the full-width chain of bench.py (12-layer 768-wide DiT,
              50 DDPM steps, EnCodec 1.5 kbps, BigVGAN v2 24 kHz) through
              build_synthesize_pipelined: the 10 s bucket at B=4 (warm-up,
              three timed requests with different seeds, a repeat of one
              seed that must be bitwise equal) and the 20 s bucket at B=4;
              launches of every kernel, read over this phase, must be
              exactly those of the default path (per request A 1200, B 90,
              C 54, D 0); the shapes of A's and B's calls in the untimed
              warm-up request
  5. parity   full width, 1 s prompt, B=1, fp32 with TF32 off, all 50
              steps (respaced to 4 steps, the first step's beta rounds to
              1.0 in fp32 and the update divides by zero, in JAX too):
              build_synthesize_recorded with the same numpy noise on the
              card and on the CPU (plain versions); refined latents
              (max|err| <= LATENT_TOL x max|CPU|), VQ index agreement, and
              the CPU's indices decoded on the card
  6. the vocoder under aa_impl="fused_pallas": the 10 s bucket at B=4
     (warm-up and two timed requests; per request D 108, C 0; the shapes of
     A's and B's calls in the warm-up), the vocoder
     stage on phase 4's mel under both settings in turns, and the
     full-width vocoder at B=1, fp32, on the card against the CPU (max
     |err| <= 1e-3)
  7. the vocoder under aa_impl="fused_ncl" on BigVGAN's last two stages
     (widths 48 and 24 from 60032 mel frames, B=4; C 36 launches, half of
     them with the residual), card against CPU at B=1, and the JAX error
     at full width
  8. the SLP-driven chain (build_synthesize_with_slp: ByT5-small, the
     one-layer SLP decoder with one 1472-wide head, then the DiT over a
     max-length buffer) at max_audio_seconds=10 (750-frame buffer), B=4, 10
     s prompts, 64 GPT2 and 64 ByT5 ids: warm-up, two timed requests, a
     repeat of one seed that must be bitwise equal; per request exactly
     the default path's launches (A 1200, B 90, C 54, D 0) and 2
     matmul-softmax attention calls in the decoder (head_dim > 128) and 12
     in ByT5 (biased), counted in the warm-up; the SLP, sampler and tail
     stages and the predicted frames; one request at the default
     AudioConfig (1024-frame buffer); SLP logits and frames, card against
     CPU, B=1 per utterance, fp32; the sampler and tail stages with frames
     30 and 60 in a 75-frame buffer (the frame mask), card against CPU
     with the same noise, fp32
  9. DDIM: the 10 s bucket at B=4 through build_synthesize_pipelined
     (sampler_kind="ddim"; warm-up, two timed requests, the repeat; the
     default path's launches); build_synthesize against it for one seed,
     bitwise; ddim_sample at eta = 0 over the full-width DiT, card against
     CPU at phase 5's shape and tolerance; then default, SLP and DDIM requests in turns
 10. a {"kernels": [...]} line, then the card line, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Weights are random (numpy seed 0, init_generator_params); nothing is
downloaded. With DITTO_RECORD_DIR set, a JSON record of every number goes
to $DITTO_RECORD_DIR/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = {"float32": 2e-5, "bfloat16": 1e-2}   # max |err| / max |plain|
# the fp32 DiT's refined latents, card vs CPU: max |err| / max |CPU| (the
# random-weight trajectory grows to ~1e6-1e7; measured ~6e-7 and ~1e-6)
LATENT_TOL = 1e-5


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    """kernel_bench.bound_ms at the peak of the operands' type (the H100's
    bf16 tensor-core rate, or its fp32 rate outside the tensor cores)."""
    import torch
    from ditto_tts_tpu_torch import kernel_bench as kb
    return kb.bound_ms(flops, nbytes, kb.PEAK_BF16 if dtype == torch.bfloat16
                       else kb.PEAK_FP32)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# launches of each kernel per 10 s / B=4 request on each path
DEFAULT_PATH = {"attention": 1200, "conv1d": 90, "act_conv": 54, "snake": 0}
FUSED_PALLAS_PATH = {"attention": 1200, "conv1d": 90 + 54, "act_conv": 0,
                     "snake": 108}
# BigVGAN's last two stages under aa_impl="fused_ncl", one forward
FUSED_NCL_PATH = {"attention": 0, "conv1d": 4, "act_conv": 36, "snake": 0}
# matmul-softmax attention per SLP-chain request (no kernel: JAX computes
# both outside Pallas): the decoder's self and cross attention over one
# 1472-wide head, and ByT5's biased attention in each of its 12 layers
SLP_PLAIN_ATTENTION = {"decoder": 2, "byt5": 12}


class ShapeLog:
    """Counts the calls of kernels A and B by shape while it is entered:
    it wraps the wrappers (``attention_cuda``, ``conv1d_cuda``), which the
    dispatching functions look up at call time, and restores them after."""

    def __enter__(self):
        from ditto_tts_tpu_torch.ops import attention as A, conv as B
        self.mods = (A, B)
        self.saved = (A.attention_cuda, B.conv1d_cuda)
        self.counts = counts = {}
        attn, conv = self.saved

        def logged_attn(q, k, v, *, causal=False, sm_scale=None,
                        kv_len=None):
            key = (f"attention {str(q.dtype)[6:]} B{q.shape[0]} "
                   f"H{q.shape[1]} Sq{q.shape[2]} Sk{k.shape[2]} "
                   f"D{q.shape[3]} causal={causal} kv_len={kv_len}")
            counts[key] = counts.get(key, 0) + 1
            return attn(q, k, v, causal=causal, sm_scale=sm_scale,
                        kv_len=kv_len)

        def logged_conv(x, weight, bias=None, *, dilation=1):
            b, c, t = x.shape
            o, _, k = weight.shape
            key = (f"conv1d {str(x.dtype)[6:]} B{b} C{c} O{o} K{k} "
                   f"dil{dilation} T{t - (k - 1) * dilation}")
            counts[key] = counts.get(key, 0) + 1
            return conv(x, weight, bias, dilation=dilation)

        A.attention_cuda, B.conv1d_cuda = logged_attn, logged_conv
        return self

    def __exit__(self, *exc):
        A, B = self.mods
        A.attention_cuda, B.conv1d_cuda = self.saved

    def report(self, label: str) -> dict:
        log(f"  shapes of kernels A and B in one {label} request "
            f"({sum(self.counts.values())} calls):")
        for key, n in sorted(self.counts.items()):
            log(f"    {n:4d} x {key}")
        return dict(self.counts)


class PlainAttentionLog:
    """Counts the SLP chain's matmul-softmax attention calls while it is
    entered, by caller and shape: it wraps ``attention_plain`` where the
    decoder (``nn/transformer.py``) and ByT5 (``text/byt5.py``) look it up
    at call time, and restores it after."""

    def __enter__(self):
        from ditto_tts_tpu_torch.nn import transformer
        from ditto_tts_tpu_torch.text import byt5
        self.mods = {"decoder": transformer, "byt5": byt5}
        self.saved = {k: m.attention_plain for k, m in self.mods.items()}
        self.counts = {k: 0 for k in self.mods}
        self.shapes = {}

        def logged(name, fn):
            def call(q, k, v, **kw):
                self.counts[name] += 1
                key = (f"{name} {str(q.dtype)[6:]} B{q.shape[0]} "
                       f"H{q.shape[1]} Sq{q.shape[2]} Sk{k.shape[2]} "
                       f"D{q.shape[3]} causal={kw.get('causal', False)} "
                       f"bias={kw.get('bias') is not None}")
                self.shapes[key] = self.shapes.get(key, 0) + 1
                return fn(q, k, v, **kw)
            return call

        for name, mod in self.mods.items():
            mod.attention_plain = logged(name, self.saved[name])
        return self

    def __exit__(self, *exc):
        for name, mod in self.mods.items():
            mod.attention_plain = self.saved[name]


def check_launches(path: str, launches: dict, per_request: dict, n: int):
    """Every kernel launched exactly as often as the path runs it (n
    requests): a kernel of the path that never ran fails, and so does one
    that ran where the path has none."""
    want = {k: v * n for k, v in per_request.items()}
    if launches != want:
        fail(f"{path}: launches {launches}, expected {want}")


class Checks:
    """Kernel-vs-plain comparisons; a case outside tolerance fails the run
    at the end of the phase, after every case has printed."""

    def __init__(self):
        self.bad = []

    def compare(self, kernel: str, label: str, got, want, dtype_name: str):
        import torch
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = max(want.float().abs().max().item(), 1e-30)
        ok = bool(torch.isfinite(got.float()).all()) and \
            err <= TOL[dtype_name] * scale
        log(f"  {kernel:9s} {label:44s} max_abs_err {err:.3e} rel "
            f"{err / scale:.2e} (max|plain| {scale:.3e}, tol "
            f"{TOL[dtype_name]:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            self.bad.append(f"{kernel} {label}: err {err} scale {scale}")
        return err


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def kernel_phase(torch, rec):
    import torch.nn.functional as F
    from ditto_tts_tpu_torch.ops.act_conv import (aa_snake_conv1d_cuda,
                                                  aa_snake_conv1d_plain)
    from ditto_tts_tpu_torch.kernel_bench import (cuda_ms, eager_ms,
                                                  run_attention, run_conv)
    from ditto_tts_tpu_torch.ops.attention import (attention_cuda,
                                                   attention_plain)
    from ditto_tts_tpu_torch.ops.conv import (conv1d_cuda, conv1d_ncl_batched,
                                              conv1d_plain)
    from ditto_tts_tpu_torch.ops.snake import snake_coeffs
    from ditto_tts_tpu_torch.ops.snake_fused import (fused_snake_cuda,
                                                     fused_snake_plain)

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(1234)
    checks = Checks()
    entries = {}    # the kernels line: one shape per kernel
    sites = {}      # PERF.md's table: every Pallas site at its path's shapes

    def rn(*shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen,
                                    device=dev)).to(dtype)

    def timed(shape, err, fn, plain, flops, nb, op_dtype, library=None):
        # kernel and library: device ms from a replayed CUDA graph; the
        # plain version (which copies host tables) in eager calls
        b, by = bound_ms(flops, nb, op_dtype)
        return {"shape": shape, "max_abs_err": err, "ms": cuda_ms(torch, fn),
                "plain_ms": eager_ms(torch, plain, 10.0),
                "library_ms": None if library is None
                else cuda_ms(torch, library),
                "bound_ms": b, "bound_by": by}

    dtypes = (torch.bfloat16, torch.float32)
    bf16 = torch.bfloat16

    # ---- A: attention (self at the 10 s / 20 s latent lengths, cross) ----
    for dt in dtypes:
        dn = str(dt).split(".")[1]
        for sq, sk in ((750, 750), (1024, 1024), (750, 64), (1024, 64)):
            q, k, v = (rn(4, 12, s, 64, dtype=dt) for s in (sq, sk, sk))
            got = attention_cuda(q, k, v)
            want = attention_plain(q, k, v)
            err = checks.compare("attention", f"{dn} B4 H12 Sq{sq} Sk{sk} "
                                 "D64", got, want, dn)
            if dt == bf16 and (sq, sk) == (750, 750):
                entries["attention"] = timed(
                    "bf16 B=4 H=12 Sq=Sk=750 D=64 (10 s self)", err,
                    lambda: attention_cuda(q, k, v),
                    lambda: attention_plain(q, k, v),
                    4.0 * 4 * 12 * sq * sk * 64, nbytes(q, k, v, got), dt,
                    lambda: F.scaled_dot_product_attention(q, k, v))

    # ---- A at the four shapes of the DiT's calls, beside SDPA ----
    rec["attention_shapes"] = run_attention(
        torch, gen, lambda label, got, want: checks.compare(
            "attention", f"bf16 {label}", got, want, "bfloat16"))

    # ---- B: conv1d at SEANet and vocoder shapes ----
    conv_cases = [   # (label, B, C, T_out, O, K, dil, dtype)
        ("SEANet resblock 32->16 k3", 4, 32, 240000, 16, 3, 1, torch.float32),
        ("SEANet final 32->1 k7", 4, 32, 240000, 1, 7, 1, torch.float32),
        ("vocoder conv_pre 100->1536 k7", 4, 100, 938, 1536, 7, 1, bf16),
        ("vocoder 768 k11 d5", 4, 768, 3752, 768, 11, 5, bf16),
        ("vocoder 384 k11 d5", 4, 384, 15008, 384, 11, 5, bf16),
        ("vocoder 24 k11 d5", 4, 24, 240128, 24, 11, 5, bf16),
        ("vocoder upsample poly 96->2x48 k2", 4, 96, 60033, 96, 2, 1, bf16),
    ]
    for label, b_, c, t_out, o, k, dil, dt0 in conv_cases:
        for dt in (dt0,) if dt0 == torch.float32 else dtypes:
            dn = str(dt).split(".")[1]
            x = rn(b_, c, t_out + (k - 1) * dil, dtype=dt)
            w = rn(o, c, k, dtype=dt, scale=(c * k) ** -0.5)
            bias = rn(o)
            got = conv1d_cuda(x, w, bias, dilation=dil)
            want = conv1d_plain(x, w, bias, dilation=dil)
            err = checks.compare("conv1d", f"{dn} {label} T{t_out}", got,
                                 want, dn)
            if label.startswith("vocoder 768") and dt == bf16:
                entries["conv1d"] = timed(
                    f"bf16 B=4 C=O=768 K=11 dil=5 T={t_out} (vocoder stage "
                    "0)", err, lambda: conv1d_cuda(x, w, bias, dilation=dil),
                    lambda: conv1d_plain(x, w, bias, dilation=dil),
                    2.0 * b_ * o * c * k * t_out, nbytes(x, w, bias, got), dt,
                    lambda: F.conv1d(x, w, bias.to(dt), dilation=dil))

    # ---- B at every bf16 shape class of the vocoder, beside F.conv1d ----
    rec["conv_shapes"] = run_conv(
        torch, gen, lambda label, got, want: checks.compare(
            "conv1d", f"bf16 {label}", got, want, "bfloat16"))

    # ---- B as #4: the whole-batch time-minor conv (codec geometry) and
    # its B=1 gate ----
    for dt in dtypes:
        dn = str(dt).split(".")[1]
        for b_ in (8, 1):
            x = rn(b_, 32, 240002, dtype=dt)
            w = rn(32, 32, 3, dtype=dt, scale=96 ** -0.5)
            bias = rn(32)
            got = conv1d_ncl_batched(x, w, bias)
            want = conv1d_plain(x, w, bias)
            err = checks.compare("conv1d", f"#4 {dn} B{b_} C=O=32 T240000 K3"
                                 + (" (gated)" if b_ == 1 else ""), got, want,
                                 dn)
            if b_ == 8 and dt == torch.float32:
                sites["#4"] = timed(
                    "fp32 B=8 C=O=32 K=3 T=240000 (its docstring's codec "
                    "geometry)", err, lambda: conv1d_ncl_batched(x, w, bias),
                    lambda: conv1d_plain(x, w, bias),
                    2.0 * 8 * 32 * 32 * 3 * 240000, nbytes(x, w, bias, got),
                    dt, lambda: F.conv1d(x, w, bias))

    # ---- C: fused AA-SnakeBeta -> conv at the fused widths ----
    for c, t in ((384, 15008), (192, 30016), (96, 60032)):
        for dt in dtypes:
            dn = str(dt).split(".")[1]
            x = rn(4, c, t, dtype=dt, scale=2.0)
            a = torch.exp(rn(c, scale=0.3))
            inv_b = 1.0 / (torch.exp(rn(c, scale=0.3)) + 1e-9)
            for k in (3, 7, 11):
                w = rn(c, c, k, dtype=dt, scale=(c * k) ** -0.5)
                bias = rn(c)
                for dil in (1, 3, 5):
                    got = aa_snake_conv1d_cuda(x, a, inv_b, w, bias,
                                               dilation=dil)
                    want = aa_snake_conv1d_plain(x, a, inv_b, w, bias,
                                                 dilation=dil)
                    err = checks.compare("act_conv", f"{dn} C{c} T{t} K{k} "
                                         f"dil{dil}", got, want, dn)
                    if (c, k, dil, dt) == (384, 11, 5, bf16):
                        entries["act_conv"] = timed(
                            f"bf16 B=4 C=O=384 K=11 dil=5 T={t} (vocoder "
                            "stage 1)", err,
                            lambda: aa_snake_conv1d_cuda(
                                x, a, inv_b, w, bias, dilation=dil),
                            lambda: aa_snake_conv1d_plain(
                                x, a, inv_b, w, bias, dilation=dil),
                            2.0 * 4 * c * c * k * t + 56.0 * 4 * c * t,
                            nbytes(x, w, bias, a, inv_b, got), dt)

    # ---- C with the residual epilogue (#7) at the narrow stages ----
    for c, t in ((48, 120064), (24, 240128)):
        for dt in dtypes:
            dn = str(dt).split(".")[1]
            x = rn(4, c, t, dtype=dt, scale=2.0)
            res = rn(4, c, t, dtype=dt)
            a = torch.exp(rn(c, scale=0.3))
            inv_b = 1.0 / (torch.exp(rn(c, scale=0.3)) + 1e-9)
            for k in (3, 7, 11):
                w = rn(c, c, k, dtype=dt, scale=(c * k) ** -0.5)
                bias = rn(c)
                for dil in (1, 3, 5):
                    for r in (None, res):
                        got = aa_snake_conv1d_cuda(x, a, inv_b, w, bias,
                                                   dilation=dil, residual=r)
                        want = aa_snake_conv1d_plain(x, a, inv_b, w, bias,
                                                     dilation=dil, residual=r)
                        err = checks.compare(
                            "act_conv", f"{dn} C{c} T{t} K{k} dil{dil}"
                            + (" +residual" if r is not None else ""), got,
                            want, dn)
                        if (k, dil, dt) == (11, 5, bf16) and r is not None:
                            sites[f"#7 C{c}"] = timed(
                                f"bf16 B=4 C=O={c} K=11 dil=5 T={t} "
                                "+residual", err,
                                lambda: aa_snake_conv1d_cuda(
                                    x, a, inv_b, w, bias, dilation=dil,
                                    residual=res),
                                lambda: aa_snake_conv1d_plain(
                                    x, a, inv_b, w, bias, dilation=dil,
                                    residual=res),
                                2.0 * 4 * c * c * k * t + 57.0 * 4 * c * t,
                                nbytes(x, w, bias, a, inv_b, res, got), dt)

    # ---- C's tensor-core path at the edges of its tiles: T off BN, O off
    # BM, C off KC, T just above the wrappers' short-sequence gates, and an
    # fp32 output with bf16 operands ----
    for b_, c, t, o, k, dil in ((1, 40, 300, 70, 7, 3),
                                (2, 100, 257, 200, 11, 5),
                                (1, 64, 400, 384, 11, 5),
                                (1, 70, 129, 48, 3, 1), (1, 24, 65, 24, 11, 5),
                                (1, 48, 129, 48, 11, 5),
                                (1, 33, 1000, 24, 3, 1)):
        x = rn(b_, c, t, dtype=bf16, scale=2.0)
        a = torch.exp(rn(c, scale=0.3))
        inv_b = 1.0 / (torch.exp(rn(c, scale=0.3)) + 1e-9)
        w = rn(o, c, k, dtype=bf16, scale=(c * k) ** -0.5)
        bias = rn(o)
        for ydt in dtypes:
            res = rn(b_, o, t, dtype=ydt)
            checks.compare(
                "act_conv", f"tile edge B{b_} C{c} T{t} O{o} K{k} dil{dil} "
                f"+res -> {str(ydt)[6:]}",
                aa_snake_conv1d_cuda(x, a, inv_b, w, bias, dilation=dil,
                                     residual=res, out_dtype=ydt),
                aa_snake_conv1d_plain(x, a, inv_b, w, bias, dilation=dil,
                                      residual=res, out_dtype=ydt),
                "bfloat16")

    # ---- D: the standalone AA snake, #9 mode (fp32 upsample taps) at the
    # NLC widths on a [B, T, C] tensor and on the [B, C, T] carry, #8 mode
    # (taps in x's type) at the NCL-hybrid widths; a ragged T, T < 8, T
    # shorter than one 16-sample run (5, 7) and one run + 1 (17), rows off
    # the 16-byte grid (3748, the 768-wide stage's T in a 10 s request),
    # and [B, C, T] views an odd number of elements into their storage ----
    d_cases = [("#9", 768, 3752), ("#9", 768, 3748), ("#9", 384, 15008),
               ("#9", 192, 30016), ("#9", 96, 60032), ("#8", 48, 120064),
               ("#8", 24, 240128),
               ("#9", 100, 1000), ("#8", 40, 1000), ("#9", 96, 5),
               ("#8", 24, 7), ("#9", 96, 17), ("#8", 24, 17)]
    for site, c, t in d_cases:
        up_x = site == "#8"
        for dt in dtypes:
            dn = str(dt).split(".")[1]
            for with_beta in (True, False):
                a, inv_b = snake_coeffs(rn(c, scale=0.3), rn(c, scale=0.3)
                                        if with_beta else None)
                views = ["[B,C,T]"] + (["[B,T,C]"] if site == "#9" else []) \
                    + (["[B,C,T] at offset 1"] if t <= 1000 else [])
                for view in views:
                    if view == "[B,C,T]":
                        x = rn(4, c, t, dtype=dt, scale=2.0)
                    elif view == "[B,T,C]":
                        x = rn(4, t, c, dtype=dt, scale=2.0).transpose(1, 2)
                    else:
                        x = rn(1 + 4 * c * t, dtype=dt,
                               scale=2.0)[1:].view(4, c, t)
                    got = fused_snake_cuda(x, a, inv_b, up_in_x_dtype=up_x)
                    want = fused_snake_plain(x, a, inv_b, up_in_x_dtype=up_x)
                    err = checks.compare(
                        "snake", f"{site} {dn} B4 C{c} T{t} {view} "
                        + ("snakebeta" if with_beta else "snake"), got, want,
                        dn)
                    if dt == bf16 and with_beta and t >= 3752 and (
                            view == "[B,C,T]" or c == 384):
                        key = f"{site} C{c}" + (" [B,T,C]" if view ==
                                                "[B,T,C]" else "")
                        sites[key] = timed(
                            f"bf16 B=4 C={c} T={t} {view}", err,
                            lambda: fused_snake_cuda(
                                x, a, inv_b, up_in_x_dtype=up_x),
                            lambda: fused_snake_plain(
                                x, a, inv_b, up_in_x_dtype=up_x),
                            55.0 * x.numel(), nbytes(x, got, a, inv_b),
                            torch.float32)
    entries["snake"] = sites["#9 C384"]
    if checks.bad:
        fail("kernel parity: " + "; ".join(checks.bad))
    for name, e in list(entries.items()) + list(sites.items()):
        lib = "n/a" if e["library_ms"] is None else f"{e['library_ms']:.4f}"
        log(f"  {name} at {e['shape']}: kernel {e['ms']:.4f} ms, plain "
            f"{e['plain_ms']:.4f} ms, library {lib} ms, bound "
            f"{e['bound_ms']:.4f} ms ({e['bound_by']})")
    for kind in ("attention_shapes", "conv_shapes"):
        for r in rec[kind]:
            log(f"  {kind.split('_')[0]:9s} {r['shape']}: kernel "
                f"{r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s), library "
                f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")
    rec["kernel_entries"] = entries
    rec["kernel_sites"] = sites
    return entries


# --------------------------------------------------------------------------
# phase 4: serving
# --------------------------------------------------------------------------

def serving_phase(torch, np, cfg, params, rec):
    from ditto_tts_tpu_torch import kernels
    from ditto_tts_tpu_torch.infer.generator import (
        build_stage_fns, build_synthesize_pipelined)

    serve = build_synthesize_pipelined(cfg)
    dev = torch.device("cuda")

    def request(seconds, batch, seed):
        n = 24000 * seconds
        rng = np.random.default_rng(seed)
        audio = torch.from_numpy(
            (0.05 * rng.standard_normal((batch, 1, n))).astype(np.float32))
        mask = torch.ones((batch, n), dtype=torch.int32)
        text = torch.from_numpy(rng.integers(0, 50257, (batch, 64)))
        return audio.to(dev), mask.to(dev), text.to(dev)

    def run(inputs, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wav = serve(params, *inputs, g)
        torch.cuda.synchronize()
        return wav, time.perf_counter() - t0

    def check(wav, label):
        if not bool(torch.isfinite(wav).all()):
            fail(f"serving {label}: non-finite waveform")
        if wav.abs().max().item() > 1.0:
            fail(f"serving {label}: waveform outside [-1, 1]")

    kernels.reset_launches()
    out = {}
    inputs = request(10, 4, 1)
    with ShapeLog() as shapes:      # untimed: the timed requests stay bare
        wav0, warm = run(inputs, 7)
    shape_log = shapes.report("default 10 s")
    check(wav0, "10s warm-up")
    times = []
    for seed in (7, 8, 9):
        wav, dt = run(inputs, seed)
        check(wav, f"10s seed {seed}")
        times.append(dt)
        if seed == 7 and not torch.equal(wav, wav0):
            fail("serving: the same seed gave a different waveform")
        if seed == 8 and torch.equal(wav, wav0):
            fail("serving: different seeds gave the same waveform")
    log(f"  10 s bucket B=4: waveform {tuple(wav0.shape)}, warm-up "
        f"{warm:.3f} s, requests {[round(t, 4) for t in times]} s, "
        f"{4 * 10 / min(times):.2f} audio-s/s")
    # audio_s_per_s counts the bucket's seconds, as bench.py does;
    # output_audio_s_per_s the waveform's (the 20 s bucket's latents are
    # cut to max_token_length frames, 13.65 s)
    out["10s"] = {"batch": 4, "warmup_s": warm, "request_s": times,
                  "shapes": shape_log,
                  "audio_s_per_s": 4 * 10 / min(times),
                  "output_audio_s_per_s": wav0.numel() / 24000 / min(times),
                  "waveform_shape": list(wav0.shape)}

    inputs20 = request(20, 4, 2)
    wav20, dt20 = run(inputs20, 7)
    check(wav20, "20s")
    log(f"  20 s bucket B=4: waveform {tuple(wav20.shape)}, {dt20:.3f} s "
        f"(first request at this shape), {4 * 20 / dt20:.2f} bucket-s/s, "
        f"{wav20.numel() / 24000 / dt20:.2f} output-audio-s/s")
    out["20s"] = {"batch": 4, "request_s": [dt20],
                  "audio_s_per_s": 4 * 20 / dt20,
                  "output_audio_s_per_s": wav20.numel() / 24000 / dt20,
                  "waveform_shape": list(wav20.shape)}
    launches = dict(kernels.launches)
    log(f"  launches over the serving phase (5 requests): {launches}")
    check_launches("default serving path", launches, DEFAULT_PATH, 5)

    # per-stage seconds of one 10 s request (host clock, synchronized)
    st = build_stage_fns(cfg)
    stages = {}

    def timed(name, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return res

    audio, mask, text = inputs
    with torch.inference_mode():
        g = torch.Generator(device=dev).manual_seed(7)
        lat = timed("encode", st["encode"], params, audio, mask)
        ref = timed("sampler", st["sampler"], params, lat, text, g)
        if not bool(torch.isfinite(ref).all()):
            fail("serving: refined latents are not finite")
        idx = timed("vq_indices", st["vq_indices"], params, ref)
        wav = timed("codec_decode", st["codec_decode"], params, idx,
                    audio.shape[-1])
        mel = timed("mel", st["mel"], params, wav)
        out_w = timed("vocoder", st["vocoder"], params, mel)
    if not torch.equal(out_w, wav0):
        fail("serving: the stage functions disagree with the serving path")
    log("  10 s stages (s): " + ", ".join(f"{k} {v:.4f}"
                                         for k, v in stages.items()))
    out["10s"]["stages_s"] = stages
    rec["serving"] = out
    return launches, inputs, mel


# --------------------------------------------------------------------------
# phase 6: the aa_impl="fused_pallas" path (kernel D)
# --------------------------------------------------------------------------

def sync_time(torch, fn, *args, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_wave(torch, wav, label):
    if not bool(torch.isfinite(wav).all()):
        fail(f"{label}: non-finite waveform")
    if wav.abs().max().item() > 1.0:
        fail(f"{label}: waveform outside [-1, 1]")


def card_vs_cpu(torch, label, forward, p_gpu, p_cpu, vcfg, mel):
    """The vocoder on the card against the CPU plain versions, fp32."""
    from ditto_tts_tpu_torch import kernels
    kernels.reset_launches()
    with torch.inference_mode():
        got = forward(p_gpu, vcfg, mel.cuda())
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        want = forward(p_cpu, vcfg, mel.cpu())
    err = (got.cpu() - want).abs().max().item()
    clamped = (want.abs() >= 1.0).float().mean().item()
    log(f"  {label}: card vs CPU max|err| {err:.3e} (bound 1e-3; "
        f"max|wav| {want.abs().max().item():.3f}, {clamped:.1%} clamped), "
        f"launches {launches}")
    if not err <= 1e-3:
        fail(f"{label}: card and CPU differ by {err}")
    return {"max_abs_err": err, "clamped_share": clamped,
            "launches": launches}


def fused_pallas_phase(torch, cfg, params, params_cpu, inputs, mel, rec):
    from ditto_tts_tpu_torch import kernels
    from ditto_tts_tpu_torch.infer.generator import (
        build_stage_fns, build_synthesize_pipelined)
    from ditto_tts_tpu_torch.models.vocoder import bigvgan_forward

    fcfg = cfg.replace(vocoder=cfg.vocoder.replace(aa_impl="fused_pallas"))
    serve = build_synthesize_pipelined(fcfg)
    dev = torch.device("cuda")
    out = {}
    kernels.reset_launches()
    times = []
    for i, seed in enumerate((7, 7, 8)):   # warm-up, then two timed requests
        with ShapeLog() if i == 0 else contextlib.nullcontext() as shapes:
            wav, dt = sync_time(torch, serve, params, *inputs,
                                torch.Generator(device=dev).manual_seed(seed))
        if i == 0:
            shape_log = shapes.report("fused_pallas 10 s")
        check_wave(torch, wav, f"fused_pallas seed {seed}")
        times.append(dt)
    launches = dict(kernels.launches)
    log(f"  10 s bucket B=4: warm-up {times[0]:.3f} s, requests "
        f"{[round(t, 4) for t in times[1:]]} s, "
        f"{4 * 10 / min(times[1:]):.2f} audio-s/s; launches over 3 requests "
        f"{launches}")
    check_launches("fused_pallas serving path", launches, FUSED_PALLAS_PATH,
                   3)
    out["10s"] = {"batch": 4, "warmup_s": times[0], "request_s": times[1:],
                  "shapes": shape_log,
                  "audio_s_per_s": 4 * 10 / min(times[1:]),
                  "launches_3_requests": launches}

    # both settings in turns (default, fused_pallas, fused_pallas, default),
    # whole requests and then the vocoder stage alone on phase 4's mel
    serves = {"fused_conv": build_synthesize_pipelined(cfg),
              "fused_pallas": serve}
    order = ("fused_conv", "fused_pallas", "fused_pallas", "fused_conv")
    req = {"fused_conv": [], "fused_pallas": []}
    for impl in order:
        req[impl].append(sync_time(
            torch, serves[impl], params, *inputs,
            torch.Generator(device=dev).manual_seed(7))[1])
    voc = {"fused_conv": [], "fused_pallas": []}
    with torch.inference_mode():
        for impl in order:
            voc[impl].append(sync_time(torch, bigvgan_forward,
                                       params.vocoder, cfg.vocoder, mel,
                                       aa_impl=impl)[1])
    for label, d in (("requests", req), ("vocoder stage", voc)):
        log(f"  10 s B=4 {label} in turns (s): " + "; ".join(
            f"{k} {[round(v, 4) for v in vs]}" for k, vs in d.items()))
    out["request_in_turns_s"] = req
    out["vocoder_stage_s"] = voc

    # the stages of one fused_pallas request (host clock, synchronized)
    st = build_stage_fns(fcfg)
    stages = {}
    audio, mask, text = inputs
    with torch.inference_mode():
        g = torch.Generator(device=dev).manual_seed(7)
        lat, stages["encode"] = sync_time(torch, st["encode"], params, audio,
                                          mask)
        ref, stages["sampler"] = sync_time(torch, st["sampler"], params, lat,
                                           text, g)
        idx, stages["vq_indices"] = sync_time(torch, st["vq_indices"],
                                              params, ref)
        wav, stages["codec_decode"] = sync_time(
            torch, st["codec_decode"], params, idx, audio.shape[-1])
        m, stages["mel"] = sync_time(torch, st["mel"], params, wav)
        _, stages["vocoder"] = sync_time(torch, st["vocoder"], params, m)
    log("  10 s stages, fused_pallas (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()))
    out["10s"]["stages_s"] = stages

    # full width, B=1, fp32, on the first ~1 s of that mel
    vcfg = cfg.vocoder.replace(aa_impl="fused_pallas",
                               compute_dtype="float32",
                               carry_dtype="float32")
    out["card_vs_cpu"] = card_vs_cpu(
        torch, "full-width vocoder, fused_pallas, B=1, 94 frames",
        bigvgan_forward, params.vocoder, params_cpu.vocoder, vcfg,
        mel[:1, :, :94].float())
    if out["card_vs_cpu"]["launches"]["snake"] != FUSED_PALLAS_PATH["snake"]:
        fail("fused_pallas: kernel D was not launched 108 times in one "
             "vocoder forward")
    rec["fused_pallas"] = out
    return launches


# --------------------------------------------------------------------------
# phase 7: aa_impl="fused_ncl" on BigVGAN's last two stages (kernel C with
# the residual epilogue)
# --------------------------------------------------------------------------

def fused_ncl_phase(torch, np, cfg, params, rec):
    from ditto_tts_tpu_torch import kernels
    from ditto_tts_tpu_torch.models.vocoder import bigvgan_forward
    from ditto_tts_tpu_torch.params import _vocoder_spec, fill_spec, tree_map

    # upsample_initial_channel 96, rates (2, 2): stages at 48 and 24, both
    # NCL-hybrid, as in the full model's last two stages
    ncfg = cfg.vocoder.replace(upsample_initial_channel=96,
                               upsample_rates=(2, 2),
                               upsample_kernel_sizes=(4, 4),
                               aa_impl="fused_ncl")
    p_cpu = tree_map(torch.from_numpy, fill_spec(_vocoder_spec(ncfg), 3))
    p_gpu = tree_map(lambda a: a.cuda(), p_cpu)
    rng = np.random.default_rng(12)
    mel = torch.from_numpy(rng.standard_normal((4, 100, 60032)).astype(
        np.float32)).cuda()
    out = {}
    with torch.inference_mode():
        kernels.reset_launches()
        wav, t_first = sync_time(torch, bigvgan_forward, p_gpu, ncfg, mel)
        launches = dict(kernels.launches)
        # against the default setting on the same stages, in turns
        turns = {"fused_conv": [], "fused_ncl": []}
        for impl in ("fused_conv", "fused_ncl", "fused_ncl", "fused_conv"):
            turns[impl].append(sync_time(torch, bigvgan_forward, p_gpu,
                                         ncfg, mel, aa_impl=impl)[1])
    check_wave(torch, wav, "fused_ncl")
    if tuple(wav.shape) != (4, 1, 240128):
        fail(f"fused_ncl: waveform shape {tuple(wav.shape)}")
    log(f"  B=4, 60032 mel frames -> stages 48 x 120064, 24 x 240128: "
        f"{t_first:.4f} s first; in turns (s): " + "; ".join(
            f"{k} {[round(v, 4) for v in vs]}" for k, vs in turns.items())
        + f"; launches {launches}")
    check_launches("fused_ncl vocoder", launches, FUSED_NCL_PATH, 1)
    out.update(first_s=t_first, in_turns_s=turns, launches=launches)

    out["card_vs_cpu"] = card_vs_cpu(
        torch, "fused_ncl stages, B=1, 300 frames", bigvgan_forward, p_gpu,
        p_cpu, ncfg.replace(compute_dtype="float32", carry_dtype="float32"),
        torch.from_numpy(rng.standard_normal((1, 100, 300)).astype(
            np.float32)))

    # at full width the first stage is channels-last, where the JAX package
    # raises for fused_ncl
    try:
        with torch.inference_mode():
            bigvgan_forward(params.vocoder,
                            cfg.vocoder.replace(aa_impl="fused_ncl"),
                            mel[:1, :, :16])
    except NotImplementedError as e:
        log(f"  full width under fused_ncl raises: {e}")
        out["full_width_raises"] = str(e)
    else:
        fail("fused_ncl at full width did not raise")
    rec["fused_ncl"] = out
    return launches


# --------------------------------------------------------------------------
# phase 5: chain parity, card vs CPU
# --------------------------------------------------------------------------

def parity_phase(torch, np, cfg, params_cpu, params_gpu, rec):
    from ditto_tts_tpu_torch.infer.generator import (build_synthesize_recorded,
                                                     indices_to_waveform)
    pcfg = cfg.replace(
        dit=cfg.dit.replace(compute_dtype="float32"),
        vocoder=cfg.vocoder.replace(compute_dtype="float32",
                                    carry_dtype="float32"))
    k_steps = pcfg.sampler.num_steps
    n = 24000
    frames = -(-n // pcfg.codec.hop_length)
    rng = np.random.default_rng(5)
    audio = (0.05 * rng.standard_normal((1, 1, n))).astype(np.float32)
    mask = np.ones((1, n), np.int32)
    text = rng.integers(0, 50257, (1, 64))
    h = pcfg.dit.hidden_dim
    pn = rng.standard_normal((1, frames, h)).astype(np.float32)
    init = rng.standard_normal((1, frames, h)).astype(np.float32)
    steps = rng.standard_normal((k_steps, 1, frames, h)).astype(np.float32)

    t0 = time.perf_counter()
    gw, gi = build_synthesize_recorded(pcfg, device="cuda")(
        params_gpu, audio, mask, text, pn, init, steps)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    cw, ci = build_synthesize_recorded(pcfg, device="cpu")(
        params_cpu, audio, mask, text, pn, init, steps)
    t_cpu = time.perf_counter() - t0

    res = {}
    lat_err = (gi["latents"].cpu() - ci["latents"]).abs().max().item()
    ref_c = ci["refined"]
    ref_err = (gi["refined"].cpu() - ref_c).abs().max().item()
    ref_scale = ref_c.abs().max().item()
    if not (torch.isfinite(ref_c).all() and torch.isfinite(cw).all()):
        fail("parity: the CPU chain is not finite")
    agree = (gi["indices"].cpu() == ci["indices"]).float().mean().item()
    with torch.inference_mode():
        w_from_cpu_idx = indices_to_waveform(
            params_gpu, pcfg, ci["indices"].cuda(), n)
    wav_err = (w_from_cpu_idx.cpu() - cw).abs().max().item()
    res = {"latents_max_abs_err": lat_err,
           "refined_max_abs_err": ref_err, "refined_max_abs": ref_scale,
           "vq_index_agreement": agree,
           "waveform_from_cpu_indices_max_abs_err": wav_err,
           "waveform_max_abs": cw.abs().max().item(),
           "gpu_s": t_gpu, "cpu_s": t_cpu}
    log(f"  latents max|err| {lat_err:.3e}; refined max|err| {ref_err:.3e} "
        f"(scale {ref_scale:.3e}, tol {LATENT_TOL} x scale); VQ index "
        f"agreement {agree:.4f}; "
        f"waveform from the CPU's indices max|err| {wav_err:.3e}")
    rec["parity"] = res
    if not (lat_err <= 1e-4 * max(ci["latents"].abs().max().item(), 1.0)):
        fail(f"parity: encoder latents differ by {lat_err}")
    if not ref_err <= LATENT_TOL * ref_scale:
        fail(f"parity: refined latents differ by {ref_err} (scale "
             f"{ref_scale}, tol {LATENT_TOL} x scale)")
    if not agree >= 0.99:
        fail(f"parity: VQ index agreement {agree} < 0.99")
    if not wav_err <= 1e-3:
        fail(f"parity: waveform from the CPU's indices differs by {wav_err}")


# --------------------------------------------------------------------------
# phase 8: the SLP-driven chain
# --------------------------------------------------------------------------

def slp_inputs(torch, np, seed):
    """10 s prompts at B=4, 64 GPT2 ids and 64 ByT5 ids, as
    scripts/slp_chain_bench.py draws them."""
    rng = np.random.default_rng(seed)
    n = 24000 * 10
    dev = torch.device("cuda")
    audio = torch.from_numpy(
        (0.05 * rng.standard_normal((4, 1, n))).astype(np.float32)).to(dev)
    mask = torch.ones((4, n), dtype=torch.int32, device=dev)
    text = torch.from_numpy(rng.integers(0, 50257, (4, 64))).to(dev)
    bids = torch.from_numpy(rng.integers(3, 250, (4, 64))).to(dev)
    bmask = torch.ones((4, 64), dtype=torch.int32, device=dev)
    return audio, mask, text, bids, bmask


def whole_mel_frames(wav, batch, frames, cfg) -> bool:
    """The codec decodes frames * hop_length samples; the vocoder renders
    the whole mel frames of that waveform, so up to one mel hop less."""
    n = frames * cfg.codec.hop_length
    return wav.shape[0] == batch and n - cfg.vocoder.hop_size < \
        wav.shape[1] <= n


def frame_mask_check(torch, np, cfg, p_gpu, p_cpu) -> dict:
    """The SLP chain's sampler and tail stages with explicit frames below
    the buffer (the random SLP predicts more than any buffer holds), the
    same numpy noise on the card and the CPU: a 75-frame (1 s) buffer,
    B=2, frames 30 and 60, fp32, all 50 steps."""
    from ditto_tts_tpu_torch.infer.generator import build_slp_stage_fns

    mcfg = cfg.replace(
        audio=cfg.audio.replace(max_audio_seconds=1.0),
        dit=cfg.dit.replace(compute_dtype="float32"),
        vocoder=cfg.vocoder.replace(compute_dtype="float32",
                                    carry_dtype="float32"))
    st = build_slp_stage_fns(mcfg)
    max_frames = min(mcfg.audio.max_latent_frames, mcfg.dit.max_token_length)
    rng = np.random.default_rng(41)
    text = torch.from_numpy(rng.integers(0, 50257, (2, 64)))
    init = torch.from_numpy(rng.standard_normal(
        (2, max_frames, mcfg.dit.hidden_dim)).astype(np.float32))
    steps = torch.from_numpy(rng.standard_normal(
        (mcfg.sampler.num_steps,) + tuple(init.shape)).astype(np.float32))
    frames = torch.tensor([30, 60])

    def sample(p, device):
        with torch.inference_mode():
            return st["sampler"](p, text.to(device), frames.to(device),
                                 init_noise=init.to(device),
                                 step_noise=steps.to(device))

    t0 = time.perf_counter()
    ref_g = sample(p_gpu, "cuda").cpu()
    ref_c = sample(p_cpu, "cpu")
    # the tail on both sides from the CPU's latents, so a VQ near-tie of
    # two nearly equal inputs cannot flip an index
    with torch.inference_mode():
        wav_g = st["tail"](p_gpu, ref_c.cuda()).cpu()
        wav_c = st["tail"](p_cpu, ref_c)
    ref_err = (ref_g - ref_c).abs().max().item()
    ref_scale = ref_c.abs().max().item()
    wav_err = (wav_g - wav_c).abs().max().item()
    zero_past = all(bool((ref_g[b, f:] == 0).all())
                    for b, f in enumerate(frames.tolist()))
    live_before = all(bool((ref_g[b, :f].abs().amax(-1) > 0).all())
                      for b, f in enumerate(frames.tolist()))
    res = {"max_frames": max_frames, "frames": frames.tolist(),
           "refined_max_abs_err": ref_err, "refined_max_abs": ref_scale,
           "waveform_max_abs_err": wav_err,
           "waveform_max_abs": wav_c.abs().max().item(),
           "zero_past_frames": zero_past, "nonzero_before": live_before,
           "s": time.perf_counter() - t0}
    log(f"  frame mask, {max_frames}-frame buffer, frames {frames.tolist()}, "
        f"fp32: refined card vs CPU max|err| {ref_err:.3e} (scale "
        f"{ref_scale:.3e}, tol {LATENT_TOL} x scale), zero past the frames "
        f"{zero_past}, nonzero before {live_before}; waveform max|err| "
        f"{wav_err:.3e} (tol 1e-3), {res['s']:.1f} s")
    if not (torch.isfinite(ref_c).all() and torch.isfinite(wav_c).all()):
        fail("SLP frame mask: the CPU's sampler or tail is not finite")
    if not (zero_past and live_before):
        fail("SLP frame mask: the card's refined latents are not zero "
             "exactly past each utterance's frames")
    if not ref_err <= LATENT_TOL * ref_scale:
        fail(f"SLP frame mask: refined latents differ by {ref_err} (scale "
             f"{ref_scale})")
    if not (whole_mel_frames(wav_g, 2, max_frames, mcfg)
            and wav_err <= 1e-3):
        fail(f"SLP frame mask: waveform {tuple(wav_g.shape)} differs from "
             f"the CPU's by {wav_err}")
    return res


def slp_phase(torch, np, cfg, params, params_cpu, rec):
    import dataclasses
    from ditto_tts_tpu_torch import kernels
    from ditto_tts_tpu_torch.codec.encodec import codec_encode
    from ditto_tts_tpu_torch.infer.generator import (
        build_slp_stage_fns, build_synthesize_with_slp)
    from ditto_tts_tpu_torch.params import init_slp_params, tree_map
    from ditto_tts_tpu_torch.text.byt5 import byt5_encode, byt5_small_config

    t0 = time.perf_counter()
    extra = init_slp_params(cfg, seed=1)
    p_cpu = dataclasses.replace(params_cpu, **extra)
    p_gpu = dataclasses.replace(params, **{
        k: tree_map(lambda t: t.cuda(), v) for k, v in extra.items()})
    log(f"  ByT5-small and SLP parameters (numpy seed 1): "
        f"{time.perf_counter() - t0:.1f} s")
    scfg = cfg.replace(audio=cfg.audio.replace(max_audio_seconds=10.0))
    max_frames = min(scfg.audio.max_latent_frames, scfg.dit.max_token_length)
    dev = torch.device("cuda")
    inputs = slp_inputs(torch, np, 21)
    serve = build_synthesize_with_slp(scfg)
    out = {}

    kernels.reset_launches()
    times, wavs = [], []
    for i, seed in enumerate((7, 7, 8)):   # warm-up, then two timed requests
        with PlainAttentionLog() if i == 0 else contextlib.nullcontext() \
                as plain:
            (wav, frames), dt = sync_time(
                torch, serve, p_gpu, *inputs,
                torch.Generator(device=dev).manual_seed(seed))
        if i == 0:
            plain_log = plain
        check_wave(torch, wav, f"SLP chain seed {seed}")
        times.append(dt)
        wavs.append(wav)
    launches = dict(kernels.launches)
    frames = frames.tolist()
    log(f"  10 s prompts B=4, {max_frames}-frame buffer: waveform "
        f"{tuple(wavs[0].shape)}, warm-up {times[0]:.3f} s, requests "
        f"{[round(t, 4) for t in times[1:]]} s; predicted frames {frames}; "
        f"launches over 3 requests {launches}")
    log(f"  matmul-softmax attention in one request: {plain_log.counts}")
    for key, n in sorted(plain_log.shapes.items()):
        log(f"    {n:4d} x {key}")
    if not whole_mel_frames(wavs[0], 4, max_frames, scfg):
        fail(f"SLP chain: waveform shape {tuple(wavs[0].shape)}")
    if not torch.equal(wavs[0], wavs[1]):
        fail("SLP chain: the same seed gave a different waveform")
    if torch.equal(wavs[0], wavs[2]):
        fail("SLP chain: different seeds gave the same waveform")
    if not all(750 <= f <= 1500 and f % 75 == 0 for f in frames):
        fail(f"SLP chain: frames {frames} are not 10-20 s at 75 a second")
    check_launches("SLP chain", launches, DEFAULT_PATH, 3)
    if plain_log.counts != SLP_PLAIN_ATTENTION:
        fail(f"SLP chain: matmul-softmax attention calls {plain_log.counts},"
             f" expected {SLP_PLAIN_ATTENTION}")
    out["10s"] = {"batch": 4, "max_frames": max_frames,
                  "warmup_s": times[0], "request_s": times[1:],
                  "frames": frames, "launches_3_requests": launches,
                  "plain_attention_per_request": plain_log.counts,
                  "plain_attention_shapes": plain_log.shapes,
                  "waveform_shape": list(wavs[0].shape)}

    # the stages of one request (host clock, synchronized), and the SLP
    # stage's two encoders alone
    st = build_slp_stage_fns(scfg)
    stages = {}
    audio, mask, text, bids, bmask = inputs
    with torch.inference_mode():
        g = torch.Generator(device=dev).manual_seed(7)
        (_, fr), stages["slp"] = sync_time(torch, st["slp"], p_gpu, audio,
                                           mask, bids, bmask)
        ref, stages["sampler"] = sync_time(torch, st["sampler"], p_gpu, text,
                                           fr, g)
        wav_s, stages["tail"] = sync_time(torch, st["tail"], p_gpu, ref)
        _, stages["slp: codec encode"] = sync_time(
            torch, codec_encode, p_gpu.codec, scfg.codec, audio, mask)
        _, stages["slp: byt5 encode"] = sync_time(
            torch, byt5_encode, p_gpu.byt5, byt5_small_config(), bids, bmask)
    log("  10 s stages (s): " + ", ".join(f"{k} {v:.4f}"
                                         for k, v in stages.items()))
    if not torch.equal(wav_s, wavs[0]):
        fail("SLP chain: the stage functions disagree with the serving path")
    out["10s"]["stages_s"] = stages

    # one request at the default AudioConfig: a 1024-frame buffer
    serve_full = build_synthesize_with_slp(cfg)
    full_frames = min(cfg.audio.max_latent_frames, cfg.dit.max_token_length)
    kernels.reset_launches()
    (wav, fr), dt = sync_time(torch, serve_full, p_gpu, *inputs,
                              torch.Generator(device=dev).manual_seed(7))
    launches_full = dict(kernels.launches)
    check_wave(torch, wav, "SLP chain, default AudioConfig")
    log(f"  default AudioConfig, {full_frames}-frame buffer, B=4: waveform "
        f"{tuple(wav.shape)}, {dt:.3f} s (first request at this shape), "
        f"frames {fr.tolist()}, launches {launches_full}")
    if not whole_mel_frames(wav, 4, full_frames, cfg):
        fail(f"SLP chain, default AudioConfig: waveform {tuple(wav.shape)}")
    check_launches("SLP chain, default AudioConfig", launches_full,
                   DEFAULT_PATH, 1)
    out["default_audio"] = {"max_frames": full_frames, "request_s": [dt],
                            "frames": fr.tolist(),
                            "launches": launches_full}

    # SLP logits and frames, card against CPU, fp32, each utterance at B=1
    cmp = []
    t0 = time.perf_counter()
    with torch.inference_mode():
        for i in range(4):
            one = [a[i:i + 1] for a in (audio, mask, bids, bmask)]
            lg, fg = st["slp"](p_gpu, *one)
            lc, fc = st["slp"](p_cpu, *[a.cpu() for a in one])
            err = (lg.cpu() - lc).abs().max().item()
            top2 = lc[0].topk(2).values
            cmp.append({"max_abs_err": err,
                        "max_abs_logit": lc.abs().max().item(),
                        "top2_gap": (top2[0] - top2[1]).item(),
                        "frames_card": fg.item(), "frames_cpu": fc.item()})
    bad = []
    for i, c in enumerate(cmp):
        tol = 1e-4 * max(c["max_abs_logit"], 1.0)
        tie = c["top2_gap"] <= tol
        log(f"  utterance {i}: logits card vs CPU max|err| {c['max_abs_err']:.3e}"
            f" (tol {tol:.1e}), frames {c['frames_card']} / {c['frames_cpu']}"
            f", top-2 gap {c['top2_gap']:.3e}"
            + (" (a near tie: the frames may differ)" if tie else ""))
        if not c["max_abs_err"] <= tol:
            bad.append(f"utterance {i} logits differ by {c['max_abs_err']}")
        if c["frames_card"] != c["frames_cpu"] and not tie:
            bad.append(f"utterance {i} frames {c['frames_card']} vs "
                       f"{c['frames_cpu']}")
    log(f"  card vs CPU: {time.perf_counter() - t0:.1f} s")
    if bad:
        fail("SLP card vs CPU: " + "; ".join(bad))
    out["card_vs_cpu"] = cmp
    out["frame_mask"] = frame_mask_check(torch, np, cfg, p_gpu, p_cpu)
    rec["slp"] = out
    return serve, p_gpu, inputs


# --------------------------------------------------------------------------
# phase 9: DDIM
# --------------------------------------------------------------------------

def ddim_phase(torch, np, cfg, params, params_cpu, inputs, slp, rec):
    from ditto_tts_tpu_torch import kernels
    from ditto_tts_tpu_torch.diffusion.sampler import (ddim_sample,
                                                       respaced_timesteps)
    from ditto_tts_tpu_torch.diffusion.schedule import NoiseSchedule
    from ditto_tts_tpu_torch.infer.generator import (
        build_stage_fns, build_synthesize, build_synthesize_pipelined)
    from ditto_tts_tpu_torch.models import dit as dit_mod

    serve = build_synthesize_pipelined(cfg, sampler_kind="ddim")
    dev = torch.device("cuda")
    out = {}
    kernels.reset_launches()
    times, wavs = [], []
    for seed in (7, 7, 8):                  # warm-up, then two timed requests
        wav, dt = sync_time(torch, serve, params, *inputs,
                            torch.Generator(device=dev).manual_seed(seed))
        check_wave(torch, wav, f"DDIM seed {seed}")
        times.append(dt)
        wavs.append(wav)
    launches = dict(kernels.launches)
    log(f"  10 s bucket B=4: warm-up {times[0]:.3f} s, requests "
        f"{[round(t, 4) for t in times[1:]]} s; launches over 3 requests "
        f"{launches}")
    if not torch.equal(wavs[0], wavs[1]):
        fail("DDIM: the same seed gave a different waveform")
    if torch.equal(wavs[0], wavs[2]):
        fail("DDIM: different seeds gave the same waveform")
    check_launches("DDIM serving path", launches, DEFAULT_PATH, 3)
    one = build_synthesize(cfg, sampler_kind="ddim")(
        params, *inputs, torch.Generator(device=dev).manual_seed(7))
    if not torch.equal(one, wavs[0]):
        fail("DDIM: build_synthesize and build_synthesize_pipelined differ")
    log("  build_synthesize equals build_synthesize_pipelined bit for bit")
    out["10s"] = {"batch": 4, "warmup_s": times[0], "request_s": times[1:],
                  "launches_3_requests": launches}

    # stages: the sampler stage is DDPM (as in JAX), so DDIM's sampler is
    # refine_indices less encode
    st = build_stage_fns(cfg, sampler_kind="ddim")
    stages = {}
    audio, mask, text = inputs
    with torch.inference_mode():
        _, stages["encode"] = sync_time(torch, st["encode"], params, audio,
                                        mask)
        idx, stages["refine_indices"] = sync_time(
            torch, st["refine_indices"], params, audio, mask, text,
            torch.Generator(device=dev).manual_seed(7))
        _, stages["indices_to_waveform"] = sync_time(
            torch, st["indices_to_waveform"], params, idx, audio.shape[-1])
    log("  10 s stages, DDIM (s): " + ", ".join(f"{k} {v:.4f}"
                                               for k, v in stages.items()))
    out["10s"]["stages_s"] = stages

    # ddim_sample at eta = 0, full-width DiT, fp32, 1 s / B=1: card vs CPU
    pdit = cfg.dit.replace(compute_dtype="float32")
    sched = NoiseSchedule.cosine(pdit.diffusion_steps)
    taus = respaced_timesteps(pdit.diffusion_steps, cfg.sampler.num_steps)
    rng = np.random.default_rng(31)
    frames = -(-24000 // cfg.codec.hop_length)
    x_np = rng.standard_normal((1, frames, pdit.hidden_dim)).astype(
        np.float32)
    ids = torch.from_numpy(rng.integers(0, 50257, (1, 64)))

    def run(p, device):
        with torch.inference_mode():
            te = p.gpt2["wte"]["weight"][ids.to(device)]
            prep = dit_mod.prepare(p.dit, pdit, te, frames)
            return ddim_sample(
                lambda x, t: dit_mod.ditto_forward(p.dit, pdit, x, te, t,
                                                   prepared=prep),
                torch.from_numpy(x_np).to(device), sched, taus, eta=0.0,
                generator=torch.Generator(device=device).manual_seed(0))

    t0 = time.perf_counter()
    got = run(params, "cuda").cpu()
    want = run(params_cpu, "cpu")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    log(f"  ddim_sample eta=0, 1 s B=1 fp32: card vs CPU max|err| {err:.3e} "
        f"(scale {scale:.3e}, tol {LATENT_TOL} x scale), "
        f"{time.perf_counter() - t0:.1f} s")
    if not (torch.isfinite(want).all() and err <= LATENT_TOL * scale):
        fail(f"DDIM card vs CPU: refined latents differ by {err} (scale "
             f"{scale})")
    out["card_vs_cpu"] = {"max_abs_err": err, "max_abs": scale}

    # the three paths' requests in turns (default, SLP, DDIM, and back)
    slp_serve, slp_params, slp_in = slp
    default = build_synthesize_pipelined(cfg)
    serves = {"default": lambda g: default(params, *inputs, g),
              "slp": lambda g: slp_serve(slp_params, *slp_in, g),
              "ddim": lambda g: serve(params, *inputs, g)}
    turns = {k: [] for k in serves}
    for name in ("default", "slp", "ddim", "ddim", "slp", "default"):
        turns[name].append(sync_time(
            torch, serves[name],
            torch.Generator(device=dev).manual_seed(7))[1])
    log("  10 s B=4 requests in turns (s): " + "; ".join(
        f"{k} {[round(v, 4) for v in vs]}" for k, vs in turns.items()))
    out["request_in_turns_s"] = turns
    rec["ddim"] = out


# --------------------------------------------------------------------------

def main() -> None:
    if not (ROOT / "ditto_tts_tpu_torch" / "__init__.py").exists():
        fail("run from the root of a checkout: ditto_tts_tpu_torch/ is "
             "missing")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    count = torch.cuda.device_count()
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 is compared
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    t_start = time.perf_counter()
    rec = {}

    from ditto_tts_tpu_torch import kernels
    from ditto_tts_tpu_torch.config import serving_config
    from ditto_tts_tpu_torch.params import init_generator_params

    log("== 1. device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    log(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{count} device(s)")
    rec["card"] = card
    rec["torch"] = torch.__version__

    log("== 2. build")
    build_s = kernels.build()
    log(f"  nvcc build of {', '.join(kernels.KERNELS)}: {build_s:.2f} s")
    rec["ptxas"], rec["sass_mma"] = {}, {}
    for name in kernels.KERNELS:
        rec["ptxas"][name] = kernels.ptxas_report(name)
        mma = rec["sass_mma"][name] = kernels.sass_mma_counts(name)
        for fn, regs, st, ld in rec["ptxas"][name]:
            n_mma = "n/a" if mma is None else mma.get(fn, "?")
            log(f"  [{name}] {fn[:110]}: {regs} registers, spill stores "
                f"{st} B, spill loads {ld} B, HMMA/HGMMA in SASS {n_mma}")
    # A, B and C: the bf16 kernels (*_tc) run on the tensor cores, the fp32
    # ones (exact fp32, TF32 would break the fp32 tolerance) and the weight
    # reorder do not; D (an elementwise filter) has none
    for name in kernels.KERNELS:
        mma = rec["sass_mma"][name]
        if mma is None:
            fail(f"{name}: no cuobjdump beside nvcc, so the tensor-core "
                 "instructions of the bf16 kernels cannot be checked")
        tc = {fn: n for fn, n in mma.items() if "kernel_tc" in fn}
        if (name == "snake") != (not tc) or not all(tc.values()) or any(
                n for fn, n in mma.items() if fn not in tc):
            fail(f"{name}: tensor-core instructions in the wrong kernels: "
                 f"{mma}")
    rec["build_s"] = build_s

    log("== 3. kernel parity on the card (tolerance: max|err| <= tol x "
        "max|plain|)")
    entries = kernel_phase(torch, rec)

    log("== 4. serving (full width, random weights from numpy seed 0)")
    cfg = serving_config()
    t0 = time.perf_counter()
    params_cpu = init_generator_params(cfg, seed=0)
    params = params_cpu.to("cuda")
    log(f"  parameters: {time.perf_counter() - t0:.1f} s")
    launches, inputs, mel = serving_phase(torch, np, cfg, params, rec)

    log("== 5. chain parity, card vs CPU (fp32, TF32 off)")
    parity_phase(torch, np, cfg, params_cpu, params, rec)

    log('== 6. aa_impl="fused_pallas": serving, vocoder stage, card vs CPU')
    launches_fp = fused_pallas_phase(torch, cfg, params, params_cpu, inputs,
                                     mel, rec)

    log('== 7. aa_impl="fused_ncl" on BigVGAN\'s last two stages')
    fused_ncl_phase(torch, np, cfg, params, rec)

    log("== 8. the SLP-driven chain (ByT5-small, SLP, DiT, codec, BigVGAN)")
    slp = slp_phase(torch, np, cfg, params, params_cpu, rec)

    log("== 9. DDIM (eta 0): serving, build_synthesize, card vs CPU")
    ddim_phase(torch, np, cfg, params, params_cpu, inputs, slp, rec)

    # launches per 10 s request (fused_ncl: per forward of its two stages)
    paths = {"default": DEFAULT_PATH, "fused_pallas": FUSED_PALLAS_PATH,
             "fused_ncl": FUSED_NCL_PATH, "slp": DEFAULT_PATH,
             "ddim": DEFAULT_PATH}
    sources = {
        "attention": "ditto_tts_tpu/ops/attention.py:95 pallas_attention "
                     "(#1) + :173 pallas_attention_packed (#2)",
        "conv1d": "ditto_tts_tpu/ops/conv_pallas.py:74 conv1d_nlc_pallas "
                  "(#3) + :289 conv1d_ncl_pallas (#5) + :191 "
                  "conv1d_ncl_batched_pallas (#4, no caller on a path)",
        "act_conv": "ditto_tts_tpu/ops/act_conv_pallas.py:135 "
                    "aa_snake_conv1d (#6) + :303 aa_snake_conv1d_ncl (#7)",
        "snake": "ditto_tts_tpu/ops/snake_pallas.py:109 fused_snake_pallas "
                 "(#8) + ditto_tts_tpu/ops/snake_pallas_nlc.py:80 "
                 "fused_snake_nlc (#9)"}
    # each kernel's count from the run of the path that carries it: the
    # default serving phase (5 requests) for A, B, C; phase 6 (3 requests)
    # for D
    counted = dict(launches, snake=launches_fp["snake"])
    line = {"kernels": [dict(
        name=name, route="cuda",
        source=f"ditto_tts_tpu_torch/csrc/{name}.cu",
        replaces=sources[name] + "; launches per request: " + ", ".join(
            f"{p} {paths[p][name]}" for p in paths),
        launches=counted[name],
        launches_per_request={p: paths[p][name] for p in paths},
        **{k: entries[name][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape")}) for name in kernels.KERNELS]}
    rec["kernels"] = line["kernels"]
    rec["total_s"] = time.perf_counter() - t_start
    if os.environ.get("DITTO_RECORD_DIR"):
        out_dir = Path(os.environ["DITTO_RECORD_DIR"])
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "chip_smoke.json").write_text(json.dumps(rec, indent=1))
    log(f"== done in {rec['total_s']:.1f} s")
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
