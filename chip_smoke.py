#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's DiTTo serving chain on one NVIDIA H100.

    python3 chip_smoke.py        (from the root of a checkout; one CUDA card)

Phases (any failure exits non-zero and prints no result line):
  1. device   the card's name and power limit (nvidia-smi), torch / CUDA
  2. build    nvcc builds kernels A, B, C from ditto_tts_tpu_torch/csrc/
  3. kernels  each kernel against its plain PyTorch version at the serving
              path's shapes, bf16 and fp32, with the stated tolerance;
              kernel / plain / library times (CUDA events) and the bound
  4. serving  the full-width chain of bench.py (12-layer 768-wide DiT,
              50 DDPM steps, EnCodec 1.5 kbps, BigVGAN v2 24 kHz) through
              build_synthesize_pipelined: the 10 s bucket at B=4 (warm-up,
              three timed requests with different seeds, a repeat of one
              seed that must be bitwise equal) and the 20 s bucket at B=4;
              launch counts of every kernel are read over this phase
  5. parity   full width, 1 s prompt, B=1, fp32 with TF32 off, all 50
              steps (respaced to 4 steps, the first step's beta rounds to
              1.0 in fp32 and the update divides by zero, in JAX too):
              build_synthesize_recorded with the same numpy noise on the
              card and on the CPU (plain versions); refined latents, VQ
              index agreement, and the CPU's indices decoded on the card
  6. a {"kernels": [...]} line, then the card line, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Weights are random (numpy seed 0, init_generator_params); nothing is
downloaded. With DITTO_RECORD_DIR set, a JSON record of every number goes
to $DITTO_RECORD_DIR/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BF16 = 989e12        # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_FP32 = 67e12         # H100 SXM fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bytes/s
TOL = {"float32": 2e-5, "bfloat16": 1e-2}   # max |err| / max |plain|


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def cuda_ms(fn, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    import torch
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


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
    from ditto_tts_tpu_torch.ops.attention import (attention_cuda,
                                                   attention_plain)
    from ditto_tts_tpu_torch.ops.conv import conv1d_cuda, conv1d_plain

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(1234)
    checks = Checks()
    entries = {}

    def rn(*shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen,
                                    device=dev)).to(dtype)

    dtypes = (torch.bfloat16, torch.float32)

    # ---- A: attention (self at the 10 s / 20 s latent lengths, cross) ----
    for dt in dtypes:
        dn = str(dt).split(".")[1]
        for sq, sk in ((750, 750), (1024, 1024), (750, 64), (1024, 64)):
            q, k, v = (rn(4, 12, s, 64, dtype=dt) for s in (sq, sk, sk))
            got = attention_cuda(q, k, v)
            want = attention_plain(q, k, v)
            err = checks.compare("attention", f"{dn} B4 H12 Sq{sq} Sk{sk} "
                                 "D64", got, want, dn)
            if dt == torch.bfloat16 and (sq, sk) == (750, 750):
                flops = 4.0 * 4 * 12 * sq * sk * 64
                b, by = bound_ms(flops, nbytes(q, k, v, got), dt)
                entries["attention"] = {
                    "shape": "bf16 B=4 H=12 Sq=Sk=750 D=64 (10 s self)",
                    "max_abs_err": err,
                    "ms": cuda_ms(lambda: attention_cuda(q, k, v), 50),
                    "plain_ms": cuda_ms(lambda: attention_plain(q, k, v), 10),
                    "library_ms": cuda_ms(
                        lambda: F.scaled_dot_product_attention(q, k, v), 50),
                    "bound_ms": b, "bound_by": by}

    # ---- B: conv1d at SEANet and vocoder shapes ----
    conv_cases = [   # (label, B, C, T_out, O, K, dil, dtype)
        ("SEANet resblock 32->16 k3", 4, 32, 240000, 16, 3, 1, torch.float32),
        ("SEANet final 32->1 k7", 4, 32, 240000, 1, 7, 1, torch.float32),
        ("vocoder conv_pre 100->1536 k7", 4, 100, 938, 1536, 7, 1,
         torch.bfloat16),
        ("vocoder 768 k11 d5", 4, 768, 3752, 768, 11, 5, torch.bfloat16),
        ("vocoder 384 k11 d5", 4, 384, 15008, 384, 11, 5, torch.bfloat16),
        ("vocoder 24 k11 d5", 4, 24, 240128, 24, 11, 5, torch.bfloat16),
        ("vocoder upsample poly 96->2x48 k2", 4, 96, 60033, 96, 2, 1,
         torch.bfloat16),
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
            if label.startswith("vocoder 768") and dt == torch.bfloat16:
                flops = 2.0 * b_ * o * c * k * t_out
                bb, by = bound_ms(flops, nbytes(x, w, bias, got), dt)
                entries["conv1d"] = {
                    "shape": f"bf16 B=4 C=O=768 K=11 dil=5 T={t_out} "
                             "(vocoder stage 0)",
                    "max_abs_err": err,
                    "ms": cuda_ms(lambda: conv1d_cuda(x, w, bias,
                                                      dilation=dil), 10),
                    "plain_ms": cuda_ms(lambda: conv1d_plain(
                        x, w, bias, dilation=dil), 3),
                    "library_ms": cuda_ms(lambda: F.conv1d(
                        x, w, bias.to(dt), dilation=dil), 10),
                    "bound_ms": bb, "bound_by": by}

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
                    if (c, k, dil, dt) == (384, 11, 5, torch.bfloat16):
                        flops = 2.0 * 4 * c * c * k * t + 56.0 * 4 * c * t
                        bb, by = bound_ms(flops, nbytes(x, w, bias, a, inv_b,
                                                        got), dt)
                        entries["act_conv"] = {
                            "shape": f"bf16 B=4 C=O=384 K=11 dil=5 T={t} "
                                     "(vocoder stage 1)",
                            "max_abs_err": err,
                            "ms": cuda_ms(lambda: aa_snake_conv1d_cuda(
                                x, a, inv_b, w, bias, dilation=dil), 10),
                            "plain_ms": cuda_ms(lambda: aa_snake_conv1d_plain(
                                x, a, inv_b, w, bias, dilation=dil), 3),
                            "library_ms": None,
                            "bound_ms": bb, "bound_by": by}
    if checks.bad:
        fail("kernel parity: " + "; ".join(checks.bad))
    for name, e in entries.items():
        lib = "n/a" if e["library_ms"] is None else f"{e['library_ms']:.4f}"
        log(f"  {name} at {e['shape']}: kernel {e['ms']:.4f} ms, plain "
            f"{e['plain_ms']:.4f} ms, library {lib} ms, bound "
            f"{e['bound_ms']:.4f} ms ({e['bound_by']})")
    rec["kernel_entries"] = entries
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
    wav0, warm = run(inputs, 7)
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
    log(f"  launches over the serving phase: {launches}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"serving: kernels never launched on the main path: {missing}")

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
        f"(scale {ref_scale:.3e}); VQ index agreement {agree:.4f}; "
        f"waveform from the CPU's indices max|err| {wav_err:.3e}")
    rec["parity"] = res
    if not (lat_err <= 1e-4 * max(ci["latents"].abs().max().item(), 1.0)):
        fail(f"parity: encoder latents differ by {lat_err}")
    if not ref_err <= 1e-3 * ref_scale:
        fail(f"parity: refined latents differ by {ref_err} (scale "
             f"{ref_scale})")
    if not agree >= 0.99:
        fail(f"parity: VQ index agreement {agree} < 0.99")
    if not wav_err <= 1e-3:
        fail(f"parity: waveform from the CPU's indices differs by {wav_err}")


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
    for name, text in kernels.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  [{name}] {line.strip()}")
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
    launches = serving_phase(torch, np, cfg, params, rec)

    log("== 5. chain parity, card vs CPU (fp32, TF32 off)")
    parity_phase(torch, np, cfg, params_cpu, params, rec)

    sources = {"attention": "ditto_tts_tpu/ops/attention.py:95 "
                            "pallas_attention + :173 pallas_attention_packed",
               "conv1d": "ditto_tts_tpu/ops/conv_pallas.py:74 "
                         "conv1d_nlc_pallas + :289 conv1d_ncl_pallas",
               "act_conv": "ditto_tts_tpu/ops/act_conv_pallas.py:135 "
                           "aa_snake_conv1d"}
    line = {"kernels": [dict(
        name=name, route="cuda",
        source=f"ditto_tts_tpu_torch/csrc/{name}.cu",
        replaces=sources[name], launches=launches[name],
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
