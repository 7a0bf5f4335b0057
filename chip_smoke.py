#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's DiTTo serving chain, its training path
(the DiTTo, NAC and SLP steps, the data layer and the training CLIs), its
synthesis and evaluation CLIs and its data- and tensor-parallel training
on one NVIDIA H100.

    python3 chip_smoke.py        (from the root of a checkout; one CUDA card)

Phases (any failure exits non-zero and prints no result line):
  1. device   the card's name and power limit (nvidia-smi), torch / CUDA
  2. build    nvcc builds kernels A-E from ditto_tts_tpu_torch/csrc/
              (one nvcc per source, all at once); each kernel's registers
              and spills (ptxas) and tensor-core instructions (cuobjdump
              -sass, which the toolkit must have), which must be in every
              bf16 kernel of A, B and C (*_kernel_tc) and in none of their
              fp32 kernels, the weight reorder, D or E
  3. kernels  each kernel against its plain PyTorch version at the paths'
              shapes, bf16 and fp32, with the stated tolerance (A at the
              DiT's four shapes; B at every bf16 shape class of the vocoder
              (kernel_bench.CONV_SHAPES), the SEANet shapes, and as the
              whole-batch conv #4 and its B=1 gate; C, also with the
              residual epilogue at widths 48 / 24; D in its two Pallas
              modes, on [B, C, T] and [B, T, C], with a ragged T and
              T < 8, and in its polyphase mode, sin2 and sinf, at the
              default path's 768-, 48- and 24-wide stages and at T of 1-17;
              E's three modes at ditto-base's and ditto-ref's widths; A's
              prefill, decode and NAR launches at VALL-E's shapes, then
              one full-size VALL-E request with its launches exact,
              untimed);
              kernel and library times (device ms of a replayed CUDA
              graph), the plain version's, and the bound
  4. serving  the full-width chain of bench.py (12-layer 768-wide DiT,
              50 DDPM steps, EnCodec 1.5 kbps, BigVGAN v2 24 kHz) through
              build_synthesize_pipelined: the 10 s bucket at B=4 (warm-up,
              three timed requests with different seeds, a repeat of one
              seed that must be bitwise equal) and the 20 s bucket at B=4;
              launches of every kernel, read over this phase, must be
              exactly those of the default path (per request A 1200, B 90,
              C 54, D 55, E 3650); the shapes of A's and B's calls in the untimed
              warm-up request
  5. parity   full width, 1 s prompt, B=1, fp32 with TF32 off, all 50
              steps (respaced to 4 steps, the first step's beta rounds to
              1.0 in fp32 and the update divides by zero, in JAX too):
              build_synthesize_recorded with the same numpy noise on the
              card and on the CPU (plain versions); refined latents
              (max|err| <= LATENT_TOL x max|CPU|), VQ index agreement, and
              the CPU's indices decoded on the card
  6. the vocoder under aa_impl="fused_pallas": the 10 s bucket at B=4
     (warm-up and two timed requests; per request D 109, C 0; the shapes of
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
     the default path's launches (A 1200, B 90, C 54, D 55) and 2
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
 10. DiTTo training at full width (build_ditto_train_step: the 12-layer
     768-wide DiT with bf16 blocks, remat, output-mode cross-attention
     dropout 0.1, flat AdamW at lr 1e-4; B=8 of the 10 s bucket, 1024 GPT2
     ids cut to 750): a latent leg, then an audio leg (the fp32 frozen
     encode through kernel B), each a warm-up and 5 timed synchronized steps
     (step s, audio-s/s, peak memory, finite losses) with exact launches
     per step (A 48: 24 in the forward, 24 in the remat recompute, none in
     the backward; B 14 in the audio leg's encode; C, D 0), A 24 in a
     step without remat and in eval_fn; kernel A's output and gradient
     against its plain version and autograd through it (self and cross at
     B8 H12 S750,
     causal at S1024, bf16 and fp32); one fp32 step card vs CPU (1 s clip,
     B=1, dropout 0, the same t and noise: loss, mu, nu, params); two
     steps from one state and seed bitwise equal; remat against none at 2
     layers, fp32, dropout on; a checkpoint of a 2-layer train state
     (CKPT_LAYERS: the 12-layer one's deflate took 73-83 s) saved,
     restored and stepped bitwise equal; Trainer.fit (1 layer, 2
     epochs x 2 steps) writes its files and resumes from epoch 2
 11. NAC and SLP training and the training path from a corpus: the NAC
     step (build_nac_train_step: GPT2-small 12 x 768 from phase 4, EnCodec
     1.5 kbps, the straight-through VQ, flat AdamW lr 1e-4; B=4 of the 10 s
     bucket, 1024 GPT2 ids cut to 750) and the SLP step (ByT5-small from
     phase 8, the SLP's one layer with one 1472-wide head; B=8, 128 byte
     ids), each a warm-up and 5 timed synchronized steps (step s,
     audio-s/s, peak memory, finite metrics) with exact launches a step
     (NAC: B 28, the encode's and the decode's; SLP: B 14; A, C, D 0) and
     matmul-softmax calls (NAC: GPT2's 12; SLP: 2 + 12); a ref_compat NAC
     step without VQ losses (GPT2's padding bias runs in both: a row's
     ids padded inside the cut); one fp32 step of each card vs CPU (1 s
     clip, B=1; index agreement, the CPU's indices on the card where one
     flipped; the parameters farthest apart located, with their gradients
     and nu on both devices) and two steps from one state bitwise equal;
     a synthetic MLS
     corpus (10 s and ~12 s WAV clips, and Ogg-Opus ones where libopus
     loads) through MLSDataset, batches and batches_native (the same
     items), the decoder that served each clip, the latent cache
     (precompute on the card in bf16, each cached batch bitwise equal to a
     direct encode of its members at the same size; against B=1 encodes,
     the frames that agree and max|err|; each shape of kernel B in those
     bf16 encodes held against conv1d_plain); then train_nac, train_slp and
     train_ditto (--latent-cache, --nac-checkpoint, --layers 1) as
     subprocesses on the card, and train_ditto --epochs 2, which resumes
 12. synthesize and evaluate: the synthesize CLI twin as a subprocess
     twice (a 10 s prompt WAV; phase 4's BigVGAN as a .pth under
     BigVGAN's names, its DiT and NAC trees as .npz checkpoints; 50 DDPM
     steps): a 24 kHz mono int16 WAV of the prompt cut to whole mel hops
     (finite: the CLI refuses a non-finite waveform), the second bitwise
     equal, the imported BigVGAN tree equal to the
     written one leaf for leaf; the evaluate CLI twin as a subprocess (phase
     11's 4-clip WAV corpus, B=2, 2 batches, 50 DDPM steps, s2t-medium and
     ECAPA random, --smoke-ortho --oracle-ref): every JSON key, finite,
     CER and WER >= 0, SIM-o and SIM-r in [-1, 1]; the CLI's batches in
     this process through its own evaluate_batch, twice: first with the
     first call of kernels A, B, C and D at each shape and type held to its
     plain version (fp32 DiT and codec, bf16 vocoder, at the 10 s and
     12.5 s buckets), then timed; in both, exact launches per evaluated
     batch (A 1200; B 236: the synthesis 90, the oracle render 90, two
     codec round trips for SIM-r 28 each; C 108; D 110) and 4 decodes of
     2388 matmul-softmax calls (12 + 198 x 6 x 2, no kernel launch);
     per-utterance synthesis, oracle render, ASR, ECAPA, codec and
     mel_mae times; S2T-medium encode, decode_logits and greedy_decode
     (max_len 200) card vs CPU, on its random tree (whose ids repeat the
     forced BOS) and with its token embeddings scaled by 0.2 (whose ids
     change), logits within 1e-4 of max|CPU| and ids equal under the
     margin rule; ECAPA with and without a mask within 1e-4 of max|CPU|;
     mel_mae within 1e-5
 13. parallel training: kernel A at a tensor-parallel rank's share of the
     heads (bf16 and fp32 B8 H6 S750 D64) and at a 16-wide head (padded
     to 64) held to its plain version; two ranks under gloo on the one
     card (NCCL refuses two ranks on one GPU; torch.distributed.run of
     ``chip_smoke.py --mesh-rank``) form the (data 1, model 2) and then the
     (2, 1) mesh and take one fp32 DiTTo step at phase 10's width (12 x
     768, 12 heads, B=8 of the 10 s bucket, the in-step encode, remat,
     dropout 0.1, the global t, noise and masks from one seed), each held
     on rank 0 to the same step in one process on the card (loss, mu, nu,
     params; MESH_TOL), with exact launches per rank per step (A 48, B
     14); under (1, 2) also phase 10's bf16 production step, 3 timed steps
     per rank (gloo on one card: the collectives go through the host), and
     a collective checkpoint of a one-layer state read back into one
     process; train_ditto under torch.distributed.run --nproc-per-node 2
     --mesh-model 2 --dist-backend gloo (one layer, B=2, phase 11's WAV
     corpus), then resumed to a second epoch, its file loaded into one
     process; NCCL at world size 1 (init, an all-reduce on the card,
     teardown); the eval_discrimination twin at EVAL_DISC_ARGS, which
     writes its report
 14. F5-TTS v1 Base at its published widths (22 x 1024, 16 heads of 64,
     32 guided Euler steps over 2B rows, BigVGAN v2 on the generated
     frames; random weights from numpy seed 0): one request of B=4 10 s
     prompts, 384 ids, 2,343 frames through build_synthesize_pipelined
     with the first call of kernels A, B, C and D at each shape held to its
     plain version (A at bf16 B8 H16 S2343 D64 in the step the capture
     runs eagerly; B and C at the vocoder's 1,406 generated frames), then
     the same seed timed (bitwise equal) and another seed; launches of
     each request exactly F5's (A 704: one a block a step; C 54; D 55;
     B as the held request counted it), and the shapes of A's and B's
     calls in the held request
 15. a {"kernels": [...]} line, then the card line, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Weights are random (numpy seed 0, init_generator_params and
init_dit_train_state); nothing is downloaded. Phases 10-13 write to
.chip_smoke_tmp/ in the checkout and remove it after them. With DITTO_RECORD_DIR set, a JSON record of every number goes
to $DITTO_RECORD_DIR/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import itertools
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


# launches of each kernel per 10 s / B=4 request on each path; D: the
# vocoder's standalone activations (the default path's 18 at each of 768,
# 48 and 24 channels and act_post in the polyphase mode; fused_pallas's
# 108 in the Pallas modes and act_post in the polyphase mode); E: the
# DiT's glue, 6 a block and the first norm, 73 a step of 50
DEFAULT_PATH = {"attention": 1200, "conv1d": 90, "act_conv": 54, "snake": 55,
                "dit_glue": 50 * 73}
FUSED_PALLAS_PATH = {"attention": 1200, "conv1d": 90 + 54, "act_conv": 0,
                     "snake": 109, "dit_glue": 50 * 73}
# BigVGAN's last two stages under aa_impl="fused_ncl", one forward (D:
# act_post)
FUSED_NCL_PATH = {"attention": 0, "conv1d": 4, "act_conv": 36, "snake": 1,
                  "dit_glue": 0}
# launches of kernels A, C and D per F5 request at the published widths
# (22 blocks x 32 guided steps; BigVGAN's act->conv pairs and standalone
# activations); B's count is read from the phase's held request
# one VALL-E request (B=32, 128 phonemes, 3 s prompt, 750 tokens): A in
# the AR prefill and the 7 NAR stages (12 + 84), A's decode launch 12 a
# token, B in the codec's encode and decode
VALLE_PATH = {"attention": 12 + 7 * 12, "kv_decode": 750 * 12,
              "conv1d": 28}
F5_PATH = {"attention": 22 * 32, "act_conv": 54, "snake": 55, "dit_glue": 0}
# matmul-softmax attention per SLP-chain request (no kernel: JAX computes
# it outside Pallas): the decoder's self and cross attention over one
# 1472-wide head, ByT5's biased attention in each of its 12 layers, and
# none of GPT2's (serving reads only its wte)
SLP_PLAIN_ATTENTION = {"decoder": 2, "byt5": 12, "gpt2": 0, "s2t": 0}


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
    """Counts the matmul-softmax attention calls while it is entered, by
    caller and shape: it wraps ``attention_plain`` where the SLP decoder
    (``nn/transformer.py``), ByT5 (``text/byt5.py``), GPT2
    (``text/gpt2.py``) and the S2T ASR (``models/s2t.py``) look it up at
    call time, and restores it after."""

    def __enter__(self):
        from ditto_tts_tpu_torch.models import s2t
        from ditto_tts_tpu_torch.nn import transformer
        from ditto_tts_tpu_torch.text import byt5, gpt2
        self.mods = {"decoder": transformer, "byt5": byt5, "gpt2": gpt2,
                     "s2t": s2t}
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


@contextlib.contextmanager
def held_to_plain(checks, label: str):
    """Within it, the first call of kernels A, B, C and D (its polyphase
    mode) at each shape and type also runs the kernel's plain version on
    the same inputs and passes
    through ``checks.compare``; yields {kernel and shape: max_abs_err}.
    The kernel's result goes on unchanged (the wrappers are looked up at
    call time, as in ``ShapeLog``), and the plain versions count no
    launch. A call inside a CUDA graph capture (the sampler's step,
    ``infer/step_graph.py``) computes nothing and is not held: the
    eager warm-up of a new shape, before its capture, holds it."""
    import torch
    from ditto_tts_tpu_torch.ops import act_conv as C, attention as A, \
        conv as B, snake_fused as D
    saved = (A.attention_cuda, B.conv1d_cuda, C.aa_snake_conv1d_cuda,
             D.polyphase_snake_cuda)
    attn, conv, act, poly = saved
    seen = {}

    def held(key):
        return key in seen or torch.cuda.is_current_stream_capturing()

    def hold(kernel, key, dn, y, plain):
        if not held(f"{kernel} {key}"):
            seen[f"{kernel} {key}"] = checks.compare(
                kernel, f"{label} {key}", y, plain(), dn)
        return y

    def held_attn(q, k, v, *, causal=False, sm_scale=None, kv_len=None):
        kw = dict(causal=causal, sm_scale=sm_scale, kv_len=kv_len)
        dn = str(q.dtype)[6:]
        key = (f"{dn} B{q.shape[0]} H{q.shape[1]} Sq{q.shape[2]} "
               f"Sk{k.shape[2]} D{q.shape[3]} causal={causal} "
               f"kv_len={kv_len}")
        y = attn(q, k, v, **kw)
        if dn == "float32" and not held(f"attention {key}"):
            # how far each side lies from the fp64 math: which of the two
            # fp32 sums the kernel-vs-plain difference comes from
            exact = A.attention_plain(q.double(), k.double(), v.double(),
                                      **kw)
            scale = exact.abs().max().item()
            for side, got in (("kernel", y),
                              ("plain", A.attention_plain(q, k, v, **kw))):
                seen[f"attention {key} {side} vs fp64"] = e = (
                    got.double() - exact).abs().max().item()
                log(f"  attention {label} {key}: {side} vs fp64 max_abs_err"
                    f" {e:.3e} rel {e / scale:.2e}")
        return hold("attention", key, dn, y,
                    lambda: A.attention_plain(q, k, v, **kw))

    def held_conv(x, weight, bias=None, *, dilation=1):
        (b, c, t), (o, _, k) = x.shape, weight.shape
        dn = str(x.dtype)[6:]
        return hold("conv1d", f"{dn} B{b} C{c} O{o} K{k} dil{dilation} "
                    f"T{t - (k - 1) * dilation}", dn,
                    conv(x, weight, bias, dilation=dilation),
                    lambda: B.conv1d_plain(x, weight, bias,
                                           dilation=dilation))

    def held_act(x, a, inv_b, weight, bias=None, *, dilation=1,
                 residual=None, out_dtype=None):
        (b, c, t), (o, _, k) = x.shape, weight.shape
        dn = str(x.dtype)[6:]
        kw = dict(dilation=dilation, residual=residual, out_dtype=out_dtype)
        return hold("act_conv", f"{dn} B{b} C{c} O{o} K{k} dil{dilation} "
                    f"T{t} residual={residual is not None}", dn,
                    act(x, a, inv_b, weight, bias, **kw),
                    lambda: C.aa_snake_conv1d_plain(x, a, inv_b, weight,
                                                    bias, **kw))

    def held_poly(x, a, inv_b, *, fast):
        b, c, t = x.shape
        dn = str(x.dtype)[6:]
        return hold("snake", f"polyphase {dn} B{b} C{c} T{t} fast={fast}",
                    dn, poly(x, a, inv_b, fast=fast),
                    lambda: D.polyphase_snake_plain(x, a, inv_b, fast=fast))

    (A.attention_cuda, B.conv1d_cuda, C.aa_snake_conv1d_cuda,
     D.polyphase_snake_cuda) = held_attn, held_conv, held_act, held_poly
    try:
        yield seen
    finally:
        (A.attention_cuda, B.conv1d_cuda, C.aa_snake_conv1d_cuda,
         D.polyphase_snake_cuda) = saved


def check_launches(path: str, launches: dict, per_request: dict, n: int):
    """Every kernel launched exactly as often as the path runs it (n
    requests): a kernel of the path that never ran fails, and so does one
    that ran where the path has none."""
    want = ran({k: v * n for k, v in per_request.items()})
    if ran(launches) != want:
        fail(f"{path}: launches {launches}, expected {want}")


def ran(launches: dict) -> dict:
    """The kernels a launch count has launched: a kernel counted at 0 is
    left out, so a path's expected counts need not name every kernel."""
    return {k: v for k, v in launches.items() if v}


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
    from ditto_tts_tpu_torch.ops.snake_fused import (
        fused_snake_cuda, fused_snake_plain, polyphase_snake_cuda,
        polyphase_snake_plain)

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

    # ---- D in its polyphase mode (polyphase_anti_aliased_activation with
    # snake_beta): bf16 at the default path's 768-, 48- and 24-wide stages
    # in a 10 s request (timed against the stock ops it replaces), fp32,
    # sinf, plain Snake, T shorter than the edges' reach and one run + 1,
    # and [B, C, T] views an odd number of elements into their storage ----
    p_cases = [(768, 3748), (48, 119936), (24, 239872), (24, 1), (48, 3),
               (768, 17), (40, 1000)]
    for c, t in p_cases:
        for dt in dtypes:
            dn = str(dt).split(".")[1]
            for fast in (True, False):
                for with_beta in (True, False):
                    a, inv_b = snake_coeffs(rn(c, scale=0.3), rn(
                        c, scale=0.3) if with_beta else None)
                    views = ["[B,C,T]"] + (["[B,C,T] at offset 1"]
                                           if t <= 1000 else [])
                    for view in views:
                        if view == "[B,C,T]":
                            x = rn(4, c, t, dtype=dt, scale=2.0)
                        else:
                            x = rn(1 + 4 * c * t, dtype=dt,
                                   scale=2.0)[1:].view(4, c, t)
                        got = polyphase_snake_cuda(x, a, inv_b, fast=fast)
                        want = polyphase_snake_plain(x, a, inv_b, fast=fast)
                        err = checks.compare(
                            "snake", f"polyphase {dn} B4 C{c} T{t} {view} "
                            + ("sin2 " if fast else "sinf ")
                            + ("snakebeta" if with_beta else "snake"), got,
                            want, dn)
                        del want
                        if dt == bf16 and fast and with_beta and t >= 3748:
                            sites[f"polyphase C{c}"] = timed(
                                f"bf16 B=4 C={c} T={t} {view} polyphase",
                                err, lambda: polyphase_snake_cuda(
                                    x, a, inv_b, fast=True),
                                lambda: polyphase_snake_plain(
                                    x, a, inv_b, fast=True),
                                55.0 * x.numel(), nbytes(x, got, a, inv_b),
                                torch.float32)
    entries["snake"] = sites["polyphase C48"]

    # ---- E: the DiT block's glue at ditto-base's widths (bf16, heads of
    # 64) and ditto-ref's (fp32, one head of 768), B=4 x 750 rows ----
    from ditto_tts_tpu_torch.ops import dit_glue as E
    from ditto_tts_tpu_torch.ops.rope import rope_tables
    b, s, h, ff = 4, 750, 768, 3072
    for dt, nh in ((bf16, 12), (torch.float32, 1)):
        dn = str(dt).split(".")[1]
        y, res = rn(b, s, h, dtype=dt), rn(b, s, h, dtype=dt, scale=2.0)
        bias = rn(h, dtype=dt, scale=0.5)
        norm = {"weight": rn(h, scale=0.2).add(1.0).to(dt),
                "bias": rn(h, dtype=dt, scale=0.2)}
        got = E.add_norm_cuda(y, bias, res, norm)
        want = E.add_norm_plain(y, bias, res, norm)
        checks.compare("dit_glue", f"add_norm sum {dn} B{b} S{s} H{h}",
                       got[0], want[0], dn)
        err = checks.compare("dit_glue", f"add_norm norm {dn} B{b} S{s} "
                             f"H{h}", got[1], want[1], dn)
        if dt == bf16:
            entries["dit_glue"] = timed(
                f"bf16 B={b} S={s} H={h} add_norm (sum and norm)", err,
                lambda: E.add_norm_cuda(y, bias, res, norm),
                lambda: E.add_norm_plain(y, bias, res, norm),
                10.0 * b * s * h, nbytes(y, res, *got, bias, *norm.values()),
                dt)
        qkv, qb = rn(b, s, 3 * h, dtype=dt, scale=2.0), rn(3 * h, dtype=dt)
        cos, sin = rope_tables(s, h // nh, dtype=dt, device=dev)
        for part, g, w in zip("qkv", E.qkv_rope_cuda(qkv, qb, nh, cos, sin),
                              E.qkv_rope_plain(qkv, qb, nh, cos, sin)):
            checks.compare("dit_glue", f"qkv_rope {part} {dn} B{b} S{s} "
                           f"H{h} heads {nh}", g, w, dn)
        a, gt = rn(b, s, ff, dtype=dt, scale=3.0), rn(b, s, ff, dtype=dt,
                                                      scale=3.0)
        fb, gb = rn(ff, dtype=dt, scale=0.5), rn(ff, dtype=dt, scale=0.5)
        checks.compare("dit_glue", f"gelu_gate {dn} B{b} S{s} ff{ff}",
                       E.gelu_gate_cuda(a, fb, gt, gb),
                       E.gelu_gate_plain(a, fb, gt, gb), dn)
        del y, res, got, want, qkv, a, gt

    # ---- A at VALL-E's shapes (B=32, H=16, head 64), q, k and v views of
    # the packed projection [B, S, 3, H, 64] as the model passes them, the
    # cache [B, H, 1,102, 64] with random keys past the length, so a key
    # read past it shows: the AR prefill's masked launch (128 text keys
    # seen by every row, 224 prompt frames causal), A's decode launch at
    # the first, average and last steps' lengths, and a NAR stage's
    # unmasked launch over 1,103 positions; then one VALL-E request's
    # launches (untimed) ----
    from ditto_tts_tpu_torch.ops.attention import attention
    kc, vc = (rn(32, 16, 1102, 64, dtype=bf16) for _ in range(2))
    q = rn(32, 352, 3, 16, 64, dtype=bf16)[:, :, 0].transpose(1, 2)
    checks.compare("attention", "bf16 prefix 128 causal B32 H16 Sq352 kv "
                   "352 of 1102 D64",
                   attention(q, kc, vc, causal=True, prefix=128, kv_len=352),
                   attention_plain(q, kc, vc, causal=True, prefix=128,
                                   kv_len=352), "bfloat16")
    q = rn(32, 1, 3, 16, 64, dtype=bf16)[:, :, 0].transpose(1, 2)
    for kvl in (353, 728, 1102):
        lens = torch.full((1,), kvl, dtype=torch.int32, device=dev)
        checks.compare("kv_decode", f"bf16 B32 H16 kv {kvl} of 1102 D64",
                       attention(q, kc, vc, kv_lens=lens),
                       attention_plain(q, kc, vc, kv_lens=lens), "bfloat16")
    del kc, vc
    q, k, v = (t.transpose(1, 2) for t in rn(
        32, 1103, 3, 16, 64, dtype=bf16).unbind(2))
    checks.compare("attention", "bf16 B32 H16 S1103 D64 (NAR)",
                   attention(q, k, v), attention_plain(q, k, v), "bfloat16")
    del q, k, v
    rec["valle_launches"] = valle_request_launches(torch)
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


def valle_request_launches(torch) -> dict:
    """One full-size VALL-E request (``VallePipelineConfig()``, random
    weights) at the cell's shapes, its kernel launches held to
    ``VALLE_PATH`` exactly."""
    from ditto_tts_tpu_torch import kernels
    from ditto_tts_tpu_torch.config import VallePipelineConfig
    from ditto_tts_tpu_torch.infer.generator import build_synthesize_pipelined
    from ditto_tts_tpu_torch.params import ValleParams, init_valle_params, \
        tree_map
    cfg = VallePipelineConfig()
    params = init_valle_params(cfg, 0)
    params = ValleParams(**{f: tree_map(lambda t: t.cuda(), getattr(
        params, f)) for f in ("ar", "nar", "codec")})
    g = torch.Generator().manual_seed(3)
    audio = 0.05 * torch.randn((32, 1, 72000), generator=g)
    text = torch.randint(0, 512, (32, 128), generator=g)
    serve = build_synthesize_pipelined(cfg)
    kernels.reset_launches()
    wav = serve(params, audio, None, text,
                torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    if tuple(wav.shape) != (32, 240000) or not bool(
            torch.isfinite(wav).all()):
        fail(f"VALL-E request: waveform {tuple(wav.shape)}, finite "
             f"{bool(torch.isfinite(wav).all())}")
    check_launches("VALL-E request", launches, VALLE_PATH, 1)
    log(f"  VALL-E request: launches {launches}")
    del params, wav
    torch.cuda.empty_cache()
    return launches


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
        fail(f"fused_pallas: kernel D was not launched "
             f"{FUSED_PALLAS_PATH['snake']} times in one vocoder forward")
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
# phase 10: DiTTo training at full width
# --------------------------------------------------------------------------

# the repo's training setup (scripts/train_bench.py, scripts/train_ditto.py):
# 12 x 768 DiT, bf16 blocks, remat, output-mode cross-attention dropout
# 0.1, flat AdamW at lr 1e-4, weight decay 1e-6; B=8 of the 10 s bucket
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SAMPLES, TRAIN_LR = 12, 8, 240000, 1e-4
TRAIN_TIMED = 5
# reduced depth for the remat comparison, the checkpoint round trip and
# Trainer.fit (checkpoints are compressed .npz, ~16 MB/s to write: the
# 12-layer state's round trip took 73-83 s of the script's time limit)
REMAT_LAYERS, CKPT_LAYERS, FIT_LAYERS = 2, 2, 1


def train_step_launches(dcfg, codec_cfg, audio: bool, *, remat=True) -> dict:
    """Kernel launches of one DiTTo train step: A in every attention of the
    forward (self and cross, each layer) and again in the remat recompute,
    none from the backward; B in the audio leg's frozen encode, once per
    stride-1 SEANet conv (init, final, and each resblock's three)."""
    a = 2 * dcfg.num_layers * (2 if remat else 1)
    b = 2 + 3 * len(codec_cfg.ratios) * codec_cfg.num_residual_layers
    return {"attention": a, "conv1d": b if audio else 0, "act_conv": 0,
            "snake": 0, "dit_glue": 0}


def grad_check_a(torch, checks, label, shape_q, shape_k, causal, dtype, dev,
                 seed):
    """Kernel A's forward output, and dq, dk, dv through its Function
    (kernel forward, stock-op backward), against attention_plain and
    autograd through it, on the card."""
    from ditto_tts_tpu_torch.ops.attention import attention, attention_plain
    gen = torch.Generator(device=dev).manual_seed(seed)
    ops = [torch.randn(s, generator=gen, device=dev).to(dtype)
           for s in (shape_q, shape_k, shape_k)]
    g = torch.randn(shape_q, generator=gen, device=dev).to(dtype)
    a = [t.clone().requires_grad_() for t in ops]
    out_a = attention(*a, causal=causal)
    got = torch.autograd.grad(out_a, a, g)
    p = [t.clone().requires_grad_() for t in ops]
    out_p = attention_plain(*p, causal=causal)
    want = torch.autograd.grad(out_p, p, g)
    dn = str(dtype).split(".")[1]
    errs = {f"out {dn} {label}": checks.compare(
        "attention", f"forward {dn} {label}", out_a.detach(),
        out_p.detach(), dn)}
    errs.update({f"d{n} {dn} {label}": checks.compare(
        "attention", f"grad d{n} {dn} {label}", x, y, dn)
        for n, x, y in zip("qkv", got, want)})
    return errs


def train_phase(torch, np, params, params_cpu, card, rec):
    import shutil
    from ditto_tts_tpu_torch import kernels
    from ditto_tts_tpu_torch.config import CodecConfig, DiTConfig, GPT2Config
    from ditto_tts_tpu_torch.kernel_bench import eager_ms
    from ditto_tts_tpu_torch.models import nac as nac_mod
    from ditto_tts_tpu_torch.ops.attention import attention_backward
    from ditto_tts_tpu_torch.params import (init_dit_train_state, ravel_tree,
                                            tree_map)
    from ditto_tts_tpu_torch.train.checkpoint import (restore_into,
                                                      save_checkpoint)
    from ditto_tts_tpu_torch.train.steps import build_ditto_train_step
    from ditto_tts_tpu_torch.train.trainer import Trainer

    dev = params.dit["proj_in"]["weight"].device
    out = {"card": card}
    dcfg = DiTConfig(num_layers=TRAIN_LAYERS, num_heads=12,
                     remat_blocks=True, compute_dtype="bfloat16")
    ccfg, gcfg = CodecConfig(), GPT2Config()
    frames = TRAIN_SAMPLES // ccfg.hop_length

    def frozen_of(p):
        return {"codec": p.codec, "gpt2": {"wte": p.gpt2["wte"]},
                "embedding_head": p.embedding_head}

    def on(device, tree):
        return tree_map(lambda t: t.to(device), tree)

    frozen = frozen_of(params)
    rng = np.random.default_rng(1)
    text = torch.from_numpy(rng.integers(0, gcfg.vocab_size,
                                         (TRAIN_BATCH, 1024))).to(dev)
    audio = torch.from_numpy(0.05 * rng.standard_normal(
        (TRAIN_BATCH, 1, TRAIN_SAMPLES)).astype(np.float32)).to(dev)
    # the latent leg runs first: each leg's peak memory holds no state of
    # the other (only the audio leg's final state is kept, for the
    # checkpoint)
    legs = {
        "latents": {"latents": torch.from_numpy(rng.standard_normal(
                        (TRAIN_BATCH, frames, dcfg.hidden_dim)).astype(
                        np.float32)).to(dev),
                    "text_ids": text},
        "audio": {"audio": audio,
                  "padding_mask": torch.ones((TRAIN_BATCH, TRAIN_SAMPLES),
                                             dtype=torch.int32, device=dev),
                  "text_ids": text}}
    state0 = init_dit_train_state(dcfg, seed=0)
    n_params = ravel_tree(state0["params"])[0].numel()
    init_state, step_fn, eval_fn = build_ditto_train_step(
        dcfg, ccfg, gcfg, learning_rate=TRAIN_LR)
    log(f"  DiT {dcfg.num_layers} x {dcfg.hidden_dim}, {n_params} parameters, "
        f"bf16 blocks, remat ({dcfg.remat_policy}), {dcfg.attn_dropout_mode}-"
        f"mode dropout {dcfg.cross_attn_dropout}; B={TRAIN_BATCH}, "
        f"{frames} frames, 1024 GPT2 ids cut to {frames}")

    # the encode's kernel B launches, counted on their own
    kernels.reset_launches()
    with torch.no_grad():
        nac_mod.audio_encoder({"embedding_head": params.embedding_head},
                              params.codec, ccfg, audio)
    torch.cuda.synchronize()
    encode_b = kernels.launches["conv1d"]

    # ---- the two legs: warm-up, then timed synchronized steps ----
    for name, batch in legs.items():
        want = train_step_launches(dcfg, ccfg, name == "audio")
        if name == "audio" and encode_b != want["conv1d"]:
            fail(f"train: the encode launched B {encode_b} times, expected "
                 f"{want['conv1d']}")
        gen = torch.Generator(device=dev).manual_seed(1)
        st, m = step_fn(state0, frozen, batch, gen)
        torch.cuda.synchronize()
        losses = [m["loss"].item()]
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        times = []
        for _ in range(TRAIN_TIMED):
            (st, m), dt = sync_time(torch, step_fn, st, frozen, batch, gen)
            times.append(dt)
            losses.append(m["loss"].item())
        launches = dict(kernels.launches)
        peak = torch.cuda.max_memory_allocated()
        step_s = sorted(times)[len(times) // 2]
        log(f"  {name} leg: steps {[round(t, 4) for t in times]} s (median "
            f"{step_s:.4f} s, {TRAIN_BATCH * 10 / step_s:.1f} audio-s/s), "
            f"peak {peak / 2**30:.2f} GiB, losses "
            f"{[round(x, 4) for x in losses]}, launches over "
            f"{TRAIN_TIMED} steps {launches} ({card})")
        if not all(np.isfinite(losses)):
            fail(f"train {name} leg: non-finite loss {losses}")
        check_launches(f"train step, {name} leg", launches, want, TRAIN_TIMED)
        out[name] = {"step_s": times, "median_step_s": step_s,
                     "audio_s_per_s": TRAIN_BATCH * 10 / step_s,
                     "peak_bytes": peak, "losses": losses,
                     "launches": launches}
        del st, m

    # ---- A without remat (forward only) and in eval ----
    _, step_plain, _ = build_ditto_train_step(
        dcfg.replace(remat_blocks=False), ccfg, gcfg,
        learning_rate=TRAIN_LR)
    counts = {}
    for label, fn in (("step without remat", lambda: step_plain(
            state0, frozen, legs["latents"],
            torch.Generator(device=dev).manual_seed(1))),
                      ("eval_fn", lambda: eval_fn(
            state0, frozen, legs["latents"],
            torch.Generator(device=dev).manual_seed(1)))):
        kernels.reset_launches()
        fn()
        torch.cuda.synchronize()
        counts[label] = dict(kernels.launches)
        check_launches(f"train, {label}", counts[label],
                       train_step_launches(dcfg, ccfg, False, remat=False), 1)
    log(f"  A launches: {counts} (the backward adds none)")
    out["launches_no_remat_and_eval"] = counts

    # ---- kernel A's gradient against the plain version ----
    checks = Checks()
    errs = {}
    b, h = TRAIN_BATCH, dcfg.num_heads
    for dt in (torch.bfloat16, torch.float32):
        # self and cross attention have one shape: the text ids are cut
        # to the latents' length
        for seed, (label, sq, sk, causal) in enumerate((
                ("self", frames, frames, False),
                ("cross", frames, frames, False),
                ("causal S1024 (GPT2)", 1024, 1024, True))):
            bb = 4 if causal else b
            errs.update(grad_check_a(
                torch, checks, f"B{bb} H{h} Sq{sq} Sk{sk} D64 {label}",
                (bb, h, sq, 64), (bb, h, sk, 64), causal, dt, dev, seed))
    if checks.bad:
        fail("kernel A gradient: " + "; ".join(checks.bad))
    out["a_grad_max_abs_err"] = errs

    # ---- the attention backward's share of a step (speed item S10) ----
    gen = torch.Generator(device=dev).manual_seed(8)
    q, k, v, g = (torch.randn(b, h, frames, 64, generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(4))
    bwd_ms = eager_ms(torch, lambda: attention_backward(q, k, v, g))
    calls = 2 * dcfg.num_layers
    share = {leg: calls * bwd_ms / 1e3 / out[leg]["median_step_s"]
             for leg in legs}
    log(f"  attention backward (stock ops, bf16 B{b} H{h} S{frames} D64): "
        f"{bwd_ms:.3f} ms a call, {calls} a step: {calls * bwd_ms:.1f} ms, "
        + ", ".join(f"{v:.1%} of the {k} leg's step" for k, v in
                    share.items()))
    out["attention_backward"] = {"ms_per_call": bwd_ms,
                                 "calls_per_step": calls, "share": share}

    # ---- one fp32 step, card vs CPU ----
    pcfg = dcfg.replace(compute_dtype="float32", cross_attn_dropout=0.0)
    _, step32, _ = build_ditto_train_step(pcfg, ccfg, gcfg,
                                          learning_rate=TRAIN_LR)
    prng = np.random.default_rng(5)
    clip = {"audio": torch.from_numpy(0.05 * prng.standard_normal(
                (1, 1, 24000)).astype(np.float32)),
            "text_ids": torch.from_numpy(prng.integers(0, gcfg.vocab_size,
                                                       (1, 64)))}
    t = torch.from_numpy(prng.integers(0, pcfg.diffusion_steps, (1,)))
    noise = torch.from_numpy(prng.standard_normal(
        (1, 24000 // ccfg.hop_length, pcfg.hidden_dim)).astype(np.float32))
    _, step32_cpu, _ = build_ditto_train_step(pcfg, ccfg, gcfg,
                                              learning_rate=TRAIN_LR,
                                              device="cpu")
    cpu_state = init_dit_train_state(pcfg, seed=0, device="cpu")
    t0 = time.perf_counter()
    got, gm = step32(on(dev, cpu_state), frozen, clip, t=t, noise=noise)
    want, wm = step32_cpu(cpu_state, frozen_of(params_cpu), clip, t=t,
                          noise=noise)
    # tolerances: the loss and the updated parameters 1e-5 of their scale,
    # the moments (the gradient summed over 12 layers in another order)
    # 1e-4 of theirs
    cmp = {"loss": (gm["loss"], wm["loss"], 1e-5),
           "mu": (got["opt_state"][0]["mu"], want["opt_state"][0]["mu"],
                  1e-4),
           "nu": (got["opt_state"][0]["nu"], want["opt_state"][0]["nu"],
                  1e-4),
           "params": (ravel_tree(got["params"])[0],
                      ravel_tree(want["params"])[0], 1e-5)}
    res = {}
    for key, (x, y, tol) in cmp.items():
        err = (x.cpu() - y).abs().max().item()
        scale = y.abs().max().item()
        res[key] = {"max_abs_err": err, "scale": scale, "tol": tol}
        if not (np.isfinite(scale) and err <= tol * scale):
            fail(f"train card vs CPU: {key} differs by {err} (scale "
                 f"{scale}, tol {tol})")
    if int(got["step"]) != 1 or int(got["opt_state"][0]["count"]) != 1:
        fail("train card vs CPU: step or count is not 1")
    log("  one fp32 step, 1 s clip, B=1, card vs CPU (TF32 off, dropout 0): "
        + ", ".join(f"{k} {v['max_abs_err']:.3e} (scale {v['scale']:.3e}, "
                    f"tol {v['tol']:g} x scale)" for k, v in res.items())
        + f"; {time.perf_counter() - t0:.1f} s")
    out["card_vs_cpu"] = res

    # ---- determinism, and remat's recompute reusing the dropout mask ----
    def flat_params(s):
        return ravel_tree(s["params"])[0]

    runs = [step_fn(state0, frozen, legs["latents"],
                    torch.Generator(device=dev).manual_seed(3))
            for _ in range(2)]
    if not (torch.equal(flat_params(runs[0][0]), flat_params(runs[1][0]))
            and torch.equal(runs[0][1]["loss"], runs[1][1]["loss"])):
        fail("train: two steps from one state and seed differ")
    rcfg = DiTConfig(num_layers=REMAT_LAYERS, num_heads=12,
                     compute_dtype="float32", remat_blocks=False)
    small = init_dit_train_state(rcfg, seed=2)
    small_batch = {k: v[:2] for k, v in legs["latents"].items()}
    mus = {}
    for label, cfg_r in (("no remat", rcfg),
                         ("remat nothing_saveable", rcfg.replace(
                             remat_blocks=True,
                             remat_policy="nothing_saveable")),
                         ("remat dots", rcfg.replace(remat_blocks=True))):
        _, fn, _ = build_ditto_train_step(cfg_r, ccfg, gcfg,
                                          learning_rate=TRAIN_LR)
        s1, _ = fn(small, frozen, small_batch,
                   torch.Generator(device=dev).manual_seed(4))
        mus[label] = s1["opt_state"][0]["mu"]
    remat_err = {k: (v - mus["no remat"]).abs().max().item()
                 for k, v in mus.items() if k != "no remat"}
    scale = mus["no remat"].abs().max().item()
    log(f"  determinism: two steps from one state and seed equal bit for "
        f"bit; remat vs not, {REMAT_LAYERS} layers, fp32, dropout 0.1: mu "
        f"max|err| "
        f"{remat_err} (scale {scale:.3e})")
    if not all(e <= 1e-6 * scale for e in remat_err.values()):
        fail(f"train: remat changes the gradient: {remat_err}")
    out["remat_mu_max_abs_err"] = remat_err

    # ---- checkpoints: a round trip at CKPT_LAYERS, then Trainer.fit ----
    tmp = ROOT / ".chip_smoke_tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        kcfg = dcfg.replace(num_layers=CKPT_LAYERS)
        _, kstep, _ = build_ditto_train_step(kcfg, ccfg, gcfg,
                                             learning_rate=TRAIN_LR)
        saved = kstep(init_dit_train_state(kcfg, 0), frozen, legs["latents"],
                      torch.Generator(device=dev).manual_seed(5))[0]
        path = str(tmp / "dit_state.npz")
        (_, save_s) = sync_time(torch, save_checkpoint, path, saved,
                                {"epoch": 1})
        size = os.path.getsize(path)
        restored, load_s = sync_time(torch, restore_into,
                                     init_dit_train_state(kcfg, 9), path)
        nxt = [kstep(s, frozen, legs["latents"],
                     torch.Generator(device=dev).manual_seed(6))[0]
               for s in (saved, restored)]
        if not (torch.equal(flat_params(nxt[0]), flat_params(nxt[1]))
                and torch.equal(nxt[0]["opt_state"][0]["nu"],
                                nxt[1]["opt_state"][0]["nu"])
                and int(nxt[1]["step"]) == 2):
            fail("train: a step from the restored state differs")
        log(f"  checkpoint of a {CKPT_LAYERS}-layer train state: "
            f"{size / 2**20:.1f} MiB npz, save {save_s:.1f} s, restore "
            f"{load_s:.1f} s; the next step from it equals the step from "
            "the saved state bit for bit")
        out["checkpoint"] = {"bytes": size, "save_s": save_s,
                             "restore_s": load_s}

        fcfg = DiTConfig(num_layers=FIT_LAYERS, num_heads=12,
                         remat_blocks=True, compute_dtype="bfloat16")
        finit, fstep, feval = build_ditto_train_step(
            fcfg, ccfg, gcfg, learning_rate=TRAIN_LR)
        ckdir = str(tmp / "fit")

        def fit(epochs):
            return Trainer(fstep, feval).fit(
                finit(init_dit_train_state(fcfg, 3)["params"]),
                frozen, lambda: [small_batch, small_batch],
                lambda: [small_batch], epochs=epochs,
                generator=torch.Generator().manual_seed(0), model_name="dit",
                checkpoint_dir=ckdir, checkpoint_interval=1,
                log_path=str(tmp / "fit.jsonl"), verbose=False)

        _, hist = fit(2)
        names = sorted(os.listdir(ckdir))
        expect = sorted(f"dit_{tag}.{ext}" for tag in
                        ("epoch_1", "epoch_2", "best", "final")
                        for ext in ("npz", "json"))
        if names != expect or len(hist["train"]["loss"]) != 2:
            fail(f"Trainer.fit wrote {names}, history {hist}")
        st3, hist3 = fit(3)
        if len(hist3["train"]["loss"]) != 3 or not os.path.exists(
                os.path.join(ckdir, "dit_epoch_3.npz")):
            fail(f"Trainer.fit did not resume from epoch 2: {hist3}")
        log(f"  Trainer.fit ({FIT_LAYERS} layer(s), 2 epochs x 2 steps, then "
            f"resumed to 3): files {names}, train losses {hist3['train']['loss']}, "
            f"validation {hist3['validation']['loss']}")
        out["fit"] = {"files": names, "history": hist3}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["train"] = out
    # launches per step, as counted in the audio leg's timed steps
    return {k: v // TRAIN_TIMED for k, v in out["audio"]["launches"].items()}


# --------------------------------------------------------------------------
# phase 11: the NAC and SLP steps, the data layer and the training CLIs
# --------------------------------------------------------------------------

# the JAX CLIs' setups (scripts/train_nac.py, scripts/train_slp.py):
# NACConfig (B=4, lr 1e-4, GPT2-small) and SLPConfig (B=8, lr 1e-4,
# ByT5-small), the 10 s bucket
NAC_BATCH, SLP_BATCH, CORPUS_TIMED = 4, 8, 5
# matmul-softmax attention a step (forward; the backward calls none):
# GPT2's 12 layers in the NAC step; the SLP decoder's 2 and ByT5's 12
NAC_PLAIN_ATTENTION = {"decoder": 0, "byt5": 0, "gpt2": 12, "s2t": 0}
SLP_STEP_PLAIN_ATTENTION = {"decoder": 2, "byt5": 12, "gpt2": 0, "s2t": 0}
# the synthetic corpus: exactly 10 s (the 10 s bucket) and ~12 s (the
# 12.5 s bucket), WAV bytes under MLS's .opus names; real Ogg-Opus clips of
# 10.5 and 11.5 s beside them where libopus loads
CORPUS_WAV_SECONDS = (10.0, 10.0, 12.0, 12.2)
CORPUS_OPUS_SECONDS = (10.5, 11.5)


def codec_b_launches(codec_cfg) -> int:
    """Kernel B launches of one SEANet encode or decode: the init and final
    convs and each resblock's three stride-1 convs."""
    return 2 + 3 * len(codec_cfg.ratios) * codec_cfg.num_residual_layers


@contextlib.contextmanager
def fixed_indices(codes=None, vq_idx=None):
    """Within it, the codec encode returns ``codes`` and the NAC's VQ picks
    ``vq_idx`` (tensors on the caller's device), so a card step can run on
    the CPU's indices where an argmax flipped."""
    from ditto_tts_tpu_torch.codec import encodec, rvq
    saved = (encodec.codec_encode, rvq.nearest_codebook_indices)
    if codes is not None:
        encodec.codec_encode = lambda *a, **k: codes
    if vq_idx is not None:
        rvq.nearest_codebook_indices = lambda *a, **k: vq_idx
    try:
        yield
    finally:
        encodec.codec_encode, rvq.nearest_codebook_indices = saved


def timed_steps(torch, np, label, step_fn, state, frozen, batch, want,
                plain_want, b, card):
    """A warm-up, then CORPUS_TIMED synchronized steps with the peak memory
    of this leg, exact kernel launches and matmul-softmax calls a step."""
    from ditto_tts_tpu_torch import kernels
    st, m = step_fn(state, frozen, batch)
    torch.cuda.synchronize()
    metrics = [{k: v.item() for k, v in m.items()}]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times = []
    with PlainAttentionLog() as plain:
        for _ in range(CORPUS_TIMED):
            (st, m), dt = sync_time(torch, step_fn, st, frozen, batch)
            times.append(dt)
            metrics.append({k: v.item() for k, v in m.items()})
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    step_s = sorted(times)[len(times) // 2]
    log(f"  {label}: steps {[round(t, 4) for t in times]} s (median "
        f"{step_s:.4f} s, {b * 10 / step_s:.1f} audio-s/s), peak "
        f"{peak / 2**30:.2f} GiB, launches over {CORPUS_TIMED} steps "
        f"{launches}, matmul-softmax calls {plain.counts} ({card})")
    log(f"    metrics: {metrics[0]} ... {metrics[-1]}")
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        fail(f"{label}: a non-finite metric {metrics}")
    check_launches(label, launches, want, CORPUS_TIMED)
    if plain.counts != {k: v * CORPUS_TIMED for k, v in plain_want.items()}:
        fail(f"{label}: matmul-softmax attention calls {plain.counts}, "
             f"expected {plain_want} a step")
    return st, {"step_s": times, "median_step_s": step_s,
                "audio_s_per_s": b * 10 / step_s, "peak_bytes": peak,
                "metrics": metrics, "launches": launches,
                "plain_attention": dict(plain.counts)}


def largest_param_errors(torch, label, before, got, want, n=3):
    """The ``n`` parameters farthest apart after one step card vs CPU: leaf
    path and index, the step's gradient (mu / (1 - b1), mu being 0
    before it) and nu on each device, and the Adam eps. At step 1 Adam's
    update is g / (|g| + eps), so two gradients near eps that differ move a
    parameter by a large part of lr."""
    from ditto_tts_tpu_torch.params import ravel_tree, tree_leaves
    from ditto_tts_tpu_torch.train.steps import AdamW
    p0 = ravel_tree(before["params"])[0].cpu()
    pg, pw = ravel_tree(got["params"])[0].cpu(), ravel_tree(want["params"])[0]
    st = {"card": got["opt_state"][0], "cpu": want["opt_state"][0]}
    paths, ends = [], [0]
    for path, leaf in tree_leaves(want["params"]):
        paths.append(path)
        ends.append(ends[-1] + leaf.numel())
    out = []
    for i in (pg - pw).abs().topk(n).indices.tolist():
        j = next(m for m in range(len(paths)) if ends[m + 1] > i)
        e = {"path": paths[j], "index": i - ends[j],
             "abs_err": abs(pg[i] - pw[i]).item(), "p_before": p0[i].item(),
             "eps": AdamW.eps}
        for d, s in st.items():
            e[f"g_{d}"] = s["mu"][i].item() / (1.0 - AdamW.b1)
            e[f"nu_{d}"] = s["nu"][i].item()
        out.append(e)
        log(f"    {label} params error {e['abs_err']:.3e} at {e['path']}"
            f"[{e['index']}]: g card {e['g_card']:.4e}, g cpu "
            f"{e['g_cpu']:.4e} (eps {AdamW.eps:g}), nu card "
            f"{e['nu_card']:.4e}, nu cpu {e['nu_cpu']:.4e}, p before "
            f"{e['p_before']:.4e}")
    return out


def compare_states(torch, np, label, before, got, want, gm, wm, loss_key):
    """One fp32 step card vs CPU at phase 10's tolerances: the loss and
    the updated params 1e-5 of their scale, mu and nu 1e-4; the largest
    params errors located (``largest_param_errors``)."""
    from ditto_tts_tpu_torch.params import ravel_tree
    cmp = {"loss": (gm[loss_key], wm[loss_key], 1e-5),
           "mu": (got["opt_state"][0]["mu"], want["opt_state"][0]["mu"],
                  1e-4),
           "nu": (got["opt_state"][0]["nu"], want["opt_state"][0]["nu"],
                  1e-4),
           "params": (ravel_tree(got["params"])[0],
                      ravel_tree(want["params"])[0], 1e-5)}
    res = {}
    for key, (x, y, tol) in cmp.items():
        err = (x.cpu() - y).abs().max().item()
        scale = y.abs().max().item()
        res[key] = {"max_abs_err": err, "scale": scale, "tol": tol}
    if int(got["step"]) != 1:
        fail(f"{label} card vs CPU: step is not 1")
    log(f"  {label}, one fp32 step card vs CPU: " + ", ".join(
        f"{k} {v['max_abs_err']:.3e} (scale {v['scale']:.3e}, tol "
        f"{v['tol']:g} x scale)" for k, v in res.items()))
    res["largest_params_errors"] = largest_param_errors(
        torch, label, before, got, want)
    for key, v in res.items():
        if key in cmp and not (np.isfinite(v["scale"]) and
                               v["max_abs_err"] <= v["tol"] * v["scale"]):
            fail(f"{label} card vs CPU: {key} differs by {v['max_abs_err']} "
                 f"(scale {v['scale']}, tol {v['tol']})")
    return res


def write_corpus(np, root: Path, opus: bool) -> list:
    """An MLS-layout corpus under ``root``; returns the clip paths."""
    import wave
    from ditto_tts_tpu_torch.data import native_loader as nl
    lines, paths = [], []
    clips = [(s, "wav") for s in CORPUS_WAV_SECONDS]
    if opus:
        clips += [(s, "opus") for s in CORPUS_OPUS_SECONDS]
    for i, (secs, kind) in enumerate(clips):
        utt = f"10{i:02d}_20{i:02d}_000000"
        path = root / "audio_clean" / f"10{i:02d}" / f"20{i:02d}" / \
            f"{utt}.opus"
        path.parent.mkdir(parents=True, exist_ok=True)
        t = np.arange(int(secs * 24000)) / 24000
        pcm = 0.3 * np.sin(2 * np.pi * (180.0 + 20 * i) * t)
        if kind == "opus":
            nl.encode_opus(str(path), pcm.astype(np.float32), 24000)
        else:
            with wave.open(str(path), "wb") as f:
                f.setnchannels(1)
                f.setsampwidth(2)
                f.setframerate(24000)
                f.writeframes((pcm * 32767).astype(np.int16).tobytes())
        lines.append(f"{utt}\tbonjour, numéro {i} de l'élève")
        paths.append(str(path))
    (root / "transcripts.txt").write_text("\n".join(lines), encoding="utf-8")
    return paths


def by_text(np, batches) -> dict:
    """{text ids: (samples, label)} over batches of any order and
    padding."""
    out = {}
    for b in batches:
        for r in range(len(b["label"])):
            n = int(b["padding_mask"][r].sum())
            out[tuple(b["text_ids"][r])] = (b["audio"][r, 0, :n].copy(),
                                            int(b["label"][r]))
    return out


def corpus_phase(torch, np, params, params_cpu, byt5_gpu, card, rec):
    import shutil
    from ditto_tts_tpu_torch.config import (CodecConfig, GPT2Config,
                                            NACConfig, SLPConfig,
                                            byt5_small_config)
    from ditto_tts_tpu_torch.data import latents as lat_mod
    from ditto_tts_tpu_torch.data import mls
    from ditto_tts_tpu_torch.data import native_loader as nl
    from ditto_tts_tpu_torch.data.processing import decoder_for
    from ditto_tts_tpu_torch.codec import encodec, rvq
    from ditto_tts_tpu_torch.params import (init_nac_train_state,
                                            init_slp_train_state, ravel_tree,
                                            tree_map)
    from ditto_tts_tpu_torch.text.tokenizers import ByT5Tokenizer
    from ditto_tts_tpu_torch.train.steps import (build_nac_train_step,
                                                 build_slp_train_step)

    t_phase = time.perf_counter()
    dev = params.codec["encoder"]["init_conv"]["weight"].device
    out = {"card": card}
    ccfg, gcfg, bcfg = CodecConfig(), GPT2Config(), byt5_small_config()
    ncfg, scfg = NACConfig(), SLPConfig()
    enc_b = codec_b_launches(ccfg)
    nac_want = {"attention": 0, "conv1d": 2 * enc_b, "act_conv": 0,
                "snake": 0, "dit_glue": 0}
    slp_want = {"attention": 0, "conv1d": enc_b, "act_conv": 0, "snake": 0,
                "dit_glue": 0}
    rng = np.random.default_rng(11)

    def on(device, tree):
        return tree_map(lambda t: t.to(device), tree)

    # ---- the NAC step at full width ----
    nac_frozen = {"codec": params.codec, "gpt2": params.gpt2}
    samples = TRAIN_SAMPLES
    # one row padded inside the 750 ids GPT2 reads (MLS text is ~100-300
    # ids), so the -1e9 padding bias runs
    text_mask = np.ones((NAC_BATCH, 1024), np.int32)
    text_mask[1, 200:] = 0
    nac_batch = {
        "audio": torch.from_numpy(0.05 * rng.standard_normal(
            (NAC_BATCH, 1, samples)).astype(np.float32)).to(dev),
        "padding_mask": torch.ones((NAC_BATCH, samples), dtype=torch.int32,
                                   device=dev),
        "text_ids": torch.from_numpy(rng.integers(
            0, gcfg.vocab_size, (NAC_BATCH, 1024))).to(dev),
        "text_mask": torch.from_numpy(text_mask).to(dev)}
    nac_state = init_nac_train_state(ncfg, seed=0, device=dev)
    _, nac_step, _ = build_nac_train_step(ncfg, ccfg, gcfg,
                                          learning_rate=TRAIN_LR, device=dev)
    log(f"  NAC: GPT2-small {gcfg.n_layer} x {gcfg.n_embd} (phase 4's "
        f"tree), EnCodec 24 kHz at 1.5 kbps, straight-through VQ "
        f"{ncfg.codebook_size} x {ncfg.hidden_size}, flat AdamW lr "
        f"{TRAIN_LR}; B={NAC_BATCH}, {samples} samples "
        f"({samples // ccfg.hop_length} frames), 1024 GPT2 ids cut to "
        f"{samples // ccfg.hop_length}")
    _, out["nac"] = timed_steps(torch, np, "NAC step", nac_step, nac_state,
                                nac_frozen, nac_batch, nac_want,
                                NAC_PLAIN_ATTENTION, NAC_BATCH, card)
    _, ref_step, _ = build_nac_train_step(ncfg, ccfg, gcfg, ref_compat=True,
                                          learning_rate=TRAIN_LR, device=dev)
    _, m = ref_step(nac_state, nac_frozen, nac_batch)
    if sorted(m) != ["lm_loss", "reconstruction_loss", "total_loss"] or \
            not all(np.isfinite(v.item()) for v in m.values()):
        fail(f"NAC ref_compat step: metrics {m}")
    log(f"  NAC ref_compat step: {sorted(m)} (no VQ losses)")
    del nac_batch

    # ---- the SLP step at full width ----
    slp_frozen = {"codec": params.codec, "byt5": byt5_gpu}
    smask = np.ones((SLP_BATCH, 128), np.int32)
    smask[:, 100:] = 0
    slp_batch = {
        "audio": torch.from_numpy(0.05 * rng.standard_normal(
            (SLP_BATCH, 1, samples)).astype(np.float32)).to(dev),
        "padding_mask": torch.ones((SLP_BATCH, samples), dtype=torch.int32,
                                   device=dev),
        "text_ids": torch.from_numpy(rng.integers(
            3, 259, (SLP_BATCH, 128))).to(dev),
        "text_mask": torch.from_numpy(smask).to(dev),
        "label": torch.from_numpy(rng.integers(0, 11, (SLP_BATCH,))).to(dev)}
    slp_state = init_slp_train_state(scfg, ccfg.codebook_size, seed=0,
                                     device=dev)
    _, slp_step, _ = build_slp_train_step(scfg, ccfg, bcfg,
                                          learning_rate=TRAIN_LR, device=dev)
    log(f"  SLP: ByT5-small {bcfg.num_layers} x {bcfg.d_model} (phase 8's "
        f"tree), the decoder's {scfg.num_layers} layer with "
        f"{scfg.num_heads} head of {scfg.embedding_dim}, flat AdamW lr "
        f"{TRAIN_LR}; B={SLP_BATCH}, {samples} samples, 128 byte ids")
    _, out["slp"] = timed_steps(torch, np, "SLP step", slp_step, slp_state,
                                slp_frozen, slp_batch, slp_want,
                                SLP_STEP_PLAIN_ATTENTION, SLP_BATCH, card)
    del slp_batch

    # ---- one fp32 step each, card vs CPU; determinism ----
    prng = np.random.default_rng(12)
    clip = prng.standard_normal((1, 1, 24000)).astype(np.float32) * 0.05
    frames = 24000 // ccfg.hop_length
    nac_clip = {"audio": torch.from_numpy(clip),
                "padding_mask": torch.ones((1, 24000), dtype=torch.int32),
                "text_ids": torch.from_numpy(prng.integers(
                    0, gcfg.vocab_size, (1, 96))),
                # padded inside the 75 ids the 1 s clip's frames keep
                "text_mask": torch.from_numpy(
                    (np.arange(96) < 40).astype(np.int32)[None])}
    slp_clip = {"audio": torch.from_numpy(clip),
                "padding_mask": torch.ones((1, 24000), dtype=torch.int32),
                "text_ids": torch.from_numpy(prng.integers(3, 259, (1, 64))),
                "text_mask": torch.ones((1, 64), dtype=torch.int32),
                "label": torch.tensor([4])}
    agree = {}
    with torch.no_grad():
        codes = {d: encodec.codec_encode(
            p.codec, ccfg, torch.from_numpy(clip).to(on_dev))
            for d, p, on_dev in (("card", params, dev),
                                 ("cpu", params_cpu, "cpu"))}
        agree["codec codes"] = (codes["card"].cpu() == codes["cpu"]).float(
            ).mean().item()
        trainable = {"card": nac_state["params"],
                     "cpu": on("cpu", nac_state["params"])}
        vq = {d: rvq.nearest_codebook_indices(
            t["embedding_head"]["weight"][codes["cpu"].to(t["embedding_head"][
                "weight"].device)], t["vector_quantizer"]["codebook"])
            for d, t in trainable.items()}
        agree["NAC VQ indices"] = (vq["card"].cpu() == vq["cpu"]).float(
            ).mean().item()
    log(f"  index agreement card vs CPU, 1 s clip: {agree}")
    flips = any(v < 1.0 for v in agree.values())

    def pinned():
        return fixed_indices(codes["cpu"].to(dev), vq["cpu"].to(dev)) \
            if flips else contextlib.nullcontext()

    if flips:
        log("  an index flipped: the card's steps take the CPU's indices")
    res = {"index_agreement": agree}
    _, nac32_cpu, _ = build_nac_train_step(ncfg, ccfg, gcfg,
                                           learning_rate=TRAIN_LR,
                                           device="cpu")
    _, slp32_cpu, _ = build_slp_train_step(scfg, ccfg, bcfg,
                                           learning_rate=TRAIN_LR,
                                           device="cpu")
    byt5_cpu = on("cpu", byt5_gpu)
    for label, step_gpu, step_cpu, state, fz_gpu, fz_cpu, batch, key in (
            ("NAC", nac_step, nac32_cpu, nac_state, nac_frozen,
             {"codec": params_cpu.codec, "gpt2": params_cpu.gpt2}, nac_clip,
             "total_loss"),
            ("SLP", slp_step, slp32_cpu, slp_state, slp_frozen,
             {"codec": params_cpu.codec, "byt5": byt5_cpu}, slp_clip,
             "loss")):
        state_cpu = on("cpu", state)
        with pinned():
            runs = [step_gpu(state, fz_gpu, batch) for _ in range(2)]
        want, wm = step_cpu(state_cpu, fz_cpu, batch)
        res[label] = compare_states(torch, np, label, state_cpu,
                                    runs[0][0], want, runs[0][1], wm, key)
        if not (torch.equal(ravel_tree(runs[0][0]["params"])[0],
                            ravel_tree(runs[1][0]["params"])[0])
                and torch.equal(runs[0][0]["opt_state"][0]["nu"],
                                runs[1][0]["opt_state"][0]["nu"])
                and all(torch.equal(runs[0][1][k], runs[1][1][k])
                        for k in runs[0][1])):
            fail(f"{label}: two steps from one state differ")
        del runs, want
    log("  determinism: two NAC and two SLP steps from one state equal bit "
        "for bit")
    out["card_vs_cpu"] = res
    del byt5_cpu

    # ---- the corpus, the batches and the latent cache ----
    tmp = ROOT / ".chip_smoke_tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        corpus = tmp / "mls"
        opus = nl.opus_available()
        paths = write_corpus(np, corpus, opus)
        routes = {}
        for p in paths:
            routes[decoder_for(p)] = routes.get(decoder_for(p), 0) + 1
        log(f"  corpus: {len(paths)} clips ({'with' if opus else 'without'} "
            f"libopus: real Ogg-Opus {'beside' if opus else 'missing from'} "
            f"the WAV bytes), decoded by {routes}")
        out["decoders"] = routes
        buckets = mls.default_buckets()
        ds = mls.MLSDataset(str(corpus), ByT5Tokenizer(), 64,
                            tokenizer_name="byt5")
        items = {tuple(ds[i]["text_ids"]): (ds[i]["audio"],
                                             int(ds[i]["label"]))
                 for i in range(len(ds))}
        py = by_text(np, mls.batches(ds, 2, buckets=buckets, seed=1))
        native = by_text(np, mls.batches_native(ds, 2, buckets=buckets,
                                                workers=2, seed=1))
        for name, got in (("batches", py), ("batches_native", native)):
            if sorted(got) != sorted(items) or not all(
                    np.array_equal(got[k][0], items[k][0])
                    and got[k][1] == items[k][1] for k in items):
                fail(f"{name} disagrees with MLSDataset's items")
        log(f"  MLSDataset, batches and batches_native: the same "
            f"{len(items)} items (samples, labels, text)")

        frozen = {"codec": params.codec,
                  "embedding_head": params.embedding_head}
        cache = str(tmp / "latents")
        t0 = time.perf_counter()
        index = lat_mod.precompute(ds, frozen, ccfg, cache_dir=cache,
                                   batch_size=2, buckets=buckets, device=dev)
        pre_s = time.perf_counter() - t0
        encode = lat_mod.make_encode_fn(ccfg, "bfloat16")
        same_size, single = [], []
        checks = Checks()
        with held_to_plain(checks, "SEANet encode") as seanet:
            for b in lat_mod.latent_batches(cache, ds, 2, seed=2):
                members = [ds[i] for i in b["indices"]]
                col = mls.collate(members, buckets)
                direct = encode(frozen, torch.from_numpy(col["audio"]).to(dev),
                                torch.from_numpy(col["padding_mask"]).to(dev))
                same_size.append(np.array_equal(b["latents"],
                                                direct.cpu().numpy()))
                for r in range(len(members)):
                    one = encode(frozen, *(
                        torch.from_numpy(col[k][r:r + 1]).to(dev)
                        for k in ("audio", "padding_mask")))
                    d = one.cpu().numpy()[0]
                    frames_equal = (d == b["latents"][r]).all(axis=-1).mean()
                    single.append((float(frames_equal),
                                   float(np.abs(d - b["latents"][r]).max())))
        log(f"  latent cache: precompute (bf16, on the card) {pre_s:.1f} s, "
            f"buckets {index['buckets']}; each cached batch against a direct "
            f"encode of its members at the same size (B=2): "
            f"{'bitwise equal' if all(same_size) else same_size}; against "
            f"B=1 encodes: frames equal "
            f"{min(f for f, _ in single):.4f}-{max(f for f, _ in single):.4f}"
            f", max|err| {max(e for _, e in single):.3e}")
        if not all(same_size):
            fail("latent cache: a cached batch differs from a direct encode "
                 "of its members at the same size")
        if checks.bad:
            fail("kernel B in the bf16 SEANet encode: " + "; ".join(
                checks.bad))
        out["latent_cache"] = {"precompute_s": pre_s,
                               "seanet_bf16_conv_max_abs_err": seanet,
                               "buckets": index["buckets"],
                               "same_size_bitwise": all(same_size),
                               "b1_frames_equal_and_max_err": single}

        # ---- the three CLIs, as subprocesses on the card ----
        def cli(which, *args):
            cmd = [sys.executable, "-m",
                   f"ditto_tts_tpu_torch.scripts.train_{which}",
                   "--train-path", str(corpus), "--device", dev.type,
                   "--batch-size", "2", "--epochs", "1", *args]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                                  text=True, timeout=300)
            dt = time.perf_counter() - t0
            if proc.returncode != 0:
                fail(f"train_{which} {args}: rc {proc.returncode}\n"
                     f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
            return proc.stdout, dt

        clis = {}
        nac_dir, slp_dir, dit_dir = (str(tmp / n) for n in ("nac", "slp",
                                                            "dit"))
        _, clis["train_nac"] = cli("nac", "--checkpoint-dir", nac_dir)
        _, clis["train_slp"] = cli("slp", "--checkpoint-dir", slp_dir)
        dit_args = ("--checkpoint-dir", dit_dir, "--latent-cache",
                    str(tmp / "cli_latents"), "--nac-checkpoint",
                    os.path.join(nac_dir, "NAC_final.npz"), "--layers", "1",
                    "--heads", "12")
        _, clis["train_ditto"] = cli("ditto", *dit_args)
        # the last --epochs wins: a second epoch, resumed from the first
        out2, clis["train_ditto resume"] = cli("ditto", *dit_args,
                                               "--epochs", "2")
        files = {d: sorted(os.listdir(p)) for d, p in
                 (("nac", nac_dir), ("slp", slp_dir), ("dit", dit_dir))}
        expect = {"nac": ["NAC_final.json", "NAC_final.npz"],
                  "slp": ["SLP_final.json", "SLP_final.npz"],
                  "dit": sorted(f"DiTTO_{t}.{e}" for t in
                                ("epoch_1", "epoch_2", "final")
                                for e in ("json", "npz"))}
        shard = tmp / "cli_latents" / "train_shard0of1"
        if files != expect or "resumed from" not in out2 or not (
                shard / "index.json").exists():
            fail(f"training CLIs: files {files}, resume output "
                 f"{out2[-1500:]}")
        log(f"  CLIs on the card: {', '.join(f'{k} {v:.1f} s' for k, v in clis.items())}; "
            f"files {files}; the second train_ditto resumed from epoch 1")
        out["clis"] = {"seconds": clis, "files": files}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 11: {out['phase_s']:.1f} s")
    rec["corpus_training"] = out
    return {"nac_step": {k: v // CORPUS_TIMED
                         for k, v in out["nac"]["launches"].items()},
            "slp_step": {k: v // CORPUS_TIMED
                         for k, v in out["slp"]["launches"].items()}}


# --------------------------------------------------------------------------
# phase 12: synthesize and evaluate (the CLI twins and the eval leg)
# --------------------------------------------------------------------------

# the synthesize twin: a 10 s prompt, 50 DDPM steps; the evaluate twin: B=2
# over phase 11's 4-clip corpus (two batches, the 10 s and the 12.5 s
# bucket), 50 DDPM steps, s2t-medium and ECAPA. A CPU rehearsal sets
# smaller CLI arguments here.
PROMPT_SECONDS = 10
SYNTH_ARGS = ["--steps", "50"]
EVAL_BATCH, EVAL_BATCHES = 2, 2
EVAL_ARGS = ["--steps", "50"]
EVAL_TOL = 1e-4         # S2T and ECAPA, card vs CPU: max|err| / max|CPU|
MEL_MAE_TOL = 1e-5      # mel_mae, card vs CPU, relative


def greedy_attention_calls(s2t_cfg, max_len: int) -> int:
    """Matmul-softmax calls of one ``greedy_decode``: the encoder's layers
    once, the decoder's self and cross attention at every step."""
    return s2t_cfg.encoder_layers + (max_len - 2) * s2t_cfg.decoder_layers * 2


def rel_err(got, want) -> tuple:
    err = (got.float().cpu() - want.float()).abs().max().item()
    return err, want.float().abs().max().item()


def run_cli(which: str, args: list, timeout: int = 600):
    cmd = [sys.executable, "-m", f"ditto_tts_tpu_torch.scripts.{which}",
           *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{which} {args}: rc {proc.returncode}\n{proc.stdout[-3000:]}\n"
             f"{proc.stderr[-3000:]}")
    return proc.stdout, dt


def read_wav(np, path):
    import wave
    with wave.open(str(path), "rb") as f:
        head = (f.getnchannels(), f.getsampwidth(), f.getframerate())
        pcm = np.frombuffer(f.readframes(f.getnframes()), np.int16)
    return head, pcm


def eval_phase(torch, np, cfg, params_cpu, dev, card, rec):
    import shutil
    from ditto_tts_tpu_torch import kernels
    from ditto_tts_tpu_torch.data import mls
    from ditto_tts_tpu_torch.eval.metrics import mel_mae
    from ditto_tts_tpu_torch.eval.throughput import time_fn
    from ditto_tts_tpu_torch.infer.generator import build_synthesize
    from ditto_tts_tpu_torch.models import ecapa, s2t, vocoder
    from ditto_tts_tpu_torch.params import (init_ecapa_params,
                                            init_s2t_params, tree_leaves,
                                            tree_map)
    from ditto_tts_tpu_torch.scripts import evaluate as ev
    from ditto_tts_tpu_torch.scripts._common import (generator_params,
                                                     gpt2_tokenizer)
    from ditto_tts_tpu_torch.text.s2t_tokenizer import S2TTokenizer
    from ditto_tts_tpu_torch.train.checkpoint import _flatten
    from ditto_tts_tpu_torch.utils.profiling import span, trace
    from ditto_tts_tpu_torch.utils.smoke import orthogonal_reinit
    from ditto_tts_tpu_torch.utils.weights import load_state_dict

    t_phase = time.perf_counter()
    out = {"card": card}
    tmp = ROOT / ".chip_smoke_tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        tmp.mkdir(parents=True)
        # ---- the synthesize twin: a 10 s prompt, files for BigVGAN (.pth,
        # BigVGAN's names), the DiTTo and NAC checkpoints (.npz) ----
        import wave
        prompt, n_prompt = tmp / "prompt.wav", PROMPT_SECONDS * 24000
        t = np.arange(n_prompt) / 24000
        pcm = 0.3 * np.sin(2 * np.pi * 190 * t) * (1 + 0.5 * np.sin(
            2 * np.pi * 3 * t)) / 1.5
        with wave.open(str(prompt), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(24000)
            f.writeframes((pcm * 32767).astype(np.int16).tobytes())
        files = {k: tmp / n for k, n in (("bigvgan", "bigvgan.pth"),
                                         ("ditto", "DiTTO_final.npz"),
                                         ("nac", "NAC_final.npz"))}
        t0 = time.perf_counter()
        torch.save(vocoder.export_bigvgan_state_dict(params_cpu.vocoder,
                                                   cfg.vocoder),
                   files["bigvgan"])
        # uncompressed (np.savez): the checkpoints' keys, without ~40 s of
        # deflate; load_checkpoint reads either
        np.savez(files["ditto"], **_flatten({"params": params_cpu.dit}))
        np.savez(files["nac"], **_flatten({"params": {
            "embedding_head": params_cpu.embedding_head,
            "vector_quantizer": params_cpu.vector_quantizer}}))
        out["write_files_s"] = time.perf_counter() - t0
        sizes = {k: os.path.getsize(p) for k, p in files.items()}
        imported = vocoder.import_bigvgan_state_dict(
            load_state_dict(str(files["bigvgan"])), cfg.vocoder)
        got, want = list(tree_leaves(imported)), \
            list(tree_leaves(params_cpu.vocoder))
        if [p for p, _ in got] != [p for p, _ in want] or not all(
                torch.equal(a, b) for (_, a), (_, b) in zip(got, want)):
            fail("the imported BigVGAN tree differs from the one written")
        mib = ", ".join(f"{k} {v / 2**20:.0f} MiB" for k, v in sizes.items())
        log(f"  files: {mib} in {out['write_files_s']:.1f} s; the imported "
            "BigVGAN tree "
            f"equals the written one, {len(got)} leaves bit for bit")

        synth_args = ["--audio", str(prompt), "--text", "bonjour, numéro un",
                      "--seed", "3", "--device", dev.type, *SYNTH_ARGS,
                      *(a for k, p in files.items()
                        for a in (f"--{k}", str(p)))]
        wavs, secs = [], []
        for i in range(2):
            stdout, dt = run_cli("synthesize", synth_args + [
                "--out", str(tmp / f"out{i}.wav")])
            if any(f"random {w}" in stdout for w in
                   ("vocoder weights", "DiT weights", "NAC head")):
                fail(f"synthesize: a given file was not loaded:\n{stdout}")
            wavs.append(read_wav(np, tmp / f"out{i}.wav"))
            secs.append(dt)
        (head, pcm0), (_, pcm1) = wavs
        want_len = 256 * (n_prompt // 256)   # whole mel hops, as JAX's chain
        if head != (1, 2, 24000) or len(pcm0) != want_len:
            fail(f"synthesize: WAV {head}, {len(pcm0)} samples; expected "
                 f"(1, 2, 24000), {want_len}")
        if not np.array_equal(pcm0, pcm1):
            fail("synthesize: the same --seed gave different WAVs")
        # finite: write_wav refuses a non-finite waveform, so rc 0 says it
        if pcm0.std() == 0:
            fail("synthesize: a constant WAV")
        log(f"  synthesize CLI ({PROMPT_SECONDS} s prompt, {SYNTH_ARGS}, "
            f"fp32 DiT, --bigvgan/--ditto/--nac): "
            f"{[round(s, 2) for s in secs]} s "
            f"wall; 24 kHz mono int16, {len(pcm0)} samples (the prompt's "
            f"{n_prompt} cut to whole mel hops), peak {np.abs(pcm0).max()}"
            f", rms {pcm0.astype(np.float64).std():.1f}; the second run "
            "bitwise equal")
        out["synthesize_cli_s"] = secs
        out["synthesize_samples"] = len(pcm0)

        # ---- the evaluate twin, as a subprocess ----
        corpus = tmp / "mls"
        write_corpus(np, corpus, opus=False)
        eval_args = ["--data-path", str(corpus), "--batch-size",
                     str(EVAL_BATCH), "--max-batches", str(EVAL_BATCHES),
                     "--s2t", "random", "--ecapa", "random", "--smoke-ortho",
                     "--oracle-ref", "--device", dev.type, "--out",
                     str(tmp / "eval.json"), *EVAL_ARGS]
        stdout, dt = run_cli("evaluate", eval_args)
        res = json.loads((tmp / "eval.json").read_text())
        keys = {"mel_mae_mean", "num_utterances", "cer", "wer", "sim_o",
                "sim_r"}
        vals = [res[k] for k in sorted(keys) if k in res]
        if set(res) != keys or res["num_utterances"] != \
                EVAL_BATCH * EVAL_BATCHES or not all(
                    np.isfinite(v) for v in vals) or \
                res["cer"] < 0 or res["wer"] < 0 or not all(
                    -1 <= res[k] <= 1 for k in ("sim_o", "sim_r")):
            fail(f"evaluate: results {res}")
        log(f"  evaluate CLI ({EVAL_BATCHES} batches of {EVAL_BATCH} from "
            f"the 4-clip corpus, {EVAL_ARGS}, S2T and ECAPA random, "
            f"--smoke-ortho --oracle-ref): {dt:.1f} s wall; {res}")
        out["evaluate_cli_s"] = dt
        out["evaluate_results"] = res

        # ---- the CLI's batches in this process, through its own
        # evaluate_batch: a held pass (the first call of kernels A, B and C
        # at each shape and type against its plain version), then a timed
        # pass; launches and matmul-softmax calls exact in both ----
        args = ev.parse_args(eval_args)
        ecfg = ev.pipeline_config(args)
        p_eval = generator_params(
            args, ecfg, ev.gpt2_config(args), dev,
            smoke=lambda tr: orthogonal_reinit(tr, seed=args.seed))
        tok = gpt2_tokenizer(args)
        ds = mls.MLSDataset(str(corpus), tok, ecfg.dit.max_token_length,
                            tokenizer_name="gpt2",
                            strict_duration=not args.lenient_duration)
        synth = build_synthesize(ecfg, device=dev)
        # the CLI's geometries: s2t-medium and ECAPA unless --*-tiny
        s2t_cfg = ev.tiny_s2t_config() if args.s2t_tiny else \
            s2t.s2t_medium_config()
        e_cfg = ecapa.tiny_ecapa_config() if args.ecapa_tiny else \
            ecapa.ECAPAConfig()
        s2t_p = init_s2t_params(s2t_cfg, args.seed + 5, dev)
        e_p = init_ecapa_params(e_cfg, args.seed + 6, dev)
        bos = S2TTokenizer.placeholder(s2t_cfg.vocab_size).lang_code_to_id[
            "fr"]
        asr = ev.build_asr(s2t_p, s2t_cfg, S2TTokenizer.placeholder(
            s2t_cfg.vocab_size), bos, dev)
        embed = ev.build_embed(e_p, e_cfg, dev)
        buckets = mls.default_buckets(ecfg.audio.sample_rate,
                                      ecfg.audio.min_audio_seconds,
                                      ecfg.audio.max_audio_seconds)
        eval_batches = list(itertools.islice(
            mls.batches(ds, EVAL_BATCH, buckets=buckets, shuffle=False),
            EVAL_BATCHES))
        # per evaluated batch under --oracle-ref with ECAPA: the synthesis
        # (a default request), the oracle render (the codec's encode and
        # decode and BigVGAN: a default request's B and C) and each
        # utterance's codec round trip for SIM-r; two decodes an utterance
        # (the oracle render's transcript and the synthesis's)
        round_trip = 2 * codec_b_launches(ecfg.codec)
        want_launches = {
            "attention": DEFAULT_PATH["attention"],
            "conv1d": 2 * DEFAULT_PATH["conv1d"] + EVAL_BATCH * round_trip,
            "act_conv": 2 * DEFAULT_PATH["act_conv"],
            "snake": 2 * DEFAULT_PATH["snake"],
            "dit_glue": DEFAULT_PATH["dit_glue"]}
        per_decode = greedy_attention_calls(s2t_cfg, ev.ASR_MAX_LEN)
        want_plain = {"decoder": 0, "byt5": 0, "gpt2": 0,
                      "s2t": 2 * EVAL_BATCH * per_decode}
        checks = Checks()
        per_batch, per_utt = [], []
        for held in (True, False):
            for bi, batch in enumerate(eval_batches):
                secs = batch["audio"].shape[-1] / 24000
                gen = torch.Generator(device=dev).manual_seed(args.seed + bi)
                kernels.reset_launches()
                with contextlib.ExitStack() as stack:
                    plain = stack.enter_context(PlainAttentionLog())
                    errs = stack.enter_context(held_to_plain(
                        checks, f"eval {secs:g} s")) if held else None
                    utts, times = ev.evaluate_batch(
                        p_eval, ecfg, synth, batch, gen, dev, tok=tok,
                        asr=asr, embed=embed, oracle_ref=True)
                launches = dict(kernels.launches)
                check_launches(f"evaluated batch {bi}", launches,
                               want_launches, 1)
                if plain.counts != want_plain:
                    fail(f"evaluated batch {bi}: matmul-softmax calls "
                         f"{plain.counts}, expected {want_plain}")
                if not all(np.isfinite(u[k]) for u in utts for k in (
                        "mel_mae", "sim_o", "sim_r")):
                    fail(f"evaluated batch {bi}: a metric not finite: "
                         f"{utts}")
                if held and not errs:
                    fail(f"evaluated batch {bi}: no kernel call was held to "
                         "its plain version")
                if held:
                    per_batch.append({"seconds": secs, "launches": launches,
                                      "held_to_plain": errs})
                    continue
                per_batch[bi]["s"] = times
                per_utt += [{"seconds": secs, "synthesis_s":
                             times["synthesis"] / len(utts),
                             "oracle_s": times["oracle"] / len(utts),
                             **{f"{k}_s": v for k, v in u["s"].items()}}
                            for u in utts]
        for b in per_batch:
            held = {k: e for k, e in b["held_to_plain"].items()
                    if not k.endswith("vs fp64")}
            log(f"  evaluated batch of {EVAL_BATCH} x {b['seconds']:g} s: "
                f"synthesis {b['s']['synthesis']:.3f} s, oracle render "
                f"{b['s']['oracle']:.3f} s; launches {b['launches']} "
                f"(exact), {want_plain['s2t']} matmul-softmax calls (exact)"
                f"; {len(held)} shapes of A, B, C and D held to their plain "
                "versions in the first pass, the largest max_abs_err "
                f"{max(held.values()):.3e}")
        if checks.bad:
            fail("kernels A, B, C and D in the evaluated batches: " +
                 "; ".join(checks.bad))
        for u in per_utt:
            log(f"  utterance {u['seconds']:g} s: synthesis "
                f"{u['synthesis_s']:.3f} and oracle render "
                f"{u['oracle_s']:.3f} (batch / {EVAL_BATCH}), ASR "
                f"{u['asr_s']:.3f} (two decodes), ECAPA {u['ecapa_s']:.4f} "
                f"(three embeddings), codec round trip {u['codec_s']:.4f}, "
                f"mel_mae {u['mel_mae_s']:.4f} s ({card})")
        out["batches"], out["utterances"] = per_batch, per_utt
        out["asr_attention_calls"] = per_decode

        # utils/profiling.py on the card: a span, and the device's kernels
        # in the Chrome trace of one ECAPA embedding
        clip = ds[0]["audio"]
        with trace(str(tmp / "trace")):
            with span("ecapa_embed"):
                embed(clip, len(clip))
        events = json.loads((tmp / "trace" / "trace.json").read_text())[
            "traceEvents"]
        dev_events = [e for e in events if e.get("cat") == "kernel"]
        spans = json.loads((tmp / "trace" / "spans.json").read_text())
        named = any(e.get("name") == "ecapa_embed" for e in events) and \
            [s["name"] for s in spans if s["parent"] is None] == \
            ["ecapa_embed"]
        if not named or (dev.type == "cuda" and not dev_events):
            fail(f"profiling.trace: {len(dev_events)} kernel events, the "
                 f"named range {'present' if named else 'missing'}")
        dev_ms = sum(e.get("dur", 0) for e in dev_events) / 1e3
        log(f"  profiling.trace of one ECAPA embedding: {len(dev_events)} "
            f"kernels, {dev_ms:.3f} ms of device time, the named range "
            "present")
        out["trace"] = {"kernels": len(dev_events), "device_ms": dev_ms}

        # ---- the eval leg, card vs CPU (fp32, TF32 off) ----
        fb = torch.from_numpy(ev._fbank16k(clip, len(clip)))
        ones = torch.ones(fb.shape[:2], dtype=torch.int32)
        cmp, greedy = {}, {}
        # the random s2t-medium repeats its forced BOS at every step (the
        # token embedding rides the residual stream to the tied head), so
        # its ids hold one token; with the token embeddings at a fifth of
        # init_s2t's scale the cross-attention over the encoder moves the
        # argmax, and the ids compare real choices
        moving = dict(s2t_p, embed_tokens={
            "weight": 0.2 * s2t_p["embed_tokens"]["weight"]})
        with torch.inference_mode():
            geom = "s2t-tiny" if args.s2t_tiny else "s2t-medium"
            for name, p_g in ((geom, s2t_p),
                              (f"{geom}, embeddings x 0.2", moving)):
                p_c = tree_map(lambda x: x.cpu(), p_g)
                enc_g = s2t.encode(p_g, s2t_cfg, fb.to(dev), ones.to(dev))
                enc_c = s2t.encode(p_c, s2t_cfg, fb, ones)
                if p_g is s2t_p:
                    cmp["s2t encode"] = rel_err(enc_g[0], enc_c[0])
                got = []

                def decode():
                    got[:] = [s2t.greedy_decode(
                        p_g, s2t_cfg, fb.to(dev), ones.to(dev),
                        forced_bos_id=bos, max_len=ev.ASR_MAX_LEN)]
                    return got[0]

                kernels.reset_launches()
                with PlainAttentionLog() as plain:
                    # eval/throughput.py's fenced timer (one call)
                    t_card = time_fn(decode, iters=1, warmup=0)
                if plain.counts["s2t"] != per_decode or \
                        any(kernels.launches.values()):
                    fail(f"{name} greedy_decode: {plain.counts}, "
                         f"{dict(kernels.launches)}")
                t0 = time.perf_counter()
                ids_c = s2t.greedy_decode(p_c, s2t_cfg, fb, ones,
                                          forced_bos_id=bos,
                                          max_len=ev.ASR_MAX_LEN)
                t_cpu = time.perf_counter() - t0
                lg_c = s2t.decode_logits(p_c, s2t_cfg, ids_c, *enc_c)
                lg_g = s2t.decode_logits(p_g, s2t_cfg, ids_c.to(dev),
                                         *enc_g)
                cmp[f"{name} decode_logits"] = rel_err(lg_g, lg_c)
                steps = s2t.greedy_compared_steps(
                    ids_c, lg_c, EVAL_TOL * lg_c.abs().max().item(),
                    s2t_cfg.eos_token_id)
                ref = ids_c[0, 2:steps]
                greedy[name] = {
                    "card_s": t_card, "cpu_s": t_cpu,
                    "attention_calls": plain.counts["s2t"],
                    "steps_compared": steps,
                    "equal": torch.equal(got[0].cpu()[:, :steps],
                                         ids_c[:, :steps]),
                    "distinct_ids": len(set(ref.tolist())),
                    "changes": int((ref[1:] != ref[:-1]).sum())}
            n = fb.shape[1]
            feats = torch.cat([fb, fb], dim=0)
            emask = torch.ones((2, n), dtype=torch.int32)
            emask[1, int(0.7 * n):] = 0
            e_cpu = tree_map(lambda x: x.cpu(), e_p)
            for label, m in (("ecapa", None), ("ecapa masked", emask)):
                cmp[label] = rel_err(
                    ecapa.ecapa_embed(e_p, e_cfg, feats.to(dev), None if m
                                      is None else m.to(dev)),
                    ecapa.ecapa_embed(e_cpu, e_cfg, feats, m))
        rng = np.random.default_rng(13)
        noisy = (clip + 0.01 * rng.standard_normal(len(clip))).astype(
            np.float32)
        mm_g = mel_mae(clip, noisy, device=dev)
        mm_c = mel_mae(clip, noisy, device="cpu")
        for k, (err, scale) in cmp.items():
            log(f"  {k}: card vs CPU max|err| {err:.3e} (max|CPU| "
                f"{scale:.3e}, tol {EVAL_TOL:g} x max)")
        for name, g in greedy.items():
            log(f"  {name} greedy_decode ({n} fbank frames, max_len "
                f"{ev.ASR_MAX_LEN}): card {g['card_s']:.3f} s ({card}), CPU "
                f"{g['cpu_s']:.1f} s; {g['attention_calls']} matmul-softmax "
                f"calls (exact), no kernel launch; ids compared over "
                f"{g['steps_compared']} of {ev.ASR_MAX_LEN} steps (margin "
                f"rule): {'equal' if g['equal'] else 'DIFFERENT'}; the "
                f"reference holds {g['distinct_ids']} distinct ids, "
                f"{g['changes']} changes")
        log(f"  mel_mae card {mm_g!r}, CPU {mm_c!r}")
        out["card_vs_cpu"] = {k: {"max_abs_err": e, "scale": s}
                              for k, (e, s) in cmp.items()}
        out["card_vs_cpu"]["greedy"] = greedy
        out["card_vs_cpu"]["mel_mae"] = {"card": mm_g, "cpu": mm_c}
        bad = [k for k, (e, s) in cmp.items() if not e <= EVAL_TOL * s]
        moved = greedy[f"{geom}, embeddings x 0.2"]["changes"]
        if bad or not all(g["equal"] for g in greedy.values()) or \
                not moved or not (
                    abs(mm_g - mm_c) <= MEL_MAE_TOL * abs(mm_c)):
            fail(f"eval leg card vs CPU: {bad}, greedy {greedy}, mel_mae "
                 f"{mm_g} vs {mm_c}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 12: {out['phase_s']:.1f} s")
    rec["synthesize_evaluate"] = out
    return dict(per_batch[0]["launches"])


# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# phase 13: data- and tensor-parallel training, two gloo ranks on the card
# --------------------------------------------------------------------------

# the meshes of the two ranks, in the order one world forms them
MESH_CASES = ((1, 2), (2, 1))
MESH_TIMED = 3
# the fp32 mesh step against the one-process step on the same card, max
# |err| / max |one-process| (phase 10's card-vs-CPU bounds: the loss and
# the parameters 1e-5, the moments 1e-4; each all-reduce adds one
# reordered sum)
MESH_TOL = {"loss": 1e-5, "mu": 1e-4, "nu": 1e-4, "params": 1e-5}
EVAL_DISC_ARGS = ["--train-steps", "200", "--asr-steps", "100",
                  "--ecapa-steps", "100", "--seeds", "0", "--max-batches",
                  "1"]


def _launch_ranks(n: int, argv: list, timeout: int, env=None):
    """``argv`` under ``torch.distributed.run`` with ``n`` ranks on this
    machine (a free port on localhost); a failing rank fails the phase."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           str(n), "--master-addr", "localhost", "--master-port", str(port),
           *argv]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout, env=env)
    if proc.returncode != 0:
        fail(f"{n} ranks of {argv}: rc {proc.returncode}\n"
             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout, time.perf_counter() - t0


def mesh_rank(out_dir: str) -> None:
    """One rank of phase 13 (``chip_smoke.py --mesh-rank DIR`` under
    ``torch.distributed.run``): for each mesh of MESH_CASES, one fp32
    full-width DiTTo step (the in-step encode, remat, dropout 0.1, the
    global t, noise and masks from one seed), its launches of A and B on
    this rank, and on rank 0 the same step in one process, compared; under
    (1, 2) also phase 10's bf16 production step, timed, and a collective
    checkpoint of a one-layer state read back into one process. Each rank
    writes DIR/rank<r>.json."""
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    from ditto_tts_tpu_torch import kernels
    from ditto_tts_tpu_torch.config import (CodecConfig, DiTConfig,
                                            GPT2Config, MeshConfig,
                                            NACConfig)
    from ditto_tts_tpu_torch.models.nac import init_nac_trainable
    from ditto_tts_tpu_torch.params import (init_dit_train_state,
                                            init_nac_frozen, ravel_tree,
                                            tree_leaves, tree_map)
    from ditto_tts_tpu_torch.parallel.mesh import (initialize_distributed,
                                                   local_device, make_mesh)
    from ditto_tts_tpu_torch.parallel.sharding import dit_param_specs
    from ditto_tts_tpu_torch.parallel.train_setup import \
        setup_mesh_training
    from ditto_tts_tpu_torch.train.checkpoint import (restore_into,
                                                      save_checkpoint)
    from ditto_tts_tpu_torch.train.steps import build_ditto_train_step

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 is compared
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed("gloo")
    rank = torch.distributed.get_rank()
    dev = local_device("cuda")
    ccfg, gcfg = CodecConfig(), GPT2Config()
    nac = init_nac_frozen(ccfg, gcfg, seed=0, device=dev)
    frozen = {"codec": nac["codec"], "gpt2": {"wte": nac["gpt2"]["wte"]},
              "embedding_head": tree_map(lambda t: t.to(dev),
                                         init_nac_trainable(
                                             NACConfig(), seed=2)[
                                             "embedding_head"])}
    del nac
    rng = np.random.default_rng(1)
    batch = {"audio": torch.from_numpy(0.05 * rng.standard_normal(
                 (TRAIN_BATCH, 1, TRAIN_SAMPLES)).astype(np.float32)),
             "padding_mask": torch.ones((TRAIN_BATCH, TRAIN_SAMPLES),
                                        dtype=torch.int32),
             "text_ids": torch.from_numpy(rng.integers(
                 0, gcfg.vocab_size, (TRAIN_BATCH, 1024)))}
    cfg32 = DiTConfig(num_layers=TRAIN_LAYERS, num_heads=12,
                      remat_blocks=True, compute_dtype="float32")
    out = {"rank": rank, "device": str(dev), "cases": {}}

    def flat(state):
        adam = state["opt_state"][0]
        return [ravel_tree(t)[0] for t in (state["params"], adam["mu"],
                                           adam["nu"])]

    for data, model in MESH_CASES:
        name = f"{data}x{model}"
        res = out["cases"][name] = {}
        mesh = make_mesh(MeshConfig(data=data, model=model))
        full = init_dit_train_state(cfg32, seed=0, flat_opt=False,
                                    device=dev)
        _, step, _ = build_ditto_train_step(
            cfg32, ccfg, gcfg, learning_rate=TRAIN_LR, flat_opt=False,
            device=dev, mesh=mesh)
        state, _, shard_state, shard_batch = setup_mesh_training(
            mesh, full, frozen, dit_param_specs(full["params"], cfg32, model))
        local = shard_batch(batch)
        # an untimed step first: the process's first step pays for cuBLAS,
        # the kernels' loading and gloo's first connections
        step(state, frozen, local, torch.Generator(device=dev).manual_seed(9))
        torch.cuda.synchronize()
        kernels.reset_launches()
        (new, m), dt = sync_time(torch, step, state, frozen, local,
                                 torch.Generator(device=dev).manual_seed(1))
        res["launches"] = dict(kernels.launches)
        res["fp32_step_s"] = dt
        res["loss"] = m["loss"].item()
        res["rows"], res["local_heads"] = local["audio"].shape[0], \
            state["params"]["blocks"][0]["attn"]["in_proj_weight"].shape[
                0] // 3 // cfg32.head_dim
        gathered = shard_state.gather(new)
        del state, new
        if rank == 0:
            # the same step in one process on this card
            _, step1, _ = build_ditto_train_step(
                cfg32, ccfg, gcfg, learning_rate=TRAIN_LR, flat_opt=False,
                device=dev)
            (ref, rm), res["one_process_step_s"] = sync_time(
                torch, step1, full, frozen, batch,
                torch.Generator(device=dev).manual_seed(1))
            got, want = flat(gathered), flat(ref)
            cmp = {"loss": (m["loss"], rm["loss"]),
                   **dict(zip(("params", "mu", "nu"), zip(got, want)))}
            for key, (x, y) in cmp.items():
                res[key] = {"max_abs_err": (x - y).abs().max().item(),
                            "scale": y.abs().max().item(),
                            "tol": MESH_TOL[key]}
            del ref, got, want
        del gathered, full
        torch.cuda.empty_cache()

        if (data, model) == (1, 2):
            # phase 10's production step (bf16 blocks, remat, dropout 0.1,
            # per-leaf AdamW under TP), timed on each rank
            cfg16 = cfg32.replace(compute_dtype="bfloat16")
            _, step16, _ = build_ditto_train_step(
                cfg16, ccfg, gcfg, learning_rate=TRAIN_LR, flat_opt=False,
                device=dev, mesh=mesh)
            full = init_dit_train_state(cfg16, seed=0, flat_opt=False,
                                        device=dev)
            st, _, _, _ = setup_mesh_training(
                mesh, full, frozen, dit_param_specs(full["params"], cfg16,
                                                    model))
            del full
            gen = torch.Generator(device=dev).manual_seed(2)
            st, m = step16(st, frozen, local, gen)
            torch.cuda.synchronize()
            kernels.reset_launches()
            times, losses = [], []
            for _ in range(MESH_TIMED):
                (st, m), dt = sync_time(torch, step16, st, frozen, local, gen)
                times.append(dt)
                losses.append(m["loss"].item())
            res["bf16_launches"] = dict(kernels.launches)
            res["bf16_step_s"], res["bf16_losses"] = times, losses
            del st
            # one model-group all-reduce of a block's activations, as the
            # megatron pair sums them (fp32 [B, S, H]; bf16 ones sum in fp32)
            x = torch.randn((TRAIN_BATCH, TRAIN_SAMPLES // ccfg.hop_length,
                             cfg32.hidden_dim), device=dev)
            mesh.all_reduce(x, "model")
            times = [sync_time(torch, mesh.all_reduce, x, "model")[1]
                     for _ in range(5)]
            res["all_reduce_fp32_activation_s"] = times
            res["all_reduce_bytes"] = x.numel() * 4

            # a collective checkpoint of a one-layer state, read back
            cfg1 = cfg32.replace(num_layers=FIT_LAYERS)
            full = init_dit_train_state(cfg1, seed=3, flat_opt=False,
                                        device=dev)
            st, _, sh1, _ = setup_mesh_training(
                mesh, full, frozen, dit_param_specs(full["params"], cfg1,
                                                    model))
            path = str(Path(out_dir) / "mesh_state.npz")
            (_, res["checkpoint_save_s"]) = sync_time(
                torch, save_checkpoint, path, st, {"epoch": 1}, mesh=mesh,
                specs=sh1.specs)
            back = restore_into(init_dit_train_state(
                cfg1, seed=4, flat_opt=False, device=dev), path)
            res["checkpoint_equal"] = all(
                torch.equal(a, b) for (_, a), (_, b) in zip(
                    tree_leaves(back), tree_leaves(sh1.gather(st))))
            del st, back, full
        torch.cuda.empty_cache()
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def nccl_world1() -> None:
    """``chip_smoke.py --nccl-world1``: NCCL starts on the card at world
    size 1 (init, an all-reduce of a CUDA tensor, teardown)."""
    import socket
    import torch
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    x = torch.arange(4, dtype=torch.float32, device="cuda")
    torch.distributed.all_reduce(x)
    torch.cuda.synchronize()
    ok = x.cpu().tolist() == [0.0, 1.0, 2.0, 3.0]
    torch.distributed.destroy_process_group()
    print(json.dumps({"nccl_version": ".".join(
        map(str, torch.cuda.nccl.version())), "all_reduce_ok": ok}))


def parallel_phase(torch, np, card, rec):
    import shutil
    from ditto_tts_tpu_torch.config import CodecConfig, DiTConfig
    from ditto_tts_tpu_torch.kernel_bench import cuda_ms
    from ditto_tts_tpu_torch.ops.attention import (attention_cuda,
                                                   attention_plain)
    from ditto_tts_tpu_torch.params import init_dit_train_state, tree_leaves
    from ditto_tts_tpu_torch.train.checkpoint import restore_into

    t_phase = time.perf_counter()
    out = {"card": card, "note": "two ranks on one card under gloo: "
           "collectives staged through the host, not NCCL across cards"}
    dcfg = DiTConfig(num_layers=TRAIN_LAYERS, num_heads=12,
                     remat_blocks=True)
    want = train_step_launches(dcfg, CodecConfig(), True)

    # ---- kernel A at a rank's share of the heads, held to plain ----
    checks = Checks()
    gen = torch.Generator(device="cuda").manual_seed(13)
    frames = TRAIN_SAMPLES // CodecConfig().hop_length
    a_err = {}
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn(TRAIN_BATCH, 6, frames, 64, generator=gen,
                               device="cuda").to(dt) for _ in range(3))
        dn = str(dt)[6:]
        a_err[dn] = checks.compare(
            "attention", f"{dn} B{TRAIN_BATCH} H6 S{frames} D64 (TP share)",
            attention_cuda(q, k, v), attention_plain(q, k, v), dn)
        if dt == torch.bfloat16:
            out["a_h6_bf16_ms"] = cuda_ms(
                torch, lambda: attention_cuda(q, k, v))
    # the tiny heads of eval_discrimination (16 wide, padded to 64)
    from ditto_tts_tpu_torch.ops.attention import attention
    q, k, v = (torch.randn(4, 4, 120, 16, generator=gen, device="cuda")
               for _ in range(3))
    a_err["float32 D16 padded"] = checks.compare(
        "attention", "float32 B4 H4 S120 D16 (padded to 64)",
        attention(q, k, v), attention_plain(q, k, v), "float32")
    if checks.bad:
        fail("kernel A at the mesh shapes: " + "; ".join(checks.bad))
    out["a_held_to_plain"] = a_err

    tmp = ROOT / ".chip_smoke_tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        tmp.mkdir(parents=True)
        # ---- the two ranks: (1, 2) then (2, 1) ----
        _, out["ranks_s"] = _launch_ranks(
            2, [str(ROOT / "chip_smoke.py"), "--mesh-rank", str(tmp)], 900)
        ranks = [json.loads((tmp / f"rank{r}.json").read_text())
                 for r in range(2)]
        out["ranks"] = ranks
        launches = {}
        for data, model in MESH_CASES:
            name = f"{data}x{model}"
            per_rank = [r["cases"][name] for r in ranks]
            launches[name] = [c["launches"] for c in per_rank]
            for r, c in enumerate(per_rank):
                if ran(c["launches"]) != ran(want):
                    fail(f"mesh {name} rank {r}: launches {c['launches']} "
                         f"a step, expected {want}")
            ref = per_rank[0]
            log(f"  mesh {name}: each rank {ref['rows']} rows x "
                f"{ref['local_heads']} heads; fp32 step "
                f"{[round(c['fp32_step_s'], 3) for c in per_rank]} s per "
                f"rank (one process {ref['one_process_step_s']:.3f} s); "
                f"launches a step per rank {launches[name]}")
            for key in ("loss", "params", "mu", "nu"):
                e = ref[key]
                ok = e["max_abs_err"] <= e["tol"] * e["scale"]
                log(f"    {key}: max_abs_err {e['max_abs_err']:.3e} (scale "
                    f"{e['scale']:.3e}, tol {e['tol']:g}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"mesh {name}: {key} against one process: {e}")
        tp = [r["cases"]["1x2"] for r in ranks]
        ar_s = tp[0]["all_reduce_fp32_activation_s"]
        for r, c in enumerate(tp):
            if ran(c["bf16_launches"]) != ran({k: v * MESH_TIMED
                                               for k, v in want.items()}):
                fail(f"bf16 mesh step rank {r}: launches {c['bf16_launches']}")
            if not all(np.isfinite(c["bf16_losses"])):
                fail(f"bf16 mesh step rank {r}: losses {c['bf16_losses']}")
        if not tp[0]["checkpoint_equal"]:
            fail("the collective checkpoint read back into one process "
                 "differs from the gathered state")
        log(f"  bf16 production step under (1, 2), gloo on one card: "
            + "; ".join(f"rank {r} {[round(t, 4) for t in c['bf16_step_s']]}"
                        f" s" for r, c in enumerate(tp))
            + f"; one all-reduce of a block's activations "
              f"({tp[0]['all_reduce_bytes'] / 2**20:.1f} MiB fp32) "
              f"{[round(t * 1e3, 2) for t in ar_s]} ms on rank 0"
            + f"; a collective checkpoint ({FIT_LAYERS} layer) saved in "
              f"{tp[0]['checkpoint_save_s']:.1f} s and read back equal "
              f"({card})")
        out["launches_per_rank_step"] = launches

        # ---- train_ditto at --mesh-model 2, then a resume ----
        corpus = tmp / "mls"
        write_corpus(np, corpus, opus=False)
        ckpt = tmp / "ckpt"
        common = ["-m", "ditto_tts_tpu_torch.scripts.train_ditto",
                  "--dist-backend", "gloo", "--mesh-model", "2",
                  "--train-path", str(corpus), "--checkpoint-dir", str(ckpt),
                  "--layers", str(FIT_LAYERS), "--heads", "12",
                  "--batch-size", "2", "--nb-samples", "4"]
        cli = {}
        for epochs in (1, 2):
            stdout, cli[f"epochs_{epochs}_s"] = _launch_ranks(
                2, common + ["--epochs", str(epochs)], 600)
            if "mesh {'data': 1, 'model': 2} (gloo)" not in stdout or (
                    epochs == 2 and "resumed from" not in stdout):
                fail(f"train_ditto --mesh-model 2 --epochs {epochs}:\n"
                     f"{stdout[-3000:]}")
        st = restore_into(init_dit_train_state(
            DiTConfig(num_layers=FIT_LAYERS, num_heads=12), seed=5,
            flat_opt=False), str(ckpt / "DiTTO_epoch_2.npz"))
        final = restore_into(st, str(ckpt / "DiTTO_final.npz"))
        if int(st["step"]) != 4 or not all(
                torch.equal(a, b) for (_, a), (_, b) in zip(
                    tree_leaves(st), tree_leaves(final))):
            fail("train_ditto's mesh checkpoint does not load into one "
                 "process as its final state")
        log(f"  train_ditto --mesh-model 2 (gloo, {FIT_LAYERS} layer, B=2): "
            f"{cli['epochs_1_s']:.1f} s, resumed to epoch 2 in "
            f"{cli['epochs_2_s']:.1f} s; its epoch-2 file loads into one "
            f"process (step {int(st['step'])}) and equals its final file")
        out["cli"] = cli

        # ---- NCCL at world size 1 ----
        proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--nccl-world1"], cwd=ROOT, capture_output=True,
                              text=True, timeout=300)
        nccl = json.loads(proc.stdout.strip().splitlines()[-1]) \
            if proc.returncode == 0 else None
        if not (nccl and nccl["all_reduce_ok"]):
            fail(f"NCCL at world size 1: rc {proc.returncode}\n"
                 f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
        log(f"  NCCL {nccl['nccl_version']}: init, all_reduce and teardown at "
            "world size 1")
        out["nccl"] = nccl

        # ---- the eval_discrimination twin, short ----
        report = tmp / "eval_discrimination.json"
        stdout, out["eval_discrimination_s"] = run_cli(
            "eval_discrimination", EVAL_DISC_ARGS + [
                "--workdir", str(tmp / "disc"), "--out", str(report)], 900)
        rep = json.loads(report.read_text())
        vals = [rep[a][m]["mean"] for a in ("random_weights",
                                            "trained_weights")
                for m in ("mel_mae_mean", "cer", "wer", "sim_o", "sim_r")]
        if not all(np.isfinite(vals)):
            fail(f"eval_discrimination: non-finite metrics {rep}")
        log(f"  eval_discrimination ({' '.join(EVAL_DISC_ARGS)}): "
            f"{out['eval_discrimination_s']:.1f} s, discriminates "
            f"{rep['discriminates']}, margins {rep['margins']}")
        out["eval_discrimination"] = rep
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 13: {out['phase_s']:.1f} s")
    rec["parallel"] = out
    return launches


# --------------------------------------------------------------------------
# phase 14: F5-TTS v1 Base
# --------------------------------------------------------------------------

def f5_phase(torch, np, card, rec) -> dict:
    """One F5 request at the published widths held to the plain versions
    of A, B, C and D, then timed requests; returns the launches of one
    request."""
    from ditto_tts_tpu_torch import kernels
    from ditto_tts_tpu_torch.config import F5PipelineConfig
    from ditto_tts_tpu_torch.infer.generator import build_synthesize_pipelined
    from ditto_tts_tpu_torch.params import F5Params, init_f5_params, \
        tree_map

    cfg = F5PipelineConfig()
    dev = torch.device("cuda")
    batch, ids, steps = 4, 384, cfg.sampler.steps
    n = cfg.total_frames
    p = 10 * cfg.vocoder.sampling_rate // cfg.vocoder.hop_size  # 937
    t0 = time.perf_counter()
    cpu = init_f5_params(cfg, seed=0)
    params = F5Params(**{k: tree_map(lambda a: a.to(dev), getattr(cpu, k))
                         for k in ("dit", "vocoder")})
    del cpu
    log(f"  parameters: {time.perf_counter() - t0:.1f} s; {n} frames, "
        f"{p} of them the prompt's, {steps} steps")
    rng = np.random.default_rng(4)
    audio = torch.from_numpy((0.05 * rng.standard_normal(
        (batch, 1, 10 * cfg.vocoder.sampling_rate))).astype(np.float32))
    text = torch.from_numpy(rng.integers(0, cfg.dit.text_num_embeds,
                                         (batch, ids)))
    serve = build_synthesize_pipelined(cfg)

    def run(seed):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        wav = serve(params, audio, None, text,
                    torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if wav.shape != (batch, (n - p) * cfg.vocoder.hop_size):
            fail(f"F5: waveform {tuple(wav.shape)}, expected "
                 f"{(batch, (n - p) * cfg.vocoder.hop_size)}")
        if not bool(torch.isfinite(wav).all()):
            fail(f"F5 seed {seed}: non-finite waveform")
        return wav, dt, dict(kernels.launches)

    checks = Checks()
    with held_to_plain(checks, "F5") as held, ShapeLog() as shapes:
        wav0, warm, launches = run(5)
    shape_log = shapes.report("F5 25 s")
    if checks.bad:
        fail(f"F5: kernels outside tolerance: {checks.bad}")
    a_key = f"attention bfloat16 B{2 * batch} H16 Sq{n} Sk{n} D64"
    if not any(k.startswith(a_key) for k in held):
        fail(f"F5: kernel A at {a_key} was not held to its plain version: "
             f"{sorted(held)}")
    want = dict(F5_PATH, conv1d=launches.get("conv1d", 0))
    log(f"  launches of the held request: {launches}")
    check_launches("F5 serving path", launches, want, 1)
    if not want["conv1d"]:
        fail("F5: the vocoder launched no kernel B")
    times = []
    for seed in (5, 6):
        wav, dt, got = run(seed)
        check_launches(f"F5 request, seed {seed}", got, want, 1)
        if (seed == 5) != torch.equal(wav, wav0):
            fail(f"F5 seed {seed}: bitwise {'un' if seed == 5 else ''}equal "
                 "to the held request")
        times.append(dt)
    gen_s = batch * (n - p) * cfg.vocoder.hop_size / cfg.vocoder.sampling_rate
    log(f"  B={batch}: waveform {tuple(wav0.shape)}, held request "
        f"{warm:.3f} s, requests {[round(t, 4) for t in times]} s, "
        f"{gen_s / min(times):.2f} generated audio-s/s ({card})")
    rec["f5"] = {"batch": batch, "frames": n, "prompt_frames": p,
                 "held_s": warm, "request_s": times, "held": held,
                 "shapes": shape_log, "launches": launches,
                 "audio_s_per_s": gen_s / min(times)}
    return want


def main() -> None:
    if not (ROOT / "ditto_tts_tpu_torch" / "__init__.py").exists():
        fail("run from the root of a checkout: ditto_tts_tpu_torch/ is "
             "missing")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    # phase 13's own processes
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank(sys.argv[2])
    if sys.argv[1:] == ["--nccl-world1"]:
        return nccl_world1()
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
    # reorder do not; D (an elementwise filter) and E (the DiT's glue)
    # have none
    for name in kernels.KERNELS:
        mma = rec["sass_mma"][name]
        if mma is None:
            fail(f"{name}: no cuobjdump beside nvcc, so the tensor-core "
                 "instructions of the bf16 kernels cannot be checked")
        tc = {fn: n for fn, n in mma.items() if "kernel_tc" in fn}
        elementwise = name in ("snake", "dit_glue")
        if elementwise != (not tc) or not all(tc.values()) or any(
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
    fused_pallas_phase(torch, cfg, params, params_cpu, inputs, mel, rec)

    log('== 7. aa_impl="fused_ncl" on BigVGAN\'s last two stages')
    fused_ncl_phase(torch, np, cfg, params, rec)

    log("== 8. the SLP-driven chain (ByT5-small, SLP, DiT, codec, BigVGAN)")
    slp = slp_phase(torch, np, cfg, params, params_cpu, rec)

    log("== 9. DDIM (eta 0): serving, build_synthesize, card vs CPU")
    ddim_phase(torch, np, cfg, params, params_cpu, inputs, slp, rec)

    log("== 10. DiTTo training at full width (kernel A forward, recompute "
        "and eval; B in the frozen encode)")
    train_launches = train_phase(torch, np, params, params_cpu, card, rec)

    log("== 11. NAC and SLP training, the data layer and the training CLIs")
    corpus_launches = corpus_phase(torch, np, params, params_cpu,
                                   slp[1].byt5, card, rec)

    log("== 12. synthesize and evaluate (the CLI twins, S2T-medium, ECAPA, "
        "the metrics)")
    eval_launches = eval_phase(torch, np, cfg, params_cpu,
                               torch.device("cuda"), card, rec)

    log("== 13. parallel training: two gloo ranks on the card, (1, 2) and "
        "(2, 1) against one process, train_ditto --mesh-model 2, NCCL at "
        "world size 1, eval_discrimination")
    mesh_launches = parallel_phase(torch, np, card, rec)

    log("== 14. F5-TTS v1 Base (22 x 1024, 2,343 frames, 32 guided steps, "
        "BigVGAN)")
    f5_launches = f5_phase(torch, np, card, rec)

    # launches per 10 s request (f5: per 25 s F5 request of phase 14;
    # fused_ncl: per forward of its two stages;
    # train_step: per step of phase 10's audio leg; nac_step, slp_step: per
    # step of phase 11; eval_batch: per evaluated batch of phase 12)
    paths = {"default": DEFAULT_PATH, "fused_pallas": FUSED_PALLAS_PATH,
             "fused_ncl": FUSED_NCL_PATH, "slp": DEFAULT_PATH,
             "ddim": DEFAULT_PATH, "f5": f5_launches,
             "train_step": train_launches,
             **corpus_launches, "eval_batch": eval_launches,
             **{f"mesh_{m}_rank{r}_step": c
                for m, cs in mesh_launches.items()
                for r, c in enumerate(cs)}}
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
                 "fused_snake_nlc (#9) + the XLA-fused ops/snake.py:83 "
                 "polyphase_anti_aliased_activation (no Pallas kernel)",
        "dit_glue": "no Pallas kernel: the XLA-fused elementwise ops of "
                    "ditto_tts_tpu/models/dit.py dit_block (layer norms, "
                    "biases, RoPE, residuals, the gated MLP's GELU)"}
    # each kernel's count from the default serving phase (5 requests)
    counted = launches
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
