"""Kernels A, B, C and D at every bf16 shape of the serving paths, and E
at the DiT's shapes in bf16 and fp32, on the card.

    python -m ditto_tts_tpu_torch.kernel_bench [--json FILE]

For each shape of ``ATTN_SHAPES``, ``CONV_SHAPES``, ``ACT_CONV_SHAPES`` and
``SNAKE_SHAPES`` (the 10 s / 20 s buckets at B=4): the kernel's ms (device
time of a replayed CUDA graph, warm L2), the ms of one PyTorch call that
computes the same function where there is one
(``scaled_dot_product_attention``; ``F.conv1d`` in bf16), used nowhere in
the port, the bound (the larger of the bytes over 3.35 TB/s and the
operations over 989 TFLOP/s, or 67 TFLOP/s for D's fp32 arithmetic) and
max |kernel - plain| / max |plain|. Kernel C has no such library call; its
rows carry instead the port's own two-pass composition of the same
function (kernel D with fp32 taps -> zero pad -> kernel B, plus the
residual) and ``F.conv1d`` on the activated, padded signal alone.

It calls only the wrappers' public names (``attention_cuda``,
``conv1d_cuda``, ``aa_snake_conv1d_cuda``, ``fused_snake_cuda``,
``polyphase_snake_cuda`` and their plain versions), so a copy of this file in an older checkout's package
times that checkout's kernels: two versions are compared in one call on one
card by running both, in turns. ``chip_smoke.py`` phase 3 runs the A and B
shapes through ``run_attention`` and ``run_conv``. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

PEAK_BF16 = 989e12        # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_FP32 = 67e12         # H100 SXM fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bytes/s

ATTN_SHAPES = (   # (label, B, H, Sq, Sk, D): the DiT's calls at B=4
    ("self 10 s", 4, 12, 750, 750, 64),
    ("self 20 s", 4, 12, 1024, 1024, 64),
    ("cross 10 s", 4, 12, 750, 64, 64),
    ("cross 20 s", 4, 12, 1024, 64, 64),
)

# (label, B, C, T_out, O, K, dil): BigVGAN's bf16 convs in one 10 s request
# at B=4 (937 mel frames), as chip_smoke.py's shape log of phase 4 counts
# them, the "fp" rows only under aa_impl="fused_pallas"; "#4" is the
# whole-batch conv at its docstring's codec geometry in bf16
CONV_SHAPES = (
    ("conv_pre", 4, 100, 937, 1536, 7, 1),
    ("up0 poly", 4, 1536, 938, 3072, 2, 1),
    ("up1 poly", 4, 768, 3749, 1536, 2, 1),
    ("up2 poly", 4, 384, 14993, 384, 2, 1),
    ("up3 poly", 4, 192, 29985, 192, 2, 1),
    ("up4 poly", 4, 96, 59969, 96, 2, 1),
    ("up5 poly", 4, 48, 119937, 48, 2, 1),
    ("amp768 k3 d1", 4, 768, 3748, 768, 3, 1),
    ("amp768 k7 d1", 4, 768, 3748, 768, 7, 1),
    ("amp768 k11 d1", 4, 768, 3748, 768, 11, 1),
    ("amp768 k11 d5", 4, 768, 3748, 768, 11, 5),
    ("amp48 k3 d1", 4, 48, 119936, 48, 3, 1),
    ("amp48 k7 d1", 4, 48, 119936, 48, 7, 1),
    ("amp48 k11 d5", 4, 48, 119936, 48, 11, 5),
    ("amp24 k3 d1", 4, 24, 239872, 24, 3, 1),
    ("amp24 k7 d1", 4, 24, 239872, 24, 7, 1),
    ("amp24 k11 d5", 4, 24, 239872, 24, 11, 5),
    ("conv_post", 4, 24, 239872, 1, 7, 1),
    ("fp amp384 k3 d1", 4, 384, 14992, 384, 3, 1),
    ("fp amp384 k11 d5", 4, 384, 14992, 384, 11, 5),
    ("fp amp192 k11 d5", 4, 192, 29984, 192, 11, 5),
    ("fp amp96 k11 d5", 4, 96, 59968, 96, 11, 5),
    ("#4 bf16", 8, 32, 240000, 32, 3, 1),
)

# (label, B, C, T, K, dil, residual): kernel C (C = O) on the default path's
# NLC stages of one 10 s request at B=4 (per width and K: dil 1 four times,
# dil 3 and 5 once each), and on phase 7's aa_impl="fused_ncl" stages (48 x
# 120064, 24 x 240128), where the dil-1 convs carry the residual
ACT_CONV_SHAPES = tuple(
    (f"amp{c} k{k} d{d}", 4, c, t, k, d, False)
    for c, t in ((384, 14992), (192, 29984), (96, 59968))
    for k in (3, 7, 11) for d in (1, 5)) + tuple(
    (f"ncl{c} k{k} d{d}" + (" +res" if d == 1 else ""), 4, c, t, k, d,
     d == 1)
    for c, t in ((48, 120064), (24, 240128))
    for k in (3, 7, 11) for d in (1, 5))

# (label, B, C, T, up_x): kernel D under aa_impl="fused_pallas", one 10 s
# request at B=4: #9 (fp32 upsample taps) on the NLC stages, #8 (taps in
# x's type) on the NCL-hybrid ones; 18 launches at each shape
# (label, B, C, T, up_x): kernel D in a Pallas mode (up_x: taps in x's
# type) under aa_impl="fused_pallas", or (up_x None) in its polyphase mode
# with sin2, the default path's standalone activations
SNAKE_SHAPES = (
    ("#9 768", 4, 768, 3748, False),
    ("#9 384", 4, 384, 14992, False),
    ("#9 192", 4, 192, 29984, False),
    ("#9 96", 4, 96, 59968, False),
    ("#8 48", 4, 48, 119936, True),
    ("#8 24", 4, 24, 239872, True),
    ("polyphase 768", 4, 768, 3748, None),
    ("polyphase 48", 4, 48, 119936, None),
    ("polyphase 24", 4, 24, 239872, None),
)


def eager_ms(torch, fn, target_ms: float = 30.0) -> float:
    """Mean ms of ``fn`` over enough back-to-back calls to fill about
    ``target_ms`` (at least 5), after a warm-up, by CUDA events: the
    device's time, or the host's where each call's launch cost is longer."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(3):
        fn()
    e1.record()
    torch.cuda.synchronize()
    est = max(e0.elapsed_time(e1) / 3, 1e-3)
    iters = int(min(max(target_ms / est, 5), 500))
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def cuda_ms(torch, fn, target_ms: float = 30.0) -> float:
    """Device ms per call of ``fn``: about ``target_ms`` of calls (5 to
    200) captured once in a CUDA graph, the graph replayed 3 times between
    CUDA events, so the host's cost of a launch is not counted."""
    n = int(min(max(target_ms / eager_ms(torch, fn, 5.0), 5), 200))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(3):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (3 * n)


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16) -> tuple:
    """The least time for the work on the card and what bounds it: the
    operations at ``peak`` FLOP/s or the bytes at the memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _rel_err(torch, got, want) -> tuple:
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = max(want.float().abs().max().item(), 1e-30)
    return err, err / scale


def _row(torch, label, shape, fn, library, flops, nb, err, rel,
         peak=PEAK_BF16):
    """One shape: the kernel's and the library call's (None: there is
    none) device ms (CUDA graph), the kernel's ms per eager call (with the
    host's launch cost), the bound, the error."""
    ms = cuda_ms(torch, fn)
    b, by = bound_ms(flops, nb, peak)
    return {"label": label, "shape": shape, "ms": ms,
            "call_ms": eager_ms(torch, fn),
            "library_ms": None if library is None
            else cuda_ms(torch, library), "bound_ms": b,
            "bound_by": by, "tflops": flops / ms / 1e9, "max_abs_err": err,
            "rel_err": rel}


def _snake_coeffs(torch, gen, c):
    """Per-channel (a, inv_b) of a SnakeBeta with alpha, beta ~ 0.3 N(0, 1)
    (the range ``snake_coeffs`` gives the vocoder's parameters)."""
    a = torch.exp(0.3 * torch.randn(c, generator=gen, device="cuda"))
    inv_b = 1.0 / (torch.exp(0.3 * torch.randn(c, generator=gen,
                                               device="cuda")) + 1e-9)
    return a, inv_b


def run_attention(torch, gen, compare=None):
    """Rows for ATTN_SHAPES in bf16; ``compare(label, got, want)`` checks
    each result (chip_smoke's tolerance), else the error is only kept."""
    import torch.nn.functional as F
    from .ops import attention as A
    rows = []
    for label, b, h, sq, sk, d in ATTN_SHAPES:
        q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda")
                   .bfloat16() for s in (sq, sk, sk))
        got = A.attention_cuda(q, k, v)
        want = A.attention_plain(q, k, v)
        err, rel = _rel_err(torch, got, want)
        if compare is not None:
            compare(f"{label} B{b} H{h} Sq{sq} Sk{sk} D{d}", got, want)
        shape = f"bf16 B={b} H={h} Sq={sq} Sk={sk} D={d} ({label})"
        rows.append(_row(torch, label, shape,
                         lambda: A.attention_cuda(q, k, v),
                         lambda: F.scaled_dot_product_attention(q, k, v),
                         4.0 * b * h * sq * sk * d, _nbytes(q, k, v, got),
                         err, rel))
    return rows


def run_conv(torch, gen, compare=None):
    """Rows for CONV_SHAPES in bf16, as ``run_attention``."""
    import torch.nn.functional as F
    from .ops import conv as B
    rows = []
    for label, b, c, t_out, o, k, dil in CONV_SHAPES:
        x = torch.randn(b, c, t_out + (k - 1) * dil, generator=gen,
                        device="cuda").bfloat16()
        w = ((c * k) ** -0.5 * torch.randn(o, c, k, generator=gen,
                                           device="cuda")).bfloat16()
        bias = torch.randn(o, generator=gen, device="cuda")
        got = B.conv1d_cuda(x, w, bias, dilation=dil)
        want = B.conv1d_plain(x, w, bias, dilation=dil)
        if compare is not None:
            compare(f"{label} B{b} C{c} T{t_out} O{o} K{k} dil{dil}", got,
                    want)
        err, rel = _rel_err(torch, got, want)
        del want
        bias16 = bias.bfloat16()
        shape = (f"bf16 B={b} C={c} O={o} K={k} dil={dil} T={t_out} "
                 f"({label})")
        rows.append(_row(torch, label, shape,
                         lambda: B.conv1d_cuda(x, w, bias, dilation=dil),
                         lambda: F.conv1d(x, w, bias16, dilation=dil),
                         2.0 * b * o * c * k * t_out,
                         _nbytes(x, w, bias, got), err, rel))
    return rows


def run_act_conv(torch, gen, compare=None):
    """Rows for ACT_CONV_SHAPES in bf16, as ``run_conv``, each with
    ``two_pass_ms`` (kernel D in #9 mode, whose output in x's type is C's
    rounding of the activation, -> zero pad -> kernel B -> + residual) and
    ``conv_on_z_ms`` (``F.conv1d`` on that padded activation)."""
    import torch.nn.functional as F
    from .ops import act_conv as C, conv as B, snake_fused as D
    rows = []
    for label, b, c, t, k, dil, residual in ACT_CONV_SHAPES:
        x = (2.0 * torch.randn(b, c, t, generator=gen,
                               device="cuda")).bfloat16()
        a, inv_b = _snake_coeffs(torch, gen, c)
        w = ((c * k) ** -0.5 * torch.randn(c, c, k, generator=gen,
                                           device="cuda")).bfloat16()
        bias = torch.randn(c, generator=gen, device="cuda")
        res = torch.randn(b, c, t, generator=gen, device="cuda").bfloat16() \
            if residual else None
        got = C.aa_snake_conv1d_cuda(x, a, inv_b, w, bias, dilation=dil,
                                     residual=res)
        want = C.aa_snake_conv1d_plain(x, a, inv_b, w, bias, dilation=dil,
                                       residual=res)
        if compare is not None:
            compare(f"{label} B{b} C=O={c} T{t} K{k} dil{dil}", got, want)
        err, rel = _rel_err(torch, got, want)
        del want
        ca = (k - 1) * dil // 2

        def two_pass():
            z = D.fused_snake_cuda(x, a, inv_b, up_in_x_dtype=False)
            y = B.conv1d_cuda(F.pad(z, (ca, ca)), w, bias, dilation=dil)
            return y if res is None else y + res

        zp = F.pad(D.fused_snake_cuda(x, a, inv_b, up_in_x_dtype=False),
                   (ca, ca))
        bias16 = bias.bfloat16()
        shape = (f"bf16 B={b} C=O={c} K={k} dil={dil} T={t}"
                 + (" +residual" if residual else "") + f" ({label})")
        row = _row(torch, label, shape,
                   lambda: C.aa_snake_conv1d_cuda(x, a, inv_b, w, bias,
                                                  dilation=dil, residual=res),
                   None, 2.0 * b * c * c * k * t + 56.0 * b * c * t,
                   _nbytes(x, a, inv_b, w, bias, res, got), err, rel)
        row["two_pass_ms"] = cuda_ms(torch, two_pass)
        row["conv_on_z_ms"] = cuda_ms(
            torch, lambda: F.conv1d(zp, w, bias16, dilation=dil))
        rows.append(row)
        del x, zp, res, got
    return rows


def run_snake(torch, gen, compare=None):
    """Rows for SNAKE_SHAPES in bf16 on the [B, C, T] carry, as
    ``run_conv``; no library call computes the function."""
    from .ops import snake_fused as D
    rows = []
    for label, b, c, t, up_x in SNAKE_SHAPES:
        x = (2.0 * torch.randn(b, c, t, generator=gen,
                               device="cuda")).bfloat16()
        a, inv_b = _snake_coeffs(torch, gen, c)
        if up_x is None:
            def kernel():
                return D.polyphase_snake_cuda(x, a, inv_b, fast=True)
            want = D.polyphase_snake_plain(x, a, inv_b, fast=True)
        else:
            def kernel():
                return D.fused_snake_cuda(x, a, inv_b, up_in_x_dtype=up_x)
            want = D.fused_snake_plain(x, a, inv_b, up_in_x_dtype=up_x)
        got = kernel()
        if compare is not None:
            compare(f"{label} B{b} C{c} T{t}", got, want)
        err, rel = _rel_err(torch, got, want)
        del want
        rows.append(_row(torch, label, f"bf16 B={b} C={c} T={t} ({label})",
                         kernel, None, 55.0 * x.numel(),
                         _nbytes(x, a, inv_b, got), err, rel, PEAK_FP32))
    return rows


# (label, dtype name, B, S, hidden, heads, ff): kernel E at the DiT's shapes
# in the B=8 serving cells (ditto-base, bf16; ditto-ref, fp32, one head)
GLUE_SHAPES = (
    ("base", "bfloat16", 8, 750, 768, 12, 3072),
    ("ref", "float32", 8, 750, 768, 1, 3072),
)


def run_dit_glue(torch, gen, compare=None):
    """Rows for each mode of kernel E at GLUE_SHAPES, as ``run_conv``, each
    with ``plain_ms``: the eager ops it replaces, also replayed from a CUDA
    graph. Bound by bytes: each operand read once, each output written
    once."""
    from .ops import dit_glue as E
    from .ops.rope import rope_tables
    rows = []
    for label, dn, b, s, h, nh, ff in GLUE_SHAPES:
        dt = getattr(torch, dn)

        def rn(*shape, scale=1.0):
            return (scale * torch.randn(*shape, generator=gen,
                                        device="cuda")).to(dt)

        y, res, bias = rn(b, s, h), rn(b, s, h, scale=2.0), rn(h)
        norm = {"weight": (1.0 + 0.2 * torch.randn(
            h, generator=gen, device="cuda")).to(dt), "bias": rn(h)}
        qkv, qb = rn(b, s, 3 * h, scale=2.0), rn(3 * h)
        cos, sin = rope_tables(s, h // nh, dtype=dt, device="cuda")
        a, g, ba, bg = rn(b, s, ff), rn(b, s, ff), rn(ff), rn(ff)
        modes = (
            ("add_norm", lambda: E.add_norm_cuda(y, bias, res, norm),
             lambda: E.add_norm_plain(y, bias, res, norm),
             (y, res, bias, *norm.values()), 2 * y.numel()),
            ("qkv_rope", lambda: E.qkv_rope_cuda(qkv, qb, nh, cos, sin),
             lambda: E.qkv_rope_plain(qkv, qb, nh, cos, sin),
             (qkv, qb, cos, sin), qkv.numel()),
            ("bias_heads", lambda: E.bias_heads_cuda(y, bias, nh),
             lambda: E.bias_heads_plain(y, bias, nh), (y, bias), y.numel()),
            ("gelu_gate", lambda: E.gelu_gate_cuda(a, ba, g, bg),
             lambda: E.gelu_gate_plain(a, ba, g, bg), (a, g, ba, bg),
             a.numel()))
        for mode, kernel, plain, ins, n_out in modes:
            got, want = kernel(), plain()
            got = got[-1] if isinstance(got, tuple) else got
            want = want[-1] if isinstance(want, tuple) else want
            if compare is not None:
                compare(f"{mode} {label} B{b} S{s} H{h}", got, want)
            err, rel = _rel_err(torch, got, want)
            shape = f"{dn} B={b} S={s} H={h} heads={nh} ff={ff} ({mode})"
            row = _row(torch, f"{mode} {label}", shape, kernel, None, 0.0,
                       _nbytes(*ins) + n_out * y.element_size(), err, rel)
            row["plain_ms"] = cuda_ms(torch, plain)
            rows.append(row)
    return rows


RUNS = {"attention": run_attention, "conv1d": run_conv,
        "act_conv": run_act_conv, "snake": run_snake,
        "dit_glue": run_dit_glue}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None, help="write the rows here")
    ap.add_argument("--kernels", default=",".join(RUNS),
                    help="comma-separated subset of " + ", ".join(RUNS))
    args = ap.parse_args(argv)
    kinds = args.kernels.split(",")
    if not set(kinds) <= set(RUNS):
        ap.error(f"--kernels: choose from {', '.join(RUNS)}")
    import torch
    from . import kernels
    if not torch.cuda.is_available():
        print("kernel_bench needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kernels.build()
    for name in kinds:
        mma = kernels.sass_mma_counts(name)
        for fn, regs, st, ld in kernels.ptxas_report(name):
            print(f"[{name}] {fn[:100]}: {regs} registers, spill {st}/{ld} "
                  f"B, HMMA {None if mma is None else mma.get(fn)}")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    big = torch.empty(4 * 24 * 239878, dtype=torch.bfloat16, device="cuda")
    dst = torch.empty_like(big)
    copy_ms = cuda_ms(torch, lambda: dst.copy_(big))
    del big, dst
    out = {"card": card, "torch": torch.__version__,
           "copy_46MB": {"ms": copy_ms,
                         "GB_per_s": 2 * 4 * 24 * 239878 * 2 / copy_ms / 1e6}}
    print(card)
    print(f"device copy of 46 MB (the narrow stages' x): {copy_ms:.4f} ms, "
          f"{out['copy_46MB']['GB_per_s']:.0f} GB/s read + written")
    for kind in kinds:
        out[kind] = RUNS[kind](torch, gen)
        for r in out[kind]:
            lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            extra = "".join(f"  {k[:-3]} {r[k]:.4f}" for k in
                            ("two_pass_ms", "conv_on_z_ms", "plain_ms")
                            if k in r)
            print(f"{kind:9s} {r['label']:18s} {r['ms']:9.4f} ms (eager "
                  f"{r['call_ms']:.4f})  library {lib:>8s}{extra}  bound "
                  f"{r['bound_ms']:.4f} ({r['bound_by']})  "
                  f"{r['tflops']:7.1f} TFLOP/s  rel err {r['rel_err']:.2e}",
                  flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
