"""Where a serving request's time goes on the card: one full-width request
under ``torch.profiler``, device time summed by kernel.

    python -m ditto_tts_tpu_torch.profile_serving [--seconds 10] [--batch 4]

Runs the configuration of ``config.serving_config`` with random weights
(numpy seed 0), warms up once, then profiles one request. Prints the card
(name and power limit), the request's wall seconds, the summed device
kernel time and its share of the wall time (the device's busy share), and
the kernels in groups (the port's kernels A/B/C, GEMMs, the codec LSTM,
other library kernels) and by name; with DITTO_RECORD_DIR set, writes
the same as JSON to $DITTO_RECORD_DIR/profile_serving_<seconds>s.json.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

GROUPS = (   # (group, substrings of a kernel name), first match wins
    ("A attention", ("attn_kernel",)),
    ("B conv1d", ("conv1d_kernel",)),
    ("C act_conv", ("act_conv_kernel",)),
    ("gemm", ("gemm", "xmma", "cutlass", "cublas", "sm90_")),
    ("lstm", ("LSTM", "lstm", "RNN", "rnn")),
    ("conv (cuDNN)", ("conv", "Conv", "implicit", "cudnn")),
)


def _group(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "elementwise / other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .config import serving_config
    from .infer.generator import build_synthesize_pipelined
    from .params import init_generator_params

    if not torch.cuda.is_available():
        print("profile_serving needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = serving_config()
    params = init_generator_params(cfg, seed=0).to("cuda")
    serve = build_synthesize_pipelined(cfg)
    n = 24000 * args.seconds
    rng = np.random.default_rng(1)
    audio = torch.from_numpy((0.05 * rng.standard_normal(
        (args.batch, 1, n))).astype(np.float32)).cuda()
    mask = torch.ones((args.batch, n), dtype=torch.int32, device="cuda")
    text = torch.from_numpy(rng.integers(0, 50257, (args.batch, 64))).cuda()

    def request():
        g = torch.Generator(device="cuda").manual_seed(7)
        serve(params, audio, mask, text, g)
        torch.cuda.synchronize()

    request()                                    # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        request()
        wall = time.perf_counter() - t0

    by_name = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            prev_us, prev_n = by_name.get(e.key, (0.0, 0))
            by_name[e.key] = (prev_us + us, prev_n + e.count)
    busy = sum(us for us, _ in by_name.values()) / 1e6
    if busy == 0:
        print("the profiler saw no device time: device shares not measured",
              file=sys.stderr)
        return 1
    groups = {}
    for name, (us, cnt) in by_name.items():
        g = groups.setdefault(_group(name), [0.0, 0])
        g[0] += us / 1e6
        g[1] += cnt
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]
    out = {"card": card, "seconds": args.seconds, "batch": args.batch,
           "wall_s": wall, "device_busy_s": busy, "busy_share": busy / wall,
           "groups": {k: {"s": v[0], "launches": v[1]}
                      for k, v in sorted(groups.items(),
                                         key=lambda kv: -kv[1][0])},
           "top_kernels": [{"name": k[:120], "s": v[0] / 1e6, "launches": v[1]}
                           for k, v in top]}
    print(card)
    print(f"{args.seconds} s bucket, B={args.batch}: wall {wall:.4f} s, "
          f"device busy {busy:.4f} s ({100 * busy / wall:.1f}%)")
    for k, v in out["groups"].items():
        print(f"  {k:22s} {v['s']:.4f} s  {v['launches']:6d} launches")
    for row in out["top_kernels"]:
        print(f"  {row['s']:.4f} s {row['launches']:6d}x  {row['name']}")
    if os.environ.get("DITTO_RECORD_DIR"):
        out_dir = Path(os.environ["DITTO_RECORD_DIR"])
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"profile_serving_{args.seconds}s.json").write_text(
            json.dumps(out, indent=1))
    print(json.dumps({k: out[k] for k in ("wall_s", "device_busy_s",
                                          "busy_share")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
