"""The DiTTo training step, closed loop: each step takes a batch made on
the host (as the training CLI's loader yields it), runs the program's
``build_ditto_train_step(...).step_fn`` on it, and reads the loss back
before the next step.

A batch is ``batch`` rows of ``audio_seconds`` of 0.05 x N(0, 1) audio
(every sample valid) and ``text_ids`` GPT2 ids (uniform over the
vocabulary), drawn from the seed on the host; ``pool`` distinct batches
are sent in turn. One generator on the card, seeded from the run's seed,
draws every step's t, noise and dropout masks.

Set-up builds one training state and drives it through its first
``check_steps`` steps on distinct batches, which warms every shape; the
window goes on from that state. The comparison follows those first steps
with the plain reference (``reference.train``).

Mix parameters: batch, audio_seconds, text_ids, pool, check_steps,
trace_steps.
"""

from __future__ import annotations

import time

from .. import core


def _cfgs(cell):
    from ditto_tts_tpu_torch.config import CodecConfig, DiTConfig, GPT2Config
    pipe, tr = cell.config["pipeline"], cell.config["train"]
    dit = dict(pipe["dit"], remat_blocks=tr["remat_blocks"],
               remat_policy=tr["remat_policy"],
               cross_attn_dropout=tr["cross_attn_dropout"],
               attn_dropout_mode=tr["attn_dropout_mode"])
    codec = dict(pipe["codec"], ratios=tuple(pipe["codec"]["ratios"]))
    return DiTConfig(**dit), CodecConfig(**codec), GPT2Config(
        **cell.config["gpt2"])


def setup(run):
    import numpy as np
    import torch
    from ditto_tts_tpu_torch.config import PipelineConfig
    from ditto_tts_tpu_torch.params import generator_spec, ravel_tree
    from ditto_tts_tpu_torch.train.steps import build_ditto_train_step
    import json

    cell, dev, mix = run.cell, run.device, run.cell.mix
    tr = cell.config["train"]
    dcfg, ccfg, gcfg = _cfgs(cell)
    spec = generator_spec(PipelineConfig.from_json(
        json.dumps(cell.config["pipeline"])))
    spec = {"dit": spec["dit"], "codec": spec["codec"],
            "gpt2": {"wte": spec["gpt2"]["wte"]},
            "embedding_head": spec["embedding_head"]}
    tree = core.draw_spec(torch, spec, core.subseed(run.seed, "weights"), dev)
    run.frozen = {k: tree[k] for k in ("codec", "gpt2", "embedding_head")}
    init_state, step_fn, _ = build_ditto_train_step(
        dcfg, ccfg, gcfg, learning_rate=tr["learning_rate"],
        weight_decay=tr["weight_decay"], encode_dtype=tr["encode_dtype"],
        flat_opt=tr["flat_opt"], device=dev)
    run.step_fn = step_fn
    rng = np.random.default_rng(core.subseed(run.seed, "batches"))
    b = mix["batch"]
    samples = int(mix["audio_seconds"] * ccfg.sample_rate)
    run.batches = [{
        "audio": (0.05 * rng.standard_normal((b, 1, samples))).astype(
            np.float32),
        "padding_mask": np.ones((b, samples), np.int32),
        "text_ids": rng.integers(0, gcfg.vocab_size, (b, mix["text_ids"]))}
        for _ in range(mix["pool"])]
    run.gen_seed = core.subseed(run.seed, "draws")
    run.gen = torch.Generator(device=dev).manual_seed(run.gen_seed)
    # the reference starts from its own copy of the drawn weights
    run.params0 = _clone(tree["dit"])
    state = init_state(tree["dit"])
    run.losses = []
    for i in range(mix["check_steps"]):
        state, m = step_fn(state, run.frozen, run.batches[i], run.gen)
        run.losses.append(float(m["loss"]))
        if i == 0:   # the first gradient, from Adam's first moment
            run.grad1 = (state["opt_state"][0]["mu"] / 0.1).clone()
    run.params3 = ravel_tree(state["params"])[0].clone()
    run.state = state
    run.steps_done = mix["check_steps"]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.detach().clone()


def _step(run):
    batch = run.batches[run.steps_done % len(run.batches)]
    run.state, m = run.step_fn(run.state, run.frozen, batch, run.gen)
    run.steps_done += 1
    return float(m["loss"])


def _record(run, steps: int, wall: float):
    mix = run.cell.mix
    run.window = {"requests": steps, "wall_s": wall,
                  "audio_s": steps * mix["batch"] * mix["audio_seconds"]}


def window(run, seconds: float):
    """Steps back to back until ``seconds`` have passed."""
    n, t0 = 0, time.perf_counter()
    while True:
        _step(run)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _record(run, n, time.perf_counter() - t0)


def traced(run, profile):
    """``trace_steps`` steps timed, then as many under the profiler."""
    n = run.cell.mix["trace_steps"]
    t0 = time.perf_counter()
    for _ in range(n):
        _step(run)
    _record(run, n, time.perf_counter() - t0)
    run.trace_requests = n
    run.trace = profile(lambda: [_step(run) for _ in range(n)])


def check(run, checks):
    """The first steps against the reference: each step's loss, the first
    gradient by leaf norm, and each leaf's change over the steps by norm
    (leaves whose reference gradient is under a thousandth of the median
    leaf's are left out of the change)."""
    import torch
    from ditto_tts_tpu_torch.params import tree_leaves
    mix = run.cell.mix
    shapes = [(k, v.shape) for k, v in tree_leaves(run.params0)]

    def split(flat):
        out, at = {}, 0
        for k, s in shapes:
            n = s.numel()
            out[k] = flat[at:at + n].view(s)
            at += n
        return out

    judged = (run.losses, split(run.grad1), split(run.params3))
    run.state = None
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    for k, v in _judge(run, judged).items():
        checks.add(k, v)
    return mix["check_steps"]


def _reference_steps(run, prec):
    import torch
    from ..reference import train as ref
    dev = run.device
    batches = [{k: torch.as_tensor(v).to(dev) for k, v in b.items()}
               for b in run.batches[:run.cell.mix["check_steps"]]]
    gen = torch.Generator(device=dev).manual_seed(run.gen_seed)
    return ref.steps(run.params0, run.frozen, run.cell.config, batches, gen,
                     prec)


def _judge(run, judged) -> dict:
    """(losses, first gradient, params after the steps), by leaf path,
    against the fp32 reference's."""
    from ..reference import train as ref
    losses, grad1, params3 = judged
    want_losses, first, final = _reference_steps(
        run, {k: "float32" for k in run.cell.config["precision"]})
    p0 = dict(ref.leaves(run.params0))
    norms = {k: float(v.double().norm()) for k, v in first.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return {
        "loss_rel": max(abs(a - b) / abs(b)
                        for a, b in zip(losses, want_losses)),
        "grad_gap": ref.worst_leaf_gap(grad1, first),
        "change_gap": ref.worst_leaf_gap(
            {k: params3[k] - p0[k] for k in p0},
            {k: final[k] - p0[k] for k in p0},
            keep=lambda k: norms[k] >= 1e-3 * med)}


def control(run) -> dict:
    """The control's numbers: the reference one precision below each
    part's stated one runs the same first steps in the program's place."""
    from ..reference import precision
    return _judge(run, _reference_steps(
        run, precision.controls(run.cell.config["precision"])))


def work(run) -> dict:
    """A step's work from the configuration's shapes: the least seconds of
    its model operations (``benchmark.work.dit.train_step_flops`` at the
    blocks' precision, the frozen encode at the codec's) and its attention
    calls, the rematerialized forward's included."""
    from ..work import codec, dit
    from ..work.peaks import peak_flops
    cfg, mix = run.cell.config, run.cell.mix
    pipe, tr = cfg["pipeline"], cfg["train"]
    d = dict(pipe["dit"], remat_blocks=tr["remat_blocks"],
             remat_policy=tr["remat_policy"])
    prec = {k: v.split("+")[0] for k, v in cfg["precision"].items()}
    b = mix["batch"]
    samples = int(mix["audio_seconds"] * pipe["codec"]["sample_rate"])
    t = min(codec.frames(pipe["codec"], samples), cfg["gpt2"]["n_positions"])
    st = min(mix["text_ids"], t)
    blocks, other = dit.step_flops(d, b, t, st)
    train = dit.train_step_flops(d, b, t, st)
    model_s = ((train - 3 * other) / peak_flops(prec["dit_blocks"])
               + 3 * other / peak_flops(prec["dit_other"])
               + codec.encode_flops(pipe["codec"], b, samples)
               / peak_flops(prec["codec"]))
    calls = dit.attention_calls(d, b, t, st)
    if d["remat_blocks"]:
        calls = calls * 2
    return {"model_s": model_s,
            "attention": [(f, nb, d["compute_dtype"]) for f, nb in calls]}
