"""The DiTTo training step, data-parallel over the cards of one host, closed
loop: ``ranks`` processes (this one is rank 0; it starts the others), a
(data ``ranks``, model 1) mesh of the program's ``parallel/`` over NCCL
(gloo on the CPU), each rank stepping ``build_ditto_train_step(...,
mesh=mesh).step_fn`` on its own rows and the gradient averaged over the
data group by the program.

A rank's batch is ``batch_per_rank`` rows of ``audio_seconds`` of 0.05 x
N(0, 1) audio (every sample valid) and ``text_ids`` GPT2 ids (uniform over
the vocabulary), made on its host from the seed and the rank, and copied
in by the step; ``pool`` distinct batches a rank are sent in turn. Every
rank draws t, the noise and the dropout masks of the global batch from one
generator seeded alike and keeps its rows (the program's mesh step). The
weights are drawn on rank 0's card and broadcast. Each step reads its loss
(the mean over the ranks) back.

Rank 0 decides every step: before each one it broadcasts a command (step
or stop), so every rank runs the same steps; at the end it broadcasts
stop, the ranks agree on the steps run, and the others exit. Each rank's
CPU threads are capped at its share of the host's cores. Set-up builds the
state on every rank and drives it through its first ``check_steps`` steps,
which warms every shape, and ends after a barrier.

The comparison follows rank 0's first steps with the plain reference's
functions (``reference.train``, ``reference.dit``) on the global batch
(every rank's rows, made again from the seed), summing the gradient over
chunks of ``check_rows`` rows so that fp32 fits on one card.

Mix parameters: ranks, batch_per_rank, audio_seconds, text_ids, pool,
check_steps, trace_steps, check_rows.

    python -m benchmark.traffic.train_dp --rank R --world W --port P
        --seed S --device cuda|cpu --cell '<json>'

is how rank 0 starts rank R (from the root of the checkout).
"""

from __future__ import annotations

import argparse
import atexit
import datetime
import json
import os
import socket
import subprocess
import sys
import time
from types import SimpleNamespace

from .. import core
from .train_step import _cfgs, _clone

TIMEOUT_S = 300


def _threads(world: int) -> int:
    return max(1, (os.cpu_count() or 1) // world)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _join(run, rank: int, world: int, port: int):
    """This rank's process group and mesh, and its device."""
    import torch
    import torch.distributed as dist
    from ditto_tts_tpu_torch.config import MeshConfig
    from ditto_tts_tpu_torch.parallel.mesh import make_mesh
    torch.set_num_threads(_threads(world))
    if run.device.type == "cuda":
        run.device = torch.device("cuda", rank)
        torch.cuda.set_device(run.device)
    dist.init_process_group(
        "nccl" if run.device.type == "cuda" else "gloo",
        init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    run.rank, run.world = rank, world
    run.mesh = make_mesh(MeshConfig(data=world, model=1))


def _rank_batches(run, rank: int, count: int):
    """The first ``count`` batches of rank ``rank``'s pool, as its host
    makes them."""
    import numpy as np
    mix = run.cell.mix
    rng = np.random.default_rng(core.subseed(run.seed, f"batches{rank}"))
    b = mix["batch_per_rank"]
    samples = int(mix["audio_seconds"]
                  * run.cell.config["pipeline"]["codec"]["sample_rate"])
    vocab = run.cell.config["gpt2"]["vocab_size"]
    return [{"audio": (0.05 * rng.standard_normal((b, 1, samples))).astype(
                np.float32),
             "padding_mask": np.ones((b, samples), np.int32),
             "text_ids": rng.integers(0, vocab, (b, mix["text_ids"]))}
            for _ in range(count)]


def _build(run):
    """Weights (rank 0's, broadcast), the step, this rank's batches, and
    the first ``check_steps`` steps."""
    import torch
    import torch.distributed as dist
    from ditto_tts_tpu_torch.config import PipelineConfig
    from ditto_tts_tpu_torch.params import generator_spec, ravel_tree
    from ditto_tts_tpu_torch.train.steps import build_ditto_train_step
    cell, dev, mix = run.cell, run.device, run.cell.mix
    tr = cell.config["train"]
    dcfg, ccfg, gcfg = _cfgs(cell)
    spec = generator_spec(PipelineConfig.from_json(
        json.dumps(cell.config["pipeline"])))
    spec = {"dit": spec["dit"], "codec": spec["codec"],
            "gpt2": {"wte": spec["gpt2"]["wte"]},
            "embedding_head": spec["embedding_head"]}
    tree = core.draw_spec(torch, spec, core.subseed(run.seed, "weights"), dev)
    flat, unravel = ravel_tree(tree)
    dist.broadcast(flat, src=0)
    tree = unravel(flat)
    run.frozen = {k: tree[k] for k in ("codec", "gpt2", "embedding_head")}
    init_state, step_fn, _ = build_ditto_train_step(
        dcfg, ccfg, gcfg, learning_rate=tr["learning_rate"],
        weight_decay=tr["weight_decay"], encode_dtype=tr["encode_dtype"],
        flat_opt=tr["flat_opt"], device=dev, mesh=run.mesh)
    run.step_fn = step_fn
    run.batches = _rank_batches(run, run.rank, mix["pool"])
    run.gen_seed = core.subseed(run.seed, "draws")
    run.gen = torch.Generator(device=dev).manual_seed(run.gen_seed)
    if run.rank == 0:
        run.params0 = _clone(tree["dit"])
    state = init_state(tree["dit"])
    run.losses, run.steps_done = [], 0
    for i in range(mix["check_steps"]):
        state, m = step_fn(state, run.frozen, run.batches[i], run.gen)
        run.losses.append(float(m["loss"]))
        if i == 0 and run.rank == 0:   # the first gradient, from Adam's mu
            run.grad1 = (state["opt_state"][0]["mu"] / 0.1).clone()
        run.steps_done += 1
    if run.rank == 0:
        run.params3 = ravel_tree(state["params"])[0].clone()
    run.state = state
    run.mesh.barrier()


def _command(run, value: int) -> int:
    """Rank 0's ``value`` on every rank: 1 steps, 0 stops."""
    import torch
    import torch.distributed as dist
    t = torch.tensor([value], dtype=torch.int32, device=run.device)
    dist.broadcast(t, src=0)
    return int(t.item())


def _train(run) -> float:
    batch = run.batches[run.steps_done % len(run.batches)]
    run.state, m = run.step_fn(run.state, run.frozen, batch, run.gen)
    run.steps_done += 1
    return float(m["loss"])


def _agree(run):
    """(fewest, most) steps any rank ran; every rank calls it once it has
    stopped."""
    import torch
    import torch.distributed as dist
    lo = torch.tensor([run.steps_done], dtype=torch.int64, device=run.device)
    hi = lo.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    return int(lo.item()), int(hi.item())


def _stop_workers(run):
    procs = getattr(run, "workers", [])
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()


def setup(run):
    """Rank 0: start the other ranks, join the mesh, build (``_build``)."""
    mix = run.cell.mix
    world = mix["ranks"]
    port = _free_port()
    cell = json.dumps({"name": run.cell.name, "config": run.cell.config,
                       "mix": mix})
    env = dict(os.environ, OMP_NUM_THREADS=str(_threads(world)))
    run.workers = [subprocess.Popen(
        [sys.executable, "-m", "benchmark.traffic.train_dp", "--rank",
         str(r), "--world", str(world), "--port", str(port), "--seed",
         str(run.seed), "--device", run.device.type, "--cell", cell],
        cwd=str(core.ROOT), env=env, stdout=sys.stderr)
        for r in range(1, world)]
    atexit.register(_stop_workers, run)
    _join(run, 0, world, port)
    _build(run)


def _step(run) -> float:
    """Rank 0: one step on every rank."""
    _command(run, 1)
    return _train(run)


def _record(run, steps: int, wall: float):
    mix = run.cell.mix
    run.window = {"requests": steps, "wall_s": wall,
                  "audio_s": steps * mix["ranks"] * mix["batch_per_rank"]
                  * mix["audio_seconds"]}


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
    """``trace_steps`` steps timed, then as many under the profiler (on
    rank 0)."""
    n = run.cell.mix["trace_steps"]
    t0 = time.perf_counter()
    for _ in range(n):
        _step(run)
    _record(run, n, time.perf_counter() - t0)
    run.trace_requests = n
    run.trace = profile(lambda: [_step(run) for _ in range(n)])


def _end(run):
    """Stop the other ranks and leave the process group with them (NCCL's
    teardown waits for every rank's), then reap them."""
    import torch.distributed as dist
    if getattr(run, "workers", None) is None or not dist.is_initialized():
        return
    _command(run, 0)
    run.rank_steps = _agree(run)
    dist.destroy_process_group()
    for p in run.workers:
        try:
            p.wait(timeout=60)
        except subprocess.TimeoutExpired:
            p.kill()
    run.workers = []


def check(run, checks):
    """Stop the ranks, then rank 0's first steps against the reference on
    the global batch: each step's loss, the first gradient by leaf norm,
    and each leaf's change over the steps by norm (leaves whose reference
    gradient is under a thousandth of the median leaf's are left out of
    the change), as ``train_step`` judges them."""
    import torch
    _end(run)
    judged = (run.losses, _split(run, run.grad1), _split(run, run.params3))
    run.state = None
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    for k, v in _judge(run, judged).items():
        checks.add(k, v)
    return run.cell.mix["check_steps"]


def _split(run, flat):
    from ditto_tts_tpu_torch.params import tree_leaves
    out, at = {}, 0
    for k, v in tree_leaves(run.params0):
        out[k] = flat[at:at + v.numel()].view(v.shape)
        at += v.numel()
    return out


def global_batches(run, count: int):
    """The first ``count`` global batches: every rank's rows, in rank
    order."""
    import numpy as np
    per = [_rank_batches(run, r, count) for r in range(run.cell.mix["ranks"])]
    return [{k: np.concatenate([p[i][k] for p in per]) for k in per[0][i]}
            for i in range(count)]


def reference_steps(run, prec):
    """(losses, first gradient, final params by leaf path) of the plain
    reference's steps over the global batches (``reference.train.steps``
    with the gradient summed over row chunks)."""
    import torch
    from ..reference import dit as dit_ref
    from ..reference import train as ref
    from ..reference.precision import exact
    cfg, mix, dev = run.cell.config, run.cell.mix, run.device
    pipe, tr = cfg["pipeline"], cfg["train"]
    dit = dict(pipe["dit"], cross_attn_dropout=tr["cross_attn_dropout"])
    rate, chunk = dit["cross_attn_dropout"], mix["check_rows"]
    _, ac = dit_ref.cosine_schedule(dit["diffusion_steps"])
    gen = torch.Generator(device=dev).manual_seed(run.gen_seed)
    p = {k: v.detach().float().clone() for k, v in ref.leaves(run.params0)}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps, lr, wd = 0.9, 0.999, 1e-8, tr["learning_rate"], \
        tr["weight_decay"]
    bp = {"blocks": prec["dit_blocks"], "carry": prec["dit_carry"],
          "other": prec["dit_other"]}
    losses, first = [], None
    with exact():
        for n, batch in enumerate(global_batches(run, mix["check_steps"]),
                                  start=1):
            batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
            b = batch["audio"].shape[0]
            with torch.no_grad():
                lat = torch.cat([ref.encode_latents(
                    run.frozen, pipe["codec"], batch["audio"][s:s + chunk],
                    batch["padding_mask"][s:s + chunk],
                    cfg["gpt2"]["n_positions"], prec["codec"])
                    for s in range(0, b, chunk)])
                ids = batch["text_ids"][:, :lat.shape[1]]
                emb = run.frozen["gpt2"]["wte"]["weight"][ids].float()
            _, t_len, h = lat.shape
            t = torch.randint(0, dit["diffusion_steps"], (b,), generator=gen,
                              device=dev)
            noise = torch.randn((b, t_len, h), generator=gen,
                                dtype=torch.float32, device=dev)
            keeps = [torch.rand((b, t_len, h), generator=gen, device=dev)
                     >= rate for _ in range(dit["num_layers"])] \
                if rate > 0 else None
            c = ac.to(dev)[t][:, None, None]
            noisy = torch.sqrt(c) * lat + torch.sqrt(1.0 - c) * noise
            names = list(p)
            grads = {k: torch.zeros_like(v) for k, v in p.items()}
            loss = 0.0
            for s in range(0, b, chunk):
                leaf = {k: v.clone().requires_grad_() for k, v in p.items()}
                tree = ref.unflatten(run.params0, leaf)
                pred = dit_ref.forward(
                    tree, dit, noisy[s:s + chunk], emb[s:s + chunk],
                    t[s:s + chunk], bp,
                    None if keeps is None else [k[s:s + chunk]
                                                for k in keeps])
                part = torch.square(pred - noise[s:s + chunk]).sum() \
                    / noise.numel()
                got = torch.autograd.grad(part, [leaf[k] for k in names],
                                          allow_unused=True)
                for k, g in zip(names, got):
                    if g is not None:
                        grads[k] += g
                loss += float(part.detach())
                del tree, leaf, pred, part, got
            losses.append(loss)
            if first is None:
                first = {k: g.clone() for k, g in grads.items()}
            with torch.no_grad():
                for k in names:
                    g = grads[k]
                    mu[k] = (1 - b1) * g + b1 * mu[k]
                    nu[k] = (1 - b2) * g * g + b2 * nu[k]
                    upd = (mu[k] / (1 - b1 ** n)) / (
                        torch.sqrt(nu[k] / (1 - b2 ** n)) + eps)
                    p[k] = p[k] - lr * (upd + wd * p[k])
            del grads
    return losses, first, p


def _judge(run, judged) -> dict:
    """(losses, first gradient, params after the steps), by leaf path,
    against the fp32 reference's."""
    from ..reference import train as ref
    losses, grad1, params3 = judged
    want_losses, first, final = reference_steps(
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
    return _judge(run, reference_steps(
        run, precision.controls(run.cell.config["precision"])))


def work(run) -> dict:
    """A step's work over every rank, from the configuration's shapes
    (``train_step.work`` at the global batch), as the least seconds of
    the ranks' cards together: the model operations over ``ranks`` times
    each part's peak; and the attention calls of rank 0 (the traced one),
    the rematerialized forward's included."""
    from ..work import codec, dit
    from ..work.peaks import peak_flops
    cfg, mix = run.cell.config, run.cell.mix
    pipe, tr = cfg["pipeline"], cfg["train"]
    d = dict(pipe["dit"], remat_blocks=tr["remat_blocks"],
             remat_policy=tr["remat_policy"])
    prec = {k: v.split("+")[0] for k, v in cfg["precision"].items()}
    b = mix["ranks"] * mix["batch_per_rank"]
    samples = int(mix["audio_seconds"] * pipe["codec"]["sample_rate"])
    t = min(codec.frames(pipe["codec"], samples), cfg["gpt2"]["n_positions"])
    st = min(mix["text_ids"], t)
    _, other = dit.step_flops(d, b, t, st)
    train = dit.train_step_flops(d, b, t, st)
    model_s = ((train - 3 * other) / peak_flops(prec["dit_blocks"])
               + 3 * other / peak_flops(prec["dit_other"])
               + codec.encode_flops(pipe["codec"], b, samples)
               / peak_flops(prec["codec"])) / mix["ranks"]
    calls = dit.attention_calls(d, mix["batch_per_rank"], t, st)
    if d["remat_blocks"]:
        calls = calls * 2
    return {"model_s": model_s,
            "attention": [(f, nb, d["compute_dtype"]) for f, nb in calls]}


def _worker(argv=None) -> int:
    """Rank R > 0: join, build, then step while rank 0 says so."""
    ap = argparse.ArgumentParser()
    for k in ("rank", "world", "port", "seed"):
        ap.add_argument(f"--{k}", type=int, required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--cell", required=True)
    args = ap.parse_args(argv)
    try:                     # leave with rank 0, however it ends
        import ctypes
        import signal
        ctypes.CDLL("libc.so.6").prctl(1, signal.SIGTERM)
    except (OSError, AttributeError):
        pass
    import torch
    import torch.distributed as dist
    c = json.loads(args.cell)
    run = SimpleNamespace(
        cell=SimpleNamespace(name=c["name"], config=c["config"], mix=c["mix"]),
        seed=args.seed, device=torch.device(args.device))
    _join(run, args.rank, args.world, args.port)
    _build(run)
    while _command(run, 0) == 1:
        _train(run)
    _agree(run)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_worker())
