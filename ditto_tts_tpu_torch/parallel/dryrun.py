"""The multi-rank dry run (the JAX package's
``__graft_entry__.dryrun_multichip``): one DiTTo train step with the full
step semantics (frozen codec encode -> embedding head -> channel mean ->
GPT2 wte conditioning -> q_sample -> DiT forward and backward -> AdamW)
at JAX's tiny shapes, over a (data = world // 2, model = 2) mesh, through
the CLIs' wiring (``setup_mesh_training``); it asserts a finite loss and
``step == 1``.

    python -m ditto_tts_tpu_torch.parallel.dryrun --world 4 [--device cpu]

launches ``world`` ranks under ``torch.distributed.run`` (gloo; on the card
every rank takes ``cuda:LOCAL_RANK`` modulo the cards present).
"""

from __future__ import annotations

import argparse
import math
import socket
import subprocess
import sys

import torch

from ..config import (CodecConfig, DiTConfig, GPT2Config, MeshConfig,
                      NACConfig)
from ..models.nac import init_nac_trainable
from ..params import init_dit_train_state, init_nac_frozen, tree_map
from ..train import steps as steps_mod
from . import sharding
from .mesh import initialize_distributed, local_device, make_mesh
from .train_setup import setup_mesh_training


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(world: int, device: str = "cuda") -> None:
    """Launch ``world`` ranks of ``_step`` (the twin of JAX's
    ``dryrun_multichip(n_devices)``); raises if any rank fails."""
    if world < 2 or world % 2:
        raise ValueError(f"the dry run's mesh is (world // 2) x 2: world "
                         f"{world}")
    subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         str(world), "--master-addr", "localhost", "--master-port",
         str(_free_port()), "-m", "ditto_tts_tpu_torch.parallel.dryrun",
         "--rank-step", "--device", device],
        check=True)


def _step(device: str) -> None:
    """One rank: the step at JAX's tiny shapes on its share of the mesh."""
    initialize_distributed("gloo")
    world = torch.distributed.get_world_size()
    mesh = make_mesh(MeshConfig(data=world // 2, model=2))
    dev = local_device(device)

    # tiny shapes, full semantics; hidden 768 stays TP-shardable
    dit_cfg = DiTConfig(num_layers=2, num_heads=12)
    codec_cfg = CodecConfig(num_filters=4, dimension=8, ratios=(2, 2, 2),
                            codebook_size=16, num_quantizers=4,
                            lstm_layers=1)
    gpt2_cfg = GPT2Config(vocab_size=64, n_positions=64, n_embd=768,
                          n_layer=1, n_head=12)
    frozen = init_nac_frozen(codec_cfg, gpt2_cfg, seed=1, device=dev)
    head = init_nac_trainable(NACConfig(hidden_size=768, codebook_size=16),
                              seed=3)["embedding_head"]
    frozen = {"codec": frozen["codec"], "gpt2": {"wte": frozen["gpt2"]["wte"]},
              "embedding_head": tree_map(lambda t: t.to(dev), head)}

    # flat_opt=False: under TP the AdamW mu / nu shard with the parameters
    _, step_fn, _ = steps_mod.build_ditto_train_step(
        dit_cfg, codec_cfg, gpt2_cfg, flat_opt=False, device=dev, mesh=mesh)
    state = init_dit_train_state(dit_cfg, seed=0, flat_opt=False, device=dev)
    # the wiring the CLIs take (TP over the DiT, mirrored AdamW, DP rows)
    state, frozen, _, shard_batch = setup_mesh_training(
        mesh, state, frozen,
        sharding.dit_param_specs(state["params"], dit_cfg, mesh.model))

    batch_size = mesh.data * 2
    batch = shard_batch({
        "audio": torch.zeros((batch_size, 1, 256)),
        "padding_mask": torch.ones((batch_size, 256), dtype=torch.int32),
        "text_ids": torch.zeros((batch_size, 64), dtype=torch.int32)})
    new_state, metrics = step_fn(state, frozen, batch,
                                 torch.Generator(device=dev).manual_seed(1))
    loss = float(metrics["loss"])
    assert math.isfinite(loss), f"non-finite loss {loss}"
    assert int(new_state["step"]) == 1
    if mesh.rank == 0:
        print(f"[dryrun_multichip] mesh={mesh.shape} batch={batch_size} "
              f"loss={loss:.4f} OK", flush=True)
    torch.distributed.destroy_process_group()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--rank-step", action="store_true",
                   help="run one rank (as torch.distributed.run starts it)")
    args = p.parse_args(argv)
    if args.rank_step:
        _step(args.device)
    else:
        dryrun_multichip(args.world, args.device)


if __name__ == "__main__":
    main()
