"""The port's training CLIs on a (data, model) mesh on the CPU, one gloo
process per rank under ``python -m torch.distributed.run``: the twins of
tests/test_train_cli.py (train_ditto at 2 x 2 with checkpoint and resume;
the NAC at data 4, pure data parallelism; the SLP at model 2, its one
head whole and its feed-forward split), the multi-rank dry run
(``dryrun_multichip(4)``), the CLIs' refusals (a batch that does not split
over the data axis, a mesh larger than the world), and the
``eval_discrimination`` twin at a few steps, which only has to run and
write its report. The CLIs run at the JAX CLIs' widths (EnCodec 24 kHz,
GPT2-small, ByT5-small; the DiT at one layer) with random weights; every
process inherits tests/_torch_port_util.py's one-thread policy.
"""

import json
import os
import socket
import subprocess
import sys
import wave

import numpy as np
import pytest

from ditto_tts_tpu_torch.config import DiTConfig
from ditto_tts_tpu_torch.params import init_dit_train_state
from ditto_tts_tpu_torch.parallel.dryrun import dryrun_multichip
from ditto_tts_tpu_torch.scripts import train_ditto
from ditto_tts_tpu_torch.train.checkpoint import restore_into

import _torch_port_util  # noqa: F401  (the one-thread policy)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _corpus(root, n):
    """n clips of 10.1-10.4 s (one 12.5 s bucket), WAV bytes under .opus
    names."""
    lines = []
    for i in range(n):
        utt = f"10{i:02d}_20{i:02d}_000000"
        path = os.path.join(root, "audio_clean", f"10{i:02d}", f"20{i:02d}",
                            utt + ".opus")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        t = np.arange(int((10.1 + 0.1 * i) * 24000)) / 24000
        pcm = 0.3 * np.sin(2 * np.pi * (200.0 + 10 * i) * t) * 32767
        with wave.open(path, "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(24000)
            f.writeframes(pcm.astype(np.int16).tobytes())
        lines.append(f"{utt}\tbonjour le monde numero {i}")
    with open(os.path.join(root, "transcripts.txt"), "w") as f:
        f.write("\n".join(lines))
    return str(root)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(which, nproc, args, timeout=400):
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         str(nproc), "--master-addr", "localhost", "--master-port",
         str(_free_port()), "-m", f"ditto_tts_tpu_torch.scripts.train_{which}",
         "--device", "cpu", "--dist-backend", "gloo"] + args,
        cwd=_REPO, timeout=timeout, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    assert proc.returncode == 0, proc.stdout[-4000:]
    return proc.stdout


def test_mesh_cli_train_checkpoint_resume(tmp_path):
    """train_ditto at (data 2, model 2): the mesh line, the files, a
    resume that trains one more epoch, and a checkpoint of full shapes
    that restores into a one-process state."""
    corpus = _corpus(tmp_path / "mls", 4)
    ckpt = str(tmp_path / "ckpt")
    common = ["--train-path", corpus, "--checkpoint-dir", ckpt,
              "--mesh-data", "2", "--mesh-model", "2", "--layers", "1",
              "--heads", "12", "--batch-size", "4", "--nb-samples", "4",
              "--log-path", str(tmp_path / "log.jsonl")]
    out = _run("ditto", 4, common + ["--epochs", "1"])
    assert "mesh {'data': 2, 'model': 2} (gloo)" in out, out[-2000:]
    assert out.count("mesh {'data'") == 1       # rank 0 alone prints
    for name in ("DiTTO_epoch_1.npz", "DiTTO_final.npz"):
        assert os.path.exists(os.path.join(ckpt, name))

    out2 = _run("ditto", 4, common + ["--epochs", "2"])
    assert "resumed from" in out2, out2[-2000:]
    assert os.path.exists(os.path.join(ckpt, "DiTTO_epoch_2.npz"))
    # rank 0 alone writes the log: one line an epoch
    with open(tmp_path / "log.jsonl") as f:
        assert [json.loads(line)["epoch"] for line in f] == [1, 2]
    template = init_dit_train_state(DiTConfig(num_layers=1, num_heads=12),
                                    seed=9, flat_opt=False, device="cpu")
    state = restore_into(template, os.path.join(ckpt, "DiTTO_epoch_2.npz"))
    assert int(state["step"]) == 2
    w = state["params"]["blocks"][0]["attn"]["in_proj_weight"]
    assert w.shape == (3 * 768, 768) and bool(w.isfinite().all())


def test_mesh_cli_train_nac_and_slp(tmp_path):
    """The NAC at data 4 (replicated trainables) and the SLP at model 2
    (a 1472-wide head kept whole, the feed-forward split)."""
    corpus = _corpus(tmp_path / "mls", 4)
    nac_dir = str(tmp_path / "ckpt_nac")
    out = _run("nac", 4, ["--train-path", corpus, "--checkpoint-dir",
                          nac_dir, "--mesh-data", "4", "--batch-size", "4",
                          "--nb-samples", "4", "--epochs", "1"])
    assert "mesh {'data': 4, 'model': 1} (gloo)" in out, out[-2000:]
    assert os.path.exists(os.path.join(nac_dir, "NAC_final.npz"))

    slp_dir = str(tmp_path / "ckpt_slp")
    out = _run("slp", 2, ["--train-path", corpus, "--checkpoint-dir",
                          slp_dir, "--mesh-model", "2", "--batch-size", "2",
                          "--nb-samples", "2", "--epochs", "1"])
    assert "mesh {'data': 1, 'model': 2} (gloo)" in out, out[-2000:]
    assert "attention whole on each rank (1 head(s)" in out
    assert os.path.exists(os.path.join(slp_dir, "SLP_final.npz"))


@pytest.mark.parametrize("args,match", [
    (["--mesh-data", "2", "--batch-size", "3"], "does not split"),
    (["--mesh-data", "2", "--batch-size", "4"], "needs 2 processes"),
    (["--mesh-model", "2"], "needs 2 processes"),
])
def test_mesh_cli_refuses(tmp_path, monkeypatch, args, match):
    """A batch that does not split over the data axis, and a mesh larger
    than the world (one process, no launcher), raise before any
    training."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match=match):
        train_ditto.main(["--train-path", str(tmp_path), "--device", "cpu",
                          "--dist-backend", "gloo"] + args)


def test_dryrun_multichip_four_ranks(capfd):
    dryrun_multichip(4, "cpu")
    assert "[dryrun_multichip] mesh={'data': 2, 'model': 2} batch=4" in \
        capfd.readouterr().out


def test_eval_discrimination_runs_and_writes_its_report(tmp_path):
    out = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m",
         "ditto_tts_tpu_torch.scripts.eval_discrimination",
         "--train-steps", "2", "--asr-steps", "2", "--ecapa-steps", "2",
         "--seeds", "0", "--max-batches", "1", "--device", "cpu",
         "--workdir", str(tmp_path / "work"), "--out", str(out)],
        cwd=_REPO, timeout=600, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    assert proc.returncode == 0, proc.stdout[-4000:]
    rep = json.loads(out.read_text())
    for arm in ("random_weights", "trained_weights"):
        for m in ("mel_mae_mean", "cer", "wer", "sim_o", "sim_r"):
            assert np.isfinite(rep[arm][m]["mean"]), (arm, m)
    assert set(rep["discriminates"]) == {"mel_mae", "cer",
                                         "trained_cer_below_1", "sim_o"}
    assert rep["n_utterances"] == 32
