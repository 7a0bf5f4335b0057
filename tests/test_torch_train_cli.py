"""The port's three training CLIs on the CPU (``--device cpu``), as
subprocesses at the JAX CLIs' default widths (EnCodec 24 kHz, GPT2-small,
ByT5-small; the DiT at one layer) on a two-clip MLS-layout corpus: each
writes its checkpoints and its metrics; the DiTTo CLI builds a latent
cache with a NAC checkpoint's embedding head, trains from it, and resumes
(tests/test_train_cli.py's checks, without the mesh). The CLIs import
neither JAX nor the JAX package (tests/test_torch_config_params.py checks
the sources)."""

import json
import os
import subprocess
import sys
import wave

import numpy as np

from ditto_tts_tpu_torch.config import NACConfig
from ditto_tts_tpu_torch.params import init_nac_train_state
from ditto_tts_tpu_torch.train.checkpoint import save_checkpoint

import _torch_port_util  # noqa: F401  (the one-thread policy)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _corpus(root):
    """Two clips of 10.1 and 10.3 s: one 12.5 s bucket, so a batch of two
    (WAV bytes under .opus names)."""
    lines = []
    for i, secs in enumerate((10.1, 10.3)):
        utt = f"10{i:02d}_20{i:02d}_000000"
        path = os.path.join(root, "audio_clean", f"10{i:02d}", f"20{i:02d}",
                            utt + ".opus")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        t = np.arange(int(secs * 24000)) / 24000
        pcm = (0.3 * np.sin(2 * np.pi * (200.0 + 10 * i) * t) * 32767)
        with wave.open(path, "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(24000)
            f.writeframes(pcm.astype(np.int16).tobytes())
        lines.append(f"{utt}\tbonjour le monde numéro {i}")
    with open(os.path.join(root, "transcripts.txt"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(lines))
    return root


def _run(which, args, timeout=300):
    proc = subprocess.run(
        [sys.executable, "-m", f"ditto_tts_tpu_torch.scripts.train_{which}",
         "--device", "cpu", "--batch-size", "2", "--nb-samples", "2"] + args,
        cwd=_REPO, timeout=timeout, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    assert proc.returncode == 0, proc.stdout[-4000:]
    return proc.stdout


def _files(d):
    return sorted(os.listdir(d))


def test_train_nac_cli(tmp_path):
    corpus = _corpus(str(tmp_path / "mls"))
    ck = str(tmp_path / "nac")
    out = _run("nac", ["--train-path", corpus, "--checkpoint-dir", ck,
                       "--epochs", "1", "--log-path",
                       str(tmp_path / "nac.jsonl")])
    assert "random gpt2 weights" in out and "random codec weights" in out
    assert _files(ck) == ["NAC_final.json", "NAC_final.npz"]
    with np.load(os.path.join(ck, "NAC_final.npz")) as z:
        assert z["k:params//k:embedding_head//k:weight"].shape == (1024, 768)
        assert int(z["k:step"]) == 1
    rec = json.loads(open(tmp_path / "nac.jsonl").read().splitlines()[0])
    assert {"total_loss", "lm_loss", "reconstruction_loss", "codebook_loss",
            "commitment_loss"} == set(rec["train"])
    assert all(np.isfinite(v) for v in rec["train"].values())


def test_train_slp_cli(tmp_path):
    corpus = _corpus(str(tmp_path / "mls"))
    ck = str(tmp_path / "slp")
    out = _run("slp", ["--train-path", corpus, "--checkpoint-dir", ck,
                       "--epochs", "1"])
    assert "random byt5 weights" in out
    assert _files(ck) == ["SLP_final.json", "SLP_final.npz"]
    meta = json.load(open(os.path.join(ck, "SLP_final.json")))
    train = meta["history"]["train"]["metrics"][0]
    assert sorted(train) == ["accuracy", "loss"]
    assert np.isfinite(train["loss"]) and train["accuracy"] in (0.0, 0.5, 1.0)


def test_train_ditto_cli_latent_cache_and_resume(tmp_path):
    """A latent cache from a NAC checkpoint's embedding head, one epoch,
    then a second invocation (from audio, the in-step encode) that resumes
    at epoch 1 and trains the second."""
    corpus = _corpus(str(tmp_path / "mls"))
    nac = str(tmp_path / "NAC_final.npz")
    save_checkpoint(nac, init_nac_train_state(NACConfig(), seed=5,
                                              device="cpu"))
    ck, cache = str(tmp_path / "dit"), str(tmp_path / "latents")
    common = ["--train-path", corpus, "--checkpoint-dir", ck,
              "--layers", "1", "--heads", "12", "--nac-checkpoint", nac]
    out = _run("ditto", common + ["--epochs", "1", "--latent-cache", cache])
    assert "random embedding head" not in out
    assert _files(ck) == ["DiTTO_epoch_1.json", "DiTTO_epoch_1.npz",
                          "DiTTO_final.json", "DiTTO_final.npz"]
    shard = os.path.join(cache, "train_shard0of1")
    assert _files(shard) == ["bucket_300000.npy", "index.json"]
    index = json.load(open(os.path.join(shard, "index.json")))
    assert index["n_items"] == 2 and index["encode_dtype"] == "bfloat16"
    lat = np.load(os.path.join(shard, "bucket_300000.npy"))
    assert lat.shape == (2, 938, 768) and np.isfinite(lat).all()
    meta = json.load(open(os.path.join(ck, "DiTTO_epoch_1.json")))
    assert meta["epoch"] == 1
    assert np.isfinite(meta["history"]["train"]["loss"][0])

    out2 = _run("ditto", common + ["--epochs", "2"])
    assert "resumed from" in out2 and "at epoch 1" in out2, out2[-2000:]
    assert os.path.exists(os.path.join(ck, "DiTTO_epoch_2.npz"))
    with np.load(os.path.join(ck, "DiTTO_final.npz")) as z:
        assert int(z["k:step"]) == 2
