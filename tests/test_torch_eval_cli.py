"""The port's synthesis and evaluation CLIs on the CPU (``--device cpu``),
as subprocesses. ``synthesize`` at full width (EnCodec 24 kHz, GPT2-small,
BigVGAN v2; the reference's trained DiT of 5 layers, one head of 768,
``--ref-config``, which keeps the written checkpoint small) with DDIM at
2 steps on a 1 s prompt: random weights, then the same trees written to
``--bigvgan`` (a ``.pth`` under BigVGAN's names), ``--ditto`` and
``--nac`` (``.npz`` checkpoints), which must give the same bytes (the
CLI's default 12-layer DiT runs on the card, ``chip_smoke.py`` phase 12).
``evaluate`` on a two-clip corpus at a tiny
``--config`` with every model flag. The CLIs import neither JAX nor the
JAX package (tests/test_torch_config_params.py checks the sources)."""

import json
import os
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch

from ditto_tts_tpu_torch.config import (AudioConfig, CodecConfig, DiTConfig,
                                        NACConfig, PipelineConfig,
                                        SamplerConfig, VocoderConfig,
                                        ref_trained_dit_config)
from ditto_tts_tpu_torch.models.vocoder import export_bigvgan_state_dict
from ditto_tts_tpu_torch.params import fill_spec, generator_spec, tree_map
from ditto_tts_tpu_torch.train.checkpoint import _flatten

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_wav(path, secs, freq=200.0):
    t = np.arange(int(secs * 24000)) / 24000
    pcm = (0.3 * np.sin(2 * np.pi * freq * t) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(24000)
        f.writeframes(pcm.tobytes())
    return len(pcm)


def _run(which, args, timeout=300):
    # one intra-op thread: the same sums in every run (the bytes are
    # compared across runs), and no oversubscribed spinning threads beside
    # the other test workers
    proc = subprocess.run(
        [sys.executable, "-m", f"ditto_tts_tpu_torch.scripts.{which}",
         "--device", "cpu"] + args,
        cwd=_REPO, timeout=timeout, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout[-4000:]
    return proc.stdout


def _read(path):
    with wave.open(str(path), "rb") as f:
        head = (f.getnchannels(), f.getsampwidth(), f.getframerate())
        return head, f.readframes(f.getnframes())


def _synth(tmp_path, name, extra):
    out = tmp_path / name
    log = _run("synthesize", ["--audio", str(tmp_path / "prompt.wav"),
                              "--text", "bonjour le monde", "--sampler",
                              "ddim", "--steps", "2", "--seed", "3",
                              "--out", str(out)] + extra)
    return log, _read(out)


def test_synthesize_cli_random_and_from_files(tmp_path):
    n = _write_wav(tmp_path / "prompt.wav", 1.0)
    log, (head, pcm) = _synth(tmp_path, "rand.wav", ["--ref-config"])
    for flag in ("--encodec", "--gpt2", "--bigvgan", "--ditto", "--nac"):
        assert f"[warn] {flag} not given" in log, log
    # 24 kHz mono int16; the chain renders whole mel hops of the prompt
    assert head == (1, 2, 24000)
    assert len(pcm) == 2 * 256 * (n // 256)
    samples = np.frombuffer(pcm, np.int16)
    assert samples.std() > 0

    # the same trees through the weight files: the same bytes
    cfg = PipelineConfig(dit=ref_trained_dit_config())
    tree = fill_spec(generator_spec(cfg), 3)
    files = {"bigvgan": tmp_path / "bigvgan.pth",
             "ditto": tmp_path / "DiTTO_final.npz",
             "nac": tmp_path / "NAC_final.npz"}
    torch.save(export_bigvgan_state_dict(tree_map(torch.from_numpy,
                                           tree["vocoder"]), cfg.vocoder),
               files["bigvgan"])
    np.savez(files["ditto"], **_flatten({"params": tree["dit"],
                                         "step": np.int32(7)}))
    np.savez(files["nac"], **_flatten({"params": {
        k: tree[k] for k in ("embedding_head", "vector_quantizer")}}))
    del tree
    log2, (head2, pcm2) = _synth(
        tmp_path, "files.wav", ["--ref-config"] + [
            a for k, p in files.items() for a in (f"--{k}", str(p))])
    for flag in ("--bigvgan", "--ditto", "--nac"):
        assert f"[warn] {flag} not given" not in log2, log2
    assert head2 == head and pcm2 == pcm


H = 32
TINY = PipelineConfig(
    audio=AudioConfig(min_audio_seconds=0.5, max_audio_seconds=2.0),
    codec=CodecConfig(num_filters=4, dimension=8, ratios=(8, 5, 4, 2),
                      codebook_size=64, num_quantizers=4, lstm_layers=1),
    nac=NACConfig(hidden_size=H, codebook_size=64),
    dit=DiTConfig(hidden_dim=H, num_layers=1, num_heads=4, time_dim=16,
                  text_dim=H, diffusion_steps=16, max_token_length=256),
    vocoder=VocoderConfig(
        num_mels=20, upsample_rates=(8, 8, 4),
        upsample_kernel_sizes=(16, 16, 8), upsample_initial_channel=32,
        resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
        compute_dtype="float32", carry_dtype="float32"),
    sampler=SamplerConfig(num_steps=4, kind="ddim"))
TINY_GPT2 = dict(vocab_size=300, n_positions=256, n_embd=H, n_layer=1,
                 n_head=4)


def _corpus(root):
    """Two clips of 1.0 and 1.3 s: one 1.625 s bucket, a batch of two."""
    lines = []
    for i, secs in enumerate((1.0, 1.3)):
        utt = f"10{i:02d}_20{i:02d}_000000"
        path = os.path.join(root, "audio_clean", f"10{i:02d}", f"20{i:02d}",
                            utt + ".opus")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _write_wav(path, secs, 180.0 + 30 * i)
        lines.append(f"{utt}\tbonjour le monde numéro {i}")
    with open(os.path.join(root, "transcripts.txt"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(lines))
    return root


def test_evaluate_cli_tiny(tmp_path):
    corpus = _corpus(str(tmp_path / "mls"))
    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(TINY.to_json())
    out = tmp_path / "eval.json"
    log = _run("evaluate", [
        "--data-path", corpus, "--config", str(cfg_path), "--out", str(out),
        "--batch-size", "2", "--max-batches", "1",
        "--gpt2-config", json.dumps(TINY_GPT2), "--s2t", "random",
        "--s2t-tiny", "--ecapa", "random", "--ecapa-tiny", "--smoke-ortho",
        "--oracle-ref", "--lenient-duration"])
    assert "[eval] s2t ASR loaded; <lang:fr> id 5" in log, log
    # evaluate_batch's seconds per stage, one line a batch
    line = next(ln for ln in log.splitlines()
                if ln.startswith("[eval] batch 0 (2 x "))
    for stage in ("synthesis", "oracle", "mel_mae", "asr", "codec",
                  "ecapa"):
        assert f" {stage} " in line, line
    res = json.loads(out.read_text())
    assert set(res) == {"mel_mae_mean", "num_utterances", "cer", "wer",
                        "sim_o", "sim_r"}
    assert res["num_utterances"] == 2
    assert all(np.isfinite(v) for v in res.values())
    assert res["cer"] >= 0 and res["wer"] >= 0
    assert -1 <= res["sim_o"] <= 1 and -1 <= res["sim_r"] <= 1


def test_write_wav_quantizes_as_jax_and_refuses_non_finite(tmp_path):
    from ditto_tts_tpu_torch.scripts.synthesize import write_wav
    wav = np.array([0.0, 0.5, -0.5, 1.5, -2.0, 1e-5], np.float32)
    assert write_wav(str(tmp_path / "a.wav"), wav, 24000) == 6
    head, pcm = _read(tmp_path / "a.wav")
    assert head == (1, 2, 24000)
    np.testing.assert_array_equal(
        np.frombuffer(pcm, np.int16),
        (np.clip(wav, -1, 1) * 32767).astype(np.int16))
    with pytest.raises(ValueError, match="non-finite"):
        write_wav(str(tmp_path / "b.wav"), np.array([0.1, np.nan]), 24000)


def test_entry_points_need_cuda_unless_cpu_is_asked(tmp_path):
    """The CLIs, the random S2T / ECAPA trees and mel_mae on host arrays
    run on ``cuda`` unless asked for the CPU, and raise without CUDA; the
    import check of tests/test_torch_config_params.py covers the new
    modules."""
    from test_torch_config_params import _port_files
    from ditto_tts_tpu_torch import resolve_device
    from ditto_tts_tpu_torch.eval.metrics import mel_mae
    from ditto_tts_tpu_torch.models.ecapa import tiny_ecapa_config
    from ditto_tts_tpu_torch.params import init_ecapa_params, init_s2t_params
    from ditto_tts_tpu_torch.scripts import evaluate, synthesize
    names = {os.path.relpath(p, _REPO) for p in _port_files()}
    assert {f"ditto_tts_tpu_torch/{m}.py" for m in (
        "models/s2t", "models/ecapa", "text/s2t_tokenizer", "eval/metrics",
        "eval/throughput", "eval/plots", "utils/smoke", "utils/profiling",
        "scripts/synthesize", "scripts/evaluate")} | {"chip_smoke.py"} \
        <= names
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    s2t_cfg = evaluate.tiny_s2t_config()
    wav = np.zeros(4000, np.float32)
    for call in (
            lambda: synthesize.main(["--audio", "a.wav", "--text", "a"]),
            lambda: evaluate.main(["--data-path", str(tmp_path)]),
            lambda: init_s2t_params(s2t_cfg),
            lambda: init_ecapa_params(tiny_ecapa_config()),
            lambda: mel_mae(wav, wav)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert init_s2t_params(s2t_cfg, device="cpu")["embed_tokens"][
        "weight"].device.type == "cpu"
    assert mel_mae(wav, wav, device="cpu") == 0.0
