"""Show that the evaluation harness tells good generation from bad (the JAX
package's ``scripts/eval_discrimination.py``), a closed loop on a tiny
corpus, with no pretrained weights:

  1. Build a 32-utterance MLS-layout corpus of distinct deterministic
     two-tone clips (1.6 s each, f0 from 250 to 5000 Hz) with distinct
     transcripts.
  2. Train a tiny corrected-mode DiTTo (hidden 64, 2 layers, x0
     prediction) with the port's train step until it memorizes the
     latents, from the DiT that ``evaluate --seed 0`` draws.
  3. Train a tiny S2T ASR and a tiny ECAPA embedder on the chain's own
     oracle renders (random scorers cannot discriminate; the trained ones
     play the part of the reference's frozen s2t-medium and speechbrain
     ECAPA).
  4. Run the ``evaluate`` twin (``python -m
     ditto_tts_tpu_torch.scripts.evaluate``) with identical frozen models
     and seeds, once with the random DiT and once with the trained one,
     under the oracle-ref protocol, for each sampling seed.
  5. Write the report (``--out``, by default under ``--workdir``): the
     metrics per arm (mean, spread, per seed), the margins and whether
     the trained DiT beats the random one on mel-MAE, CER and SIM-o.

Every step runs on ``--device`` (``cuda`` by default). The clips are
16-bit WAV under ``.opus`` names (the data layer reads either by its magic
bytes; libopus need not be present). The trainings use ``torch.optim.Adam``
at JAX's rates (optax's ``adam`` has the same defaults); the draws are
torch's, so the numbers are this run's own, not JAX's ``EVAL_r05.json``.

  python -m ditto_tts_tpu_torch.scripts.eval_discrimination \\
      [--train-steps 6000] [--workdir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import wave

import numpy as np
import torch

from .. import assets
from ..config import (AudioConfig, CodecConfig, DiTConfig, GPT2Config,
                      NACConfig, PipelineConfig, SamplerConfig,
                      VocoderConfig)
from ..data.mls import MLSDataset, batches, default_buckets
from ..infer.generator import encode_prompt_latents, latents_to_waveform
from ..models import ecapa as ecapa_mod
from ..models import s2t as s2t_mod
from ..params import (init_ecapa_params, init_generator_params,
                      init_s2t_params, tree_leaves, tree_map)
from ..train import steps as steps_mod
from ..train.checkpoint import save_checkpoint
from ..utils.smoke import orthogonal_reinit
from ._common import device_of, gpt2_tokenizer
from .evaluate import tiny_s2t_config

H = 64
# x0 prediction, short T and deterministic DDIM: with eps prediction the
# text's gradient vanishes at high t and a tiny model samples one blob
# whatever the text; x0 supervises text -> latent at every t
TINY = PipelineConfig(
    audio=AudioConfig(min_audio_seconds=0.5, max_audio_seconds=2.0),
    codec=CodecConfig(num_filters=4, dimension=8, ratios=(8, 5, 4, 2),
                      codebook_size=64, num_quantizers=4, lstm_layers=1),
    nac=NACConfig(hidden_size=H, codebook_size=64),
    dit=DiTConfig(hidden_dim=H, num_layers=2, num_heads=4, time_dim=32,
                  text_dim=H, diffusion_steps=16, max_token_length=256,
                  prediction_type="x0"),
    vocoder=VocoderConfig(
        num_mels=20, upsample_rates=(8, 8, 4),
        upsample_kernel_sizes=(16, 16, 8), upsample_initial_channel=32,
        resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3),
                                                               (1, 3)),
        compute_dtype="float32", carry_dtype="float32"),
    sampler=SamplerConfig(num_steps=16, kind="ddim", ddim_eta=0.0,
                          clip_denoised=3.0),
)
TINY_GPT2 = dict(vocab_size=300, n_positions=256, n_embd=H, n_layer=1,
                 n_head=4)
SEED = 0


def _make_texts(n: int) -> list:
    """n distinct 3-word transcripts from a fixed word bank (every word's
    characters are in the S2T mini vocabulary)."""
    bank = ["bonjour", "le", "monde", "quatre", "vingt", "dix", "neuf",
            "la", "mer", "est", "calme", "un", "deux", "trois", "soleil"]
    rng = np.random.default_rng(1234)
    texts, seen = [], set()
    while len(texts) < n:
        words = tuple(rng.choice(len(bank), 3, replace=False))
        if words in seen:
            continue
        seen.add(words)
        texts.append(" ".join(bank[w] for w in words))
    return texts


TEXTS = _make_texts(32)


def build_corpus(root: str) -> None:
    """The clips: identical durations (an ASR memorizing the corpus could
    otherwise tell them by length) and well-separated spectra."""
    lines = []
    sr, secs = 24000, 1.6
    t = np.arange(int(secs * sr)) / sr
    for i, text in enumerate(TEXTS):
        utt = f"10{i:02d}_20{i:02d}_000000"
        path = os.path.join(root, "audio_clean", f"10{i:02d}", f"20{i:02d}",
                            f"{utt}.opus")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        f0 = float(np.geomspace(250.0, 5000.0, len(TEXTS))[i])
        pcm = 0.3 * np.sin(2 * np.pi * f0 * t) \
            + 0.2 * np.sin(2 * np.pi * 2.3 * f0 * t + i)
        with wave.open(path, "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(sr)
            f.writeframes((pcm * 32767).astype(np.int16).tobytes())
        lines.append(f"{utt}\t{text}")
    with open(os.path.join(root, "transcripts.txt"), "w") as f:
        f.write("\n".join(lines))


def _smoke_params(dev):
    """The serving trees ``evaluate --seed 0 --smoke-ortho`` builds: drawn
    from the seed, codec and vocoder re-initialized orthogonally."""
    params = init_generator_params(TINY, SEED,
                                   gpt2_cfg=GPT2Config(**TINY_GPT2))
    params.codec = orthogonal_reinit(params.codec, seed=SEED)
    params.vocoder = orthogonal_reinit(params.vocoder, seed=SEED)
    return params.to(dev)


def _corpus_batch(corpus: str) -> dict:
    """All the corpus in one unshuffled batch (dataset order = TEXTS)."""
    class _Args:
        gpt2_vocab = None
    ds = MLSDataset(corpus, gpt2_tokenizer(_Args()),
                    TINY.dit.max_token_length, tokenizer_name="gpt2",
                    strict_duration=False)
    buckets = default_buckets(TINY.audio.sample_rate,
                              TINY.audio.min_audio_seconds,
                              TINY.audio.max_audio_seconds)
    return next(iter(batches(ds, len(TEXTS), buckets=buckets,
                             shuffle=False)))


def train_tiny_ditto(corpus: str, steps: int, out_path: str, dev) -> None:
    """The tiny DiT through the port's train step and data layer, from the
    DiT ``evaluate`` draws at ``--seed 0``."""
    params = _smoke_params(dev)
    frozen = {"codec": params.codec, "gpt2": params.gpt2,
              "embedding_head": params.embedding_head}
    init_state, step_fn, _ = steps_mod.build_ditto_train_step(
        TINY.dit, TINY.codec, GPT2Config(**TINY_GPT2), learning_rate=2e-3,
        device=dev)
    state = init_state(params.dit)
    batch = _corpus_batch(corpus)
    t0 = time.time()
    for i in range(steps):
        state, m = step_fn(state, frozen, batch,
                           torch.Generator(device=dev).manual_seed(i))
        if i % 500 == 0 or i == steps - 1:
            print(f"[train] step {i}: loss {float(m['loss']):.5f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    save_checkpoint(out_path, {"params": state["params"]})


def _text_to_s2t_ids(text: str, vocab: dict, eos: int = 2,
                     lang: int = 5) -> list:
    """A transcript as mini-vocabulary ids in the HF S2T layout: <eos>
    <lang> pieces... <eos>."""
    ids = [eos, lang]
    for word in text.split():
        ids.append(vocab["▁" + word[0]])
        ids.extend(vocab[c] for c in word[1:])
    ids.append(eos)
    return ids


def _oracle_fbanks(corpus: str, dev):
    """The utterances rendered through the chain's oracle path (their own
    latents -> VQ -> codec -> mel -> vocoder) as the 16 kHz log-mel fbanks
    ``evaluate`` feeds the ASR and the embedder: ([N, T, 80], [N, T])."""
    params = _smoke_params(dev)
    batch = _corpus_batch(corpus)
    audio = torch.from_numpy(batch["audio"]).to(dev)
    mask = torch.from_numpy(batch["padding_mask"]).to(dev)
    with torch.inference_mode():
        lat = encode_prompt_latents(params, TINY, audio, mask)
        renders = latents_to_waveform(params, TINY, lat,
                                      output_length=audio.shape[-1])
    renders = renders.float().cpu().numpy()
    feats = []
    for r in range(renders.shape[0]):
        n = int(batch["padding_mask"][r].sum())
        wav16 = np.interp(np.arange(0, n, 1.5), np.arange(n),
                          renders[r][:n]).astype(np.float32)
        feats.append(s2t_mod.log_mel_fbank(wav16, 16000))
    t_max = max(f.shape[0] for f in feats)
    fb = np.zeros((len(feats), t_max, 80), np.float32)
    fmask = np.zeros((len(feats), t_max), np.int32)
    for i, f in enumerate(feats):
        fb[i, :f.shape[0]] = f
        fmask[i, :f.shape[0]] = 1
    return (torch.from_numpy(fb).to(dev), torch.from_numpy(fmask).to(dev))


def _trainable(tree):
    tree = tree_map(lambda t: t.detach().clone().requires_grad_(), tree)
    return tree, [leaf for _, leaf in tree_leaves(tree)]


def train_tiny_asr(corpus: str, steps: int, out_path: str, dev) -> list:
    """The tiny S2T trained to transcribe the oracle renders (a random one
    decodes one sequence whatever its input); returns its transcripts of
    the renders."""
    fb, fmask = _oracle_fbanks(corpus, dev)
    tok = assets.s2t_mini_tokenizer()
    cfg = tiny_s2t_config()
    seqs = [_text_to_s2t_ids(t, tok.vocab) for t in TEXTS]
    s_max = max(len(s) for s in seqs)
    tokens = torch.full((len(seqs), s_max), cfg.pad_token_id,
                        dtype=torch.int64)
    for i, s in enumerate(seqs):
        tokens[i, :len(s)] = torch.tensor(s)
    tokens = tokens.to(dev)
    params, leaves = _trainable(init_s2t_params(cfg, SEED + 5, dev))
    opt = torch.optim.Adam(leaves, lr=3e-4)
    gen = torch.Generator(device=dev).manual_seed(1000)
    tgt = tokens[:, 1:]
    mask = (tgt != cfg.pad_token_id).float()
    t0 = time.time()
    for i in range(steps):
        # light feature noise, so the mapping holds off the 32 points
        noisy = fb + 0.05 * torch.randn(fb.shape, generator=gen, device=dev)
        enc, enc_mask = s2t_mod.encode(params, cfg, noisy, fmask)
        logits = s2t_mod.decode_logits(params, cfg, tokens[:, :-1], enc,
                                       enc_mask)
        ce = torch.nn.functional.cross_entropy(
            logits.transpose(1, 2), tgt, reduction="none")
        loss = (ce * mask).sum() / mask.sum()
        opt.zero_grad()
        loss.backward()
        opt.step()
        if i % 200 == 0 or i == steps - 1:
            print(f"[asr] step {i}: ce {float(loss):.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    params = tree_map(torch.Tensor.detach, params)
    ids = s2t_mod.greedy_decode(params, cfg, fb, fmask, forced_bos_id=5,
                                max_len=s_max + 4)
    hyp = tok.batch_decode(ids.cpu().numpy())
    junk = s2t_mod.greedy_decode(
        params, cfg, torch.randn(fb.shape, generator=gen, device=dev),
        fmask, forced_bos_id=5, max_len=s_max + 4)
    print("[asr] transcripts on renders:", hyp)
    print("[asr] transcripts on noise:  ",
          tok.batch_decode(junk.cpu().numpy()))
    save_checkpoint(out_path, {"params": params})
    return hyp


def train_tiny_ecapa(corpus: str, steps: int, out_path: str, dev) -> None:
    """The tiny ECAPA trained on the oracle renders as (n + 1)-way
    classification through the normalized embedding: each utterance its
    own speaker (its f0), plus a noise class, so a faithful generation
    embeds near its render and a random DiT's output near the noise."""
    fb, fmask = _oracle_fbanks(corpus, dev)
    n = fb.shape[0]
    cfg = ecapa_mod.tiny_ecapa_config()
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    params, leaves = _trainable(init_ecapa_params(cfg, SEED + 17, dev))
    head = (0.1 * torch.randn((cfg.embedding_dim, n + 1), generator=gen,
                              device=dev)).requires_grad_()
    opt = torch.optim.Adam(leaves + [head], lr=1e-3)
    labels = torch.cat([torch.arange(n), torch.full((n,), n)]).to(dev)
    masks = torch.cat([fmask, fmask])
    t0 = time.time()
    for i in range(steps):
        aug = fb + 0.3 * torch.randn(fb.shape, generator=gen, device=dev)
        noise = torch.randn(fb.shape, generator=gen, device=dev) * fb.std()
        emb = ecapa_mod.ecapa_embed(params, cfg, torch.cat([aug, noise]),
                                    masks)
        emb = emb / (emb.norm(dim=-1, keepdim=True) + 1e-8)
        loss = torch.nn.functional.cross_entropy(10.0 * emb @ head, labels)
        opt.zero_grad()
        loss.backward()
        opt.step()
        if i % 200 == 0 or i == steps - 1:
            print(f"[ecapa] step {i}: ce {float(loss):.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    params = tree_map(torch.Tensor.detach, params)
    with torch.inference_mode():
        emb = ecapa_mod.ecapa_embed(params, cfg, fb, fmask)
        noise = ecapa_mod.ecapa_embed(
            params, cfg, torch.randn(fb.shape, generator=gen, device=dev)
            * fb.std(), fmask)
    emb = emb / emb.norm(dim=-1, keepdim=True)
    noise = noise / noise.norm(dim=-1, keepdim=True)
    print(f"[ecapa] render self-sim {float((emb * emb).sum(-1).mean()):.3f}"
          f"; render-vs-noise cosine mean "
          f"{float((emb @ noise.t()).mean()):.3f}")
    save_checkpoint(out_path, {"params": params})


def run_eval(corpus: str, cfg_path: str, out_path: str, device: str,
             max_batches: int, ditto_ckpt: str = None, s2t_ckpt: str = None,
             ecapa_ckpt: str = None, sample_seed: int = SEED) -> dict:
    """One ``evaluate`` run in a process of its own."""
    argv = [sys.executable, "-m", "ditto_tts_tpu_torch.scripts.evaluate",
            "--data-path", corpus, "--config", cfg_path, "--out", out_path,
            "--max-batches", str(max_batches), "--batch-size", "4",
            "--seed", str(SEED), "--sample-seed", str(sample_seed),
            "--oracle-ref", "--lenient-duration",
            "--s2t", s2t_ckpt or "random", "--s2t-tiny",
            "--s2t-vocab", assets.S2T_MINI_VOCAB,
            "--ecapa", ecapa_ckpt or "random", "--ecapa-tiny",
            "--smoke-ortho", "--gpt2-config", json.dumps(TINY_GPT2),
            "--device", device]
    if ditto_ckpt:
        argv += ["--ditto", ditto_ckpt]
    subprocess.run(argv, check=True)
    with open(out_path) as f:
        return json.load(f)


METRICS = ("mel_mae_mean", "cer", "wer", "sim_o", "sim_r")


def report(args, seeds, random_agg, trained_agg) -> dict:
    """The JAX script's report: per-arm aggregates, margins, and whether
    each margin exceeds the seeds' spread and discriminates."""
    rnd = {m: random_agg[m]["mean"] for m in random_agg}
    trn = {m: trained_agg[m]["mean"] for m in trained_agg}
    margins = {"mel_mae": rnd["mel_mae_mean"] - trn["mel_mae_mean"],
               "cer": rnd.get("cer", 1.0) - trn.get("cer", 1.0),
               "sim_o": trn.get("sim_o", 0.0) - rnd.get("sim_o", 0.0),
               "sim_r": trn.get("sim_r", 0.0) - rnd.get("sim_r", 0.0)}

    def survives(m, margin):
        spread = (random_agg.get(m, {}).get("std", 0.0)
                  + trained_agg.get(m, {}).get("std", 0.0))
        return bool(abs(margin) > spread)

    return {
        "protocol": (
            "Closed-loop discrimination (Experiments.ipynb cells 10-15 "
            "protocol on a synthetic corpus): a tiny corrected-mode DiTTo "
            "trained to memorize the corpus, then the evaluate twin scored "
            "the random and the trained DiT with identical frozen models and "
            "seeds and oracle-ref scoring; the tiny ASR and ECAPA embedder "
            "are trained on the chain's own oracle renders."),
        "device": args.device,
        "train_steps": args.train_steps, "asr_steps": args.asr_steps,
        "ecapa_steps": args.ecapa_steps, "max_batches": args.max_batches,
        "n_utterances": len(TEXTS), "sample_seeds": seeds,
        "random_weights": random_agg, "trained_weights": trained_agg,
        "margins": margins,
        "margin_survives_seed_spread": {
            "mel_mae": survives("mel_mae_mean", margins["mel_mae"]),
            "cer": survives("cer", margins["cer"]),
            "sim_o": survives("sim_o", margins["sim_o"])},
        "discriminates": {
            "mel_mae": trn["mel_mae_mean"] < rnd["mel_mae_mean"],
            "cer": trn.get("cer", 1.0) < rnd.get("cer", 1.0),
            "trained_cer_below_1": trn.get("cer", 1.0) < 1.0,
            # a cosine gap below 0.02 is noise, not discrimination
            "sim_o": margins["sim_o"] > 0.02},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--train-steps", type=int, default=6000)
    ap.add_argument("--asr-steps", type=int, default=3000)
    ap.add_argument("--ecapa-steps", type=int, default=1600)
    ap.add_argument("--seeds", default="0,1",
                    help="comma-separated sampling seeds (the frozen "
                         "models' init stays fixed)")
    ap.add_argument("--max-batches", type=int, default=8,
                    help="evaluated batches of 4 per run (8: all 32)")
    ap.add_argument("--workdir", default="eval_discrimination_work")
    ap.add_argument("--out", default=None,
                    help="the report (default: WORKDIR/report.json)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    dev = device_of(args)
    out = args.out or os.path.join(args.workdir, "report.json")

    corpus = os.path.join(args.workdir, "mls")
    os.makedirs(args.workdir, exist_ok=True)
    build_corpus(corpus)
    cfg_path = os.path.join(args.workdir, "tiny_config.json")
    with open(cfg_path, "w") as f:
        f.write(TINY.to_json())

    ckpts = {}
    for name, train, steps in (("DiTTO", train_tiny_ditto, args.train_steps),
                               ("S2T", train_tiny_asr, args.asr_steps),
                               ("ECAPA", train_tiny_ecapa, args.ecapa_steps)):
        ckpts[name] = os.path.join(args.workdir, f"{name}_tiny_trained.npz")
        if os.path.exists(ckpts[name]):
            print(f"[{name}] reusing {ckpts[name]}")
        else:
            train(corpus, steps, ckpts[name], dev)

    seeds = [int(s) for s in args.seeds.split(",")]

    def sweep(tag, **kw):
        per_seed = {}
        for s in seeds:
            print(f"[eval] {tag} run, sample seed {s}", flush=True)
            per_seed[s] = run_eval(
                corpus, cfg_path, os.path.join(args.workdir,
                                               f"{tag}_s{s}.json"),
                args.device, args.max_batches, s2t_ckpt=ckpts["S2T"],
                ecapa_ckpt=ckpts["ECAPA"], sample_seed=1000 * s, **kw)
        agg = {}
        for m in METRICS:
            vals = [per_seed[s][m] for s in seeds if m in per_seed[s]]
            if vals:
                agg[m] = {"mean": float(np.mean(vals)),
                          "std": float(np.std(vals)),
                          "per_seed": [float(v) for v in vals]}
        return agg

    rep = report(args, seeds, sweep("random"),
                 sweep("trained", ditto_ckpt=ckpts["DiTTO"]))
    print(json.dumps(rep, indent=2))
    with open(out, "w") as f:
        json.dump(rep, f, indent=2)
    print(f"wrote {out}")
    return rep


if __name__ == "__main__":
    main()
