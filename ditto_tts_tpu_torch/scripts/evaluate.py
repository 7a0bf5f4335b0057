"""Evaluate the synthesis chain over an MLS-layout corpus (the JAX
package's ``scripts/evaluate.py``; ref src/Experiments.ipynb cells 10-15,
``cer_wer_on_loader`` / ``compute_sim_o_sim_r`` over up to
``--max-batches`` batches): mel-MAE against the prompt (or, with
``--oracle-ref``, against the chain's own render of the prompt's latents),
CER / WER of an S2T transcript against the text (``--s2t``), and SIM-o /
SIM-r from ECAPA embeddings (``--ecapa``).

Example:
  python -m ditto_tts_tpu_torch.scripts.evaluate --data-path /data/mls/test \\
      --max-batches 5 --encodec /weights/encodec_24khz --gpt2 /weights/gpt2 \\
      --gpt2-vocab vocab.json --gpt2-merges merges.txt \\
      --bigvgan /weights/bigvgan --ditto ck/DiTTO_final.npz \\
      --nac ck/NAC_final.npz --s2t /weights/s2t_medium --steps 50

Batches come unshuffled through ``MLSDataset`` and ``batches`` (the default
buckets) into ``build_synthesize`` on ``--device`` (``cuda`` by default;
``cpu`` runs the kernels' plain versions), with a ``torch.Generator``
seeded from ``--sample-seed`` (default ``--seed``) plus the batch index.
The ASR and speaker legs resample 24 kHz to 16 kHz with ``np.interp``,
take ``log_mel_fbank`` on the host and run ``greedy_decode`` (``max_len``
200, the ``<lang:xx>`` id as forced BOS) and ``ecapa_embed`` on the
device. Random weights (no path, or ``random``) come from ``--seed``: the
serving trees as ``init_generator_params``, the S2T from ``--seed + 5``,
ECAPA from ``--seed + 6``. The results JSON has the JAX script's keys:
``mel_mae_mean``, ``num_utterances`` and, with the models, ``cer``,
``wer``, ``sim_o``, ``sim_r``. The CLI sets nothing global, so on the card
cuDNN may run the fp32 convs (S2T, ECAPA) in TF32
(``torch.backends.cudnn.allow_tf32`` is on by default).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, List, Tuple

import numpy as np
import torch

from ..codec import encodec as codec_mod
from ..config import (DiTConfig, GPT2Config, PipelineConfig, SamplerConfig,
                      ref_trained_dit_config)
from ..data.mls import MLSDataset, batches, default_buckets
from ..eval.metrics import cer, cosine_similarity, mel_mae, wer
from ..infer.generator import (build_synthesize, encode_prompt_latents,
                               latents_to_waveform)
from ..models import ecapa as ecapa_mod
from ..models import s2t as s2t_mod
from ..params import init_ecapa_params, init_s2t_params, tree_map
from ..text.s2t_tokenizer import S2TTokenizer
from ..utils.smoke import orthogonal_reinit
from ..utils.weights import load_state_dict
from ._common import (add_weight_args, checkpoint_params, device_of,
                      generator_params, gpt2_tokenizer)

ASR_MAX_LEN = 200


def tiny_s2t_config() -> s2t_mod.S2TConfig:
    """The ``--s2t-tiny`` geometry (discrimination and smoke runs)."""
    return s2t_mod.S2TConfig(vocab_size=200, d_model=64, encoder_layers=2,
                             decoder_layers=2, encoder_heads=4,
                             decoder_heads=4, encoder_ffn=128,
                             decoder_ffn=128, conv_channels=64)


def _fbank16k(wav24: np.ndarray, n: int) -> np.ndarray:
    """The first ``n`` samples at 24 kHz (fewer where the waveform is
    shorter), linearly resampled to 16 kHz, as a [1, frames, 80] fbank.

    The chain's output has 256 x whole mel frames and at most
    ``max_token_length`` latent frames, so it can be shorter than its
    prompt; the JAX script's ``np.interp`` raises there."""
    n = min(n, len(wav24))
    wav16 = np.interp(np.arange(0, n, 24000 / 16000.0), np.arange(n),
                      wav24[:n]).astype(np.float32)
    return s2t_mod.log_mel_fbank(wav16, 16000)[None]


def build_asr(params, cfg: s2t_mod.S2TConfig, tokenizer: S2TTokenizer,
              forced_bos: int, device) -> Callable[[np.ndarray, int], str]:
    """``asr(wav24, n)``: the transcript of a 24 kHz waveform's first
    ``n`` samples (fbank, ``greedy_decode``, ``tokenizer.decode``)."""
    def asr(wav24: np.ndarray, n: int) -> str:
        fb = torch.from_numpy(_fbank16k(wav24, n)).to(device)
        ids = s2t_mod.greedy_decode(
            params, cfg, fb, torch.ones(fb.shape[:2], dtype=torch.int32,
                                        device=device),
            forced_bos_id=forced_bos, max_len=ASR_MAX_LEN)
        return tokenizer.decode(ids[0].cpu().tolist())
    return asr


def build_embed(params, cfg: ecapa_mod.ECAPAConfig,
                device) -> Callable[[np.ndarray, int], np.ndarray]:
    """``embed(wav24, n)``: the ECAPA embedding [D] of a 24 kHz waveform's
    first ``n`` samples (resampled to a 16 kHz fbank)."""
    def embed(wav24: np.ndarray, n: int) -> np.ndarray:
        fb = torch.from_numpy(_fbank16k(wav24, n)).to(device)
        with torch.inference_mode():
            return ecapa_mod.ecapa_embed(params, cfg, fb)[0].cpu().numpy()
    return embed


def _tree(path: str, importer, cfg, seed: int, init, device):
    """A model tree on ``device``: random (``random``), a native ``.npz``
    checkpoint, or imported from a weights path."""
    if path == "random":
        return init(cfg, seed, device)
    tree = checkpoint_params(path) if path.endswith(".npz") else \
        importer(load_state_dict(path), cfg)
    return tree_map(lambda t: t.to(device), tree)


def _timed(times: dict, stage: str, fn, *args, **kw):
    """``fn(*args, **kw)``, its seconds added to ``times[stage]``. Every
    stage ends in a copy to the host, so the host clock spans its device
    work."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    times[stage] = times.get(stage, 0.0) + time.perf_counter() - t0
    return out


def evaluate_batch(params, cfg: PipelineConfig, synthesize, batch: dict,
                   generator, device, *, tok, asr=None, embed=None,
                   oracle_ref: bool = False) -> Tuple[List[dict], dict]:
    """One collated batch through the chain and the scorers: the
    synthesis, with ``--oracle-ref`` the render of the prompt's own latents
    (``encode_prompt_latents`` + ``latents_to_waveform``), and for each
    utterance mel-MAE, with ``asr`` the reference (the text, or the ASR of
    the oracle render) and the hypothesis transcript, with ``embed`` SIM-o
    and SIM-r (the second against a codec round trip of the prompt).

    Returns (one dict per utterance: ``ref``, ``hyp``, ``mel_mae``,
    ``sim_o``, ``sim_r``, and ``s``, its seconds per stage; the batch's
    seconds per stage: ``synthesis``, ``oracle``)."""
    times = {}
    audio = torch.from_numpy(batch["audio"]).to(device)
    mask = torch.from_numpy(batch["padding_mask"]).to(device)
    wav = _timed(times, "synthesis", lambda: synthesize(
        params, audio, mask, batch["text_ids"], generator).float().cpu()
        .numpy())

    @torch.inference_mode()
    def oracle():
        lat = encode_prompt_latents(params, cfg, audio, mask)
        return latents_to_waveform(params, cfg, lat,
                                   output_length=audio.shape[-1]).float() \
            .cpu().numpy()

    ref_wavs = _timed(times, "oracle", oracle) if oracle_ref else None
    rows = []
    for r in range(wav.shape[0]):
        s, row = {}, {"ref": None, "hyp": None, "sim_o": None,
                      "sim_r": None}
        n = int(batch["padding_mask"][r].sum())
        ref_audio = (ref_wavs[r] if ref_wavs is not None
                     else batch["audio"][r, 0])
        row["mel_mae"] = _timed(s, "mel_mae", mel_mae, wav[r][None, :n],
                                ref_audio[None, :n], device=device)
        if oracle_ref and asr is not None:
            # the reference transcript is the ASR of the oracle render, so
            # the comparison isolates the refined latents' fidelity
            row["ref"] = _timed(s, "asr", asr, ref_audio, n)
        else:
            row["ref"] = tok.decode(
                [t for t, m in zip(batch["text_ids"][r],
                                   batch["text_mask"][r]) if m])
        if embed is not None:
            # SIM-o: generated vs the prompt (or its oracle render); SIM-r:
            # generated vs the codec's reconstruction (ref
            # Experiments.ipynb cells 13-15)
            @torch.inference_mode()
            def round_trip():
                codes = codec_mod.codec_encode(
                    params.codec, cfg.codec, audio[r:r + 1], mask[r:r + 1])
                return codec_mod.codec_decode(
                    params.codec, cfg.codec, codes,
                    output_length=n)[0, 0].float().cpu().numpy()

            recon = _timed(s, "codec", round_trip)
            e_gen = _timed(s, "ecapa", embed, wav[r], n)
            row["sim_o"] = cosine_similarity(
                e_gen, _timed(s, "ecapa", embed, ref_audio, n))
            row["sim_r"] = cosine_similarity(
                e_gen, _timed(s, "ecapa", embed, recon, n))
        if asr is not None:
            row["hyp"] = _timed(s, "asr", asr, wav[r], n)
        row["s"] = s
        rows.append(row)
    return rows, times


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-path", required=True)
    p.add_argument("--max-batches", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--steps", type=int, default=None,
                   help="sampler steps (default: the config's)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sample-seed", type=int, default=None,
                   help="sampling-noise seed (default: --seed), so a seed "
                        "study varies the sampler while the random weights "
                        "stay fixed")
    p.add_argument("--out", default="eval_results.json")
    add_weight_args(p)
    p.add_argument("--ecapa", default=None,
                   help="speechbrain ECAPA weights for SIM-o/SIM-r; "
                        "'random' for a smoke run")
    p.add_argument("--s2t-vocab", default=None,
                   help="Speech2Text vocab.json for transcript decoding; "
                        "omitted: the placeholder vocabulary")
    p.add_argument("--s2t-lang", default="fr")
    p.add_argument("--s2t", default=None,
                   help="local s2t weights (a snapshot, or a .npz "
                        "checkpoint); 'random' for a smoke run")
    p.add_argument("--ref-config", action="store_true")
    p.add_argument("--config", default=None,
                   help="PipelineConfig JSON path (overrides --ref-config "
                        "and the default geometry)")
    p.add_argument("--ecapa-tiny", action="store_true",
                   help="tiny ECAPA geometry (runs without the real "
                        "speechbrain snapshot)")
    p.add_argument("--s2t-tiny", action="store_true",
                   help="tiny random ASR geometry (runs without the real "
                        "s2t snapshot)")
    p.add_argument("--oracle-ref", action="store_true",
                   help="score against the chain's own render of the "
                        "ground-truth latents (VQ -> codec -> mel -> "
                        "vocoder) instead of the prompt audio: with random "
                        "frozen models the raw waveform is out of reach by "
                        "construction")
    p.add_argument("--lenient-duration", action="store_true",
                   help="accept clips outside the 10-20 s MLS bound")
    p.add_argument("--gpt2-config", default=None,
                   help="GPT2Config overrides as a JSON file path or an "
                        "inline JSON object (tiny-geometry runs)")
    p.add_argument("--smoke-ortho", action="store_true",
                   help="orthogonal re-init of RANDOM codec / vocoder "
                        "weights (utils/smoke.py), without which a random "
                        "codec maps every input to the same codes; loaded "
                        "weights are left alone")
    return p.parse_args(argv)


def pipeline_config(args) -> PipelineConfig:
    if args.config:
        with open(args.config) as f:
            cfg = PipelineConfig.from_json(f.read())
        if args.steps:
            cfg = cfg.replace(
                sampler=cfg.sampler.replace(num_steps=args.steps))
        return cfg
    dit_cfg = (ref_trained_dit_config() if args.ref_config
               else DiTConfig(num_layers=12, num_heads=12))
    return PipelineConfig(dit=dit_cfg,
                          sampler=SamplerConfig(num_steps=args.steps or 50))


def gpt2_config(args) -> GPT2Config:
    if not args.gpt2_config:
        return GPT2Config()
    raw = args.gpt2_config
    if os.path.exists(raw):
        with open(raw) as f:
            raw = f.read()
    return GPT2Config(**json.loads(raw))


def main(argv=None):
    args = parse_args(argv)
    dev = device_of(args)
    cfg = pipeline_config(args)

    def smoke(tree):
        return orthogonal_reinit(tree, seed=args.seed)

    params = generator_params(args, cfg, gpt2_config(args), dev,
                              smoke=smoke if args.smoke_ortho else None)

    asr = None
    if args.s2t:
        s2t_cfg = (tiny_s2t_config() if args.s2t_tiny
                   else s2t_mod.s2t_medium_config())
        if args.s2t == "random":
            print("[warn] --s2t random: random ASR weights (smoke only)")
        s2t_params = _tree(args.s2t, s2t_mod.import_hf_state_dict, s2t_cfg,
                           args.seed + 5, init_s2t_params, dev)
        if args.s2t_vocab:
            s2t_tok = S2TTokenizer.from_file(args.s2t_vocab)
        else:
            print("[warn] --s2t-vocab missing: placeholder vocab "
                  "(CER/WER is text-vs-text but not the trained mapping)")
            s2t_tok = S2TTokenizer.placeholder(s2t_cfg.vocab_size)
        # the forced BOS is the vocabulary's <lang:xx> id (ref
        # src/model/Speech2Text.py:11 tokenizer.lang_code_to_id["fr"])
        forced_bos = s2t_tok.lang_code_to_id[args.s2t_lang]
        print(f"[eval] s2t ASR loaded; <lang:{args.s2t_lang}> id "
              f"{forced_bos}")
        asr = build_asr(s2t_params, s2t_cfg, s2t_tok, forced_bos, dev)

    embed = None
    if args.ecapa:
        ecapa_cfg = (ecapa_mod.tiny_ecapa_config() if args.ecapa_tiny
                     else ecapa_mod.ECAPAConfig())
        if args.ecapa == "random":
            print("[warn] --ecapa random: random speaker-embedding weights")
        embed = build_embed(_tree(
            args.ecapa, ecapa_mod.import_speechbrain_state_dict, ecapa_cfg,
            args.seed + 6, init_ecapa_params, dev), ecapa_cfg, dev)
    tok = gpt2_tokenizer(args)

    ds = MLSDataset(args.data_path, tok, cfg.dit.max_token_length,
                    tokenizer_name="gpt2",
                    strict_duration=not args.lenient_duration)
    synthesize = build_synthesize(cfg, device=dev)

    buckets = default_buckets(cfg.audio.sample_rate,
                              cfg.audio.min_audio_seconds,
                              cfg.audio.max_audio_seconds)
    sseed = args.seed if args.sample_seed is None else args.sample_seed
    rows = []
    for bi, batch in enumerate(batches(ds, args.batch_size, buckets=buckets,
                                       shuffle=False)):
        if bi >= args.max_batches:
            break
        gen = torch.Generator(device=dev).manual_seed(sseed + bi)
        utts, stages = evaluate_batch(params, cfg, synthesize, batch, gen,
                                      dev, tok=tok, asr=asr, embed=embed,
                                      oracle_ref=args.oracle_ref)
        rows += utts
        for u in utts:
            for k, v in u["s"].items():
                stages[k] = stages.get(k, 0.0) + v
        secs = batch["audio"].shape[-1] / cfg.audio.sample_rate
        print(f"[eval] batch {bi} ({len(utts)} x {secs:g} s): " + ", ".join(
            f"{k} {v:.3f} s" for k, v in stages.items()))

    results = {"mel_mae_mean": float(np.mean([u["mel_mae"] for u in rows])),
               "num_utterances": len(rows)}
    if asr is not None:
        refs, hyps = [u["ref"] for u in rows], [u["hyp"] for u in rows]
        results["cer"] = cer(refs, hyps)
        results["wer"] = wer(refs, hyps)
    if embed is not None:
        results["sim_o"] = float(np.mean([u["sim_o"] for u in rows]))
        results["sim_r"] = float(np.mean([u["sim_r"] for u in rows]))
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
