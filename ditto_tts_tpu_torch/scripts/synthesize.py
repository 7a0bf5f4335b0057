"""Generate speech from a prompt audio file and a text (the JAX package's
``scripts/synthesize.py``; parity: ref SpeechGenerator.
generate_speech_from_file, src/model/SpeechGenerator.py:75).

Example:
  python -m ditto_tts_tpu_torch.scripts.synthesize --audio prompt.wav \\
      --text "bonjour" --encodec /weights/encodec_24khz --gpt2 /weights/gpt2 \\
      --gpt2-vocab vocab.json --gpt2-merges merges.txt \\
      --bigvgan /weights/bigvgan_v2_24khz --ditto ck/DiTTO_final.npz \\
      --nac ck/NAC_final.npz --steps 50 --out out.wav

It serves ``build_synthesize_pipelined`` on ``--device`` (``cuda`` by
default; ``cpu`` runs the kernels' plain versions) with a
``torch.Generator`` seeded from ``--seed``, and writes a 24 kHz mono int16
WAV (clipped to [-1, 1], times 32767, as JAX quantizes; the chain renders
the prompt cut to whole 256-sample mel hops). A weights flag left out
gives random weights from ``--seed`` with a warning. The DiT computes in
fp32, as the JAX CLI's does. The CLI sets nothing global, so on the card
cuDNN may run fp32 convs and the codec LSTM in TF32
(``torch.backends.cudnn.allow_tf32`` is on by default).
"""

from __future__ import annotations

import argparse
import wave

import numpy as np
import torch

from ..config import (DiTConfig, GPT2Config, PipelineConfig, SamplerConfig,
                      ref_trained_dit_config)
from ..data.processing import decode_audio
from ..infer.generator import build_synthesize_pipelined
from ._common import (add_weight_args, device_of, generator_params,
                      gpt2_tokenizer)


def write_wav(path: str, wav: np.ndarray, sample_rate: int) -> int:
    """Mono int16 PCM: clipped to [-1, 1] and scaled by 32767; returns the
    number of samples. A non-finite sample raises (int16 cannot hold it,
    and the cast would write garbage)."""
    if not np.isfinite(wav).all():
        raise ValueError(f"{path}: the waveform has non-finite samples")
    pcm = (np.clip(wav, -1, 1) * 32767).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())
    return len(pcm)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--audio", required=True)
    p.add_argument("--text", required=True)
    p.add_argument("--out", default="output.wav")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--sampler", choices=["ddpm", "ddim"], default="ddpm")
    p.add_argument("--cond-by-audio", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ref-config", action="store_true")
    add_weight_args(p)
    args = p.parse_args(argv)
    dev = device_of(args)

    dit_cfg = (ref_trained_dit_config() if args.ref_config
               else DiTConfig(num_layers=12, num_heads=12))
    cfg = PipelineConfig(dit=dit_cfg, sampler=SamplerConfig(
        num_steps=args.steps, kind=args.sampler))
    params = generator_params(args, cfg, GPT2Config(), dev)

    wav_in = decode_audio(args.audio, cfg.audio.sample_rate)
    audio = torch.from_numpy(wav_in)[None, None, :]
    mask = torch.ones((1, len(wav_in)), dtype=torch.int32)
    tok = gpt2_tokenizer(args)
    text_ids = torch.from_numpy(np.asarray(
        tok(args.text, padding="longest")["input_ids"]))

    fn = build_synthesize_pipelined(cfg, cond_by_audio=args.cond_by_audio,
                                    device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    out = fn(params, audio, mask, text_ids, gen)[0].float().cpu().numpy()
    n = write_wav(args.out, out, cfg.audio.sample_rate)
    print(f"wrote {args.out}: {n} samples "
          f"({n / cfg.audio.sample_rate:.2f}s)")


if __name__ == "__main__":
    main()
