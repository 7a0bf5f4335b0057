"""Evaluation metrics (the JAX package's ``eval/metrics.py``): mel-MAE,
CER / WER and the speaker-similarity loops (ref src/Experiments.ipynb cells
10-15: CER/WER through HF ``evaluate`` over Speech2Text's transcripts,
SIM-o / SIM-r as speechbrain ECAPA cosines).

  * CER / WER are Levenshtein distances over characters / words divided
    by the reference length, computed here (no HF ``evaluate``);
  * mel-MAE, the repo's north-star quality metric (BASELINE.json), is the
    mean |logmel_a - logmel_b| over the common length, on the BigVGAN
    analysis chain (``ops.mel.get_mel_spectrogram``), on the device the
    waveforms are on (numpy input: ``device``, ``cuda`` unless ``"cpu"``);
  * the ASR and speaker-embedding backends are callables the caller
    supplies (``scripts/evaluate.py`` builds them on ``models/s2t.py`` and
    ``models/ecapa.py``).

The JAX ``make_hf_s2t_asr`` loads s2t-medium from the HF hub by name; its
counterpart waits for local copies of those files.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.mel import get_mel_spectrogram


# ---------------------------------------------------------------------------
# text metrics
# ---------------------------------------------------------------------------

def edit_distance(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance (iterative two-row DP)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def cer(references: Sequence[str], hypotheses: Sequence[str]) -> float:
    """Character error rate: sum(edit) / sum(len(ref))."""
    edits = sum(edit_distance(r, h) for r, h in zip(references, hypotheses))
    total = sum(len(r) for r in references)
    return edits / max(total, 1)


def wer(references: Sequence[str], hypotheses: Sequence[str]) -> float:
    """Word error rate over whitespace tokens."""
    edits = sum(edit_distance(r.split(), h.split())
                for r, h in zip(references, hypotheses))
    total = sum(len(r.split()) for r in references)
    return edits / max(total, 1)


# ---------------------------------------------------------------------------
# audio metrics
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def mel_mae(wav_a, wav_b, *, sample_rate: int = 24000, device=None) -> float:
    """Mean absolute error between the log-mel spectrograms of two
    waveforms ([T] or [B, T]), cut to the common length. Tensors stay on
    their device; numpy arrays go to ``device`` (``cuda`` unless the caller
    passes ``"cpu"``)."""
    def tensor(w):
        if isinstance(w, torch.Tensor) and device is None:
            t = w
        else:
            t = torch.as_tensor(w).to(resolve_device(device))
        t = t.float()
        return t[None] if t.ndim == 1 else t

    a, b = tensor(wav_a), tensor(wav_b)
    n = min(a.shape[-1], b.shape[-1])
    with torch.inference_mode():
        mel_a = get_mel_spectrogram(a[..., :n], sample_rate=sample_rate)
        mel_b = get_mel_spectrogram(b[..., :n], sample_rate=sample_rate)
        return float((mel_a - mel_b).abs().mean())


def cosine_similarity(emb_a, emb_b) -> float:
    """Cosine of two embeddings in float64 on the host."""
    a = _host(emb_a).astype(np.float64).ravel()
    b = _host(emb_b).astype(np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


# ---------------------------------------------------------------------------
# evaluation loops over pluggable models (ref Experiments.ipynb cells 11, 14)
# ---------------------------------------------------------------------------

def cer_wer_on_pairs(asr: Callable[[np.ndarray], str],
                     pairs: Sequence[Tuple[np.ndarray, str]]
                     ) -> Tuple[float, float]:
    """``asr(waveform) -> transcript`` over (generated waveform, reference
    text) pairs. The reference feeds 24 kHz audio to a 16 kHz ASR without
    resampling (quirk #11); ``asr`` owns its preprocessing here."""
    refs, hyps = [], []
    for wav, text in pairs:
        refs.append(text)
        hyps.append(asr(wav))
    return cer(refs, hyps), wer(refs, hyps)


def sim_o_sim_r(embed: Callable[[np.ndarray], np.ndarray],
                generated: Sequence[np.ndarray],
                originals: Sequence[np.ndarray],
                reconstructed: Sequence[np.ndarray]
                ) -> Tuple[float, float]:
    """SIM-o / SIM-r: cosine(generated, original) and cosine(generated,
    codec reconstruction), averaged over utterances (ref Experiments.ipynb
    cell 14)."""
    sims_o, sims_r = [], []
    for g, o, r in zip(generated, originals, reconstructed):
        eg = embed(g)
        sims_o.append(cosine_similarity(eg, embed(o)))
        sims_r.append(cosine_similarity(eg, embed(r)))
    return float(np.mean(sims_o)), float(np.mean(sims_r))
