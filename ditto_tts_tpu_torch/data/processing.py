"""Host-side audio preprocessing (the JAX package's ``data/processing.py``).

``decode_audio`` gives mono float32 at a sample rate. WAV, and Ogg-Opus
where libopus loads, go through the native library (``native_loader``:
the C++ decoders and resampler JAX's decode uses, so both packages get the
same samples); anything else, or everything when the library cannot be
built, goes to the ``ffmpeg`` CLI, as in JAX. ``decoder_for`` names the
route a file takes. ``remove_metadata_from_audio_folder`` strips metadata
with ``ffmpeg -map_metadata -1 -c copy``, file by file (ref
Processing.py:27-36).
"""

from __future__ import annotations

import os
import subprocess

import numpy as np

from . import native_loader as nl


def ffmpeg_available() -> bool:
    try:
        subprocess.run(["ffmpeg", "-version"], capture_output=True,
                       check=True)
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def decoder_for(path: str) -> str:
    """``"native wav"``, ``"native opus"`` or ``"ffmpeg"``: the route
    ``decode_audio`` takes for this file."""
    if nl.available():
        with open(path, "rb") as f:
            head = f.read(4)
        if head == b"RIFF":
            return "native wav"
        if head == b"OggS" and nl.opus_available():
            return "native opus"
    return "ffmpeg"


def decode_audio(path: str, sample_rate: int = 24000) -> np.ndarray:
    """An audio file as mono float32 at sample_rate."""
    if decoder_for(path) != "ffmpeg":
        return nl.decode_audio(path, sample_rate)
    cmd = ["ffmpeg", "-v", "error", "-i", path, "-f", "f32le", "-ac", "1",
           "-ar", str(sample_rate), "pipe:1"]
    out = subprocess.run(cmd, capture_output=True, check=True).stdout
    return np.frombuffer(out, np.float32).copy()


def remove_metadata_from_audio_folder(folder: str,
                                      suffix: str = ".opus") -> int:
    """Strip metadata in place by an ffmpeg stream copy; a file that fails
    is reported and skipped. Returns the number rewritten."""
    count = 0
    for root, _, files in os.walk(folder):
        for name in files:
            if not name.endswith(suffix):
                continue
            src = os.path.join(root, name)
            tmp = src + ".tmp" + suffix
            try:
                subprocess.run(
                    ["ffmpeg", "-v", "error", "-y", "-i", src,
                     "-map_metadata", "-1", "-c", "copy", tmp],
                    capture_output=True, check=True)
                os.replace(tmp, src)
                count += 1
            except (OSError, subprocess.CalledProcessError) as e:
                if os.path.exists(tmp):
                    os.remove(tmp)
                print(f"[processing] skipped {src}: {e}")
    return count
