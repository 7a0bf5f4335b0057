"""The port's data layer against the JAX package: the GPT2 BPE tokenizer,
``decode_audio`` (WAV at 24 kHz, WAV resampled, Ogg-Opus where libopus
loads), the MLS manifest and its cache file read across packages,
``batches`` and ``batches_native``, the latent cache (``precompute`` and
``latent_batches``: JAX's index and latents, bit-identity with a direct
encode of the same members), and ``load_state_dict``.

Decode, manifest, batches and cached-versus-direct latents are held bit
for bit; the port's cached fp32 latents against JAX's to 1e-5, the codec
parity tolerance (tests/test_torch_codec_vocoder.py). The corpus is tiny
(a 2400 Hz sample rate keeps the tiny codec's LSTM short), WAV bytes under
MLS's ``.opus`` names, as tests/test_latent_cache.py writes it.
"""

import json
import os
import shutil
import wave

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ditto_tts_tpu.data import latents as jlat
from ditto_tts_tpu.data import mls as jmls
from ditto_tts_tpu.data import native_loader as jnl
from ditto_tts_tpu.data import processing as jproc
from ditto_tts_tpu.text import tokenizers as jtok
from ditto_tts_tpu.utils import weights as jweights

from ditto_tts_tpu_torch import assets as tassets
from ditto_tts_tpu_torch.data import latents as tlat
from ditto_tts_tpu_torch.data import mls as tmls
from ditto_tts_tpu_torch.data import native_loader as tnl
from ditto_tts_tpu_torch.data import processing as tproc
from ditto_tts_tpu_torch.params import tree_map
from ditto_tts_tpu_torch.text import tokenizers as ttok
from ditto_tts_tpu_torch.utils import weights as tweights

from _torch_port_util import (CODEC_CFG, jax_generator_params, numpy_tree,
                              to_torch_cfg, tt, varied_codebooks)

SR = 2400
BUCKETS = (1600, 3200)
DURATIONS = [0.5, 0.55, 0.6, 0.62, 1.1, 1.2]
FRENCH = ["Le cœur a ses raisons que la raison ne connaît point.",
          "À l'école, élève Noël — déjà où ça? 123 «naïve» façade!"]


def _write_wav(path, seconds, freq, sr=SR):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t = np.arange(int(seconds * sr)) / sr
    pcm = (0.3 * np.sin(2 * np.pi * freq * t) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


@pytest.fixture()
def corpus(tmp_path):
    root = tmp_path / "mls"
    lines = []
    for i, secs in enumerate(DURATIONS):
        utt = f"10{i}_20{i}_000000"
        _write_wav(root / "audio_clean" / f"10{i}" / f"20{i}" /
                   f"{utt}.opus", secs, 150.0 + 40 * i)
        lines.append(f"{utt}\t{FRENCH[i % 2]} {i}")
    # a transcript line without audio and a malformed one are skipped
    lines += ["999_999_000000\tmissing", "no tab here"]
    (root / "transcripts.txt").write_text("\n".join(lines), encoding="utf-8")
    return str(root)


def _datasets(corpus, **kw):
    args = dict(sample_rate=SR, tokenizer_name="byt5",
                strict_duration=False, **kw)
    j = jmls.MLSDataset(corpus, jtok.ByT5Tokenizer(), 96, **args)
    t = tmls.MLSDataset(corpus, ttok.ByT5Tokenizer(), 96, **args)
    return j, t


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ---------------------------------------------------------------------------
# the GPT2 tokenizer
# ---------------------------------------------------------------------------

def _bpe_files(tmp_path):
    """A byte-level vocabulary with a few merges, so the BPE loop runs."""
    byte_map = ttok._bytes_to_unicode()
    vocab = {byte_map[b]: i for i, b in enumerate(range(256))}
    merges = [("Ġ", "l"), ("e", "s"), ("Ã", "©"), ("o", "u"), ("Ġl", "a"),
              ("Ġ", "Ã©"), ("ou", "r")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges),
        encoding="utf-8")
    return str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt")


def test_gpt2_tokenizer_matches_jax(tmp_path):
    from ditto_tts_tpu import assets as jassets
    vocab, merges = _bpe_files(tmp_path)
    pairs = [(tassets.gpt2_mini_tokenizer(), jassets.gpt2_mini_tokenizer()),
             (ttok.GPT2Tokenizer(vocab, merges),
              jtok.GPT2Tokenizer(vocab, merges))]
    for got, want in pairs:
        assert got.pad_token_id == got.eos_token_id == want.pad_token_id
        for text in FRENCH:
            ids = got.encode(text)
            assert ids == want.encode(text)
            assert got.decode(ids) == text
        out, ref = got(FRENCH, max_length=48), want(FRENCH, max_length=48)
        for k in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(out[k], ref[k])
    # the merges shorten the ids
    assert len(pairs[1][0].encode(FRENCH[1])) < \
        len(pairs[0][0].encode(FRENCH[1]))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["wav 24 kHz", "wav 16 kHz", "opus"])
def test_decode_audio_matches_jax(tmp_path, kind):
    rng = np.random.default_rng(2)
    path = str(tmp_path / "clip.opus")
    if kind == "opus":
        if not tnl.opus_available():
            pytest.skip("libopus does not load here")
        pcm = (0.3 * rng.standard_normal(24000)).astype(np.float32)
        tnl.encode_opus(path, pcm, 24000)
        want_route = "native opus"
    else:
        sr = 24000 if kind == "wav 24 kHz" else 16000
        _write_wav(path, 0.7, 330.0, sr=sr)
        want_route = "native wav"
    assert tproc.decoder_for(path) == want_route
    for rate in (24000, SR):
        got = tproc.decode_audio(path, rate)
        want = jproc.decode_audio(path, rate)
        assert got.dtype == np.float32 and len(got) > 0
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tnl.decode_wav(path, 24000),
                                  jnl.decode_wav(path, 24000))


def test_native_library_builds_outside_the_jax_tree():
    """The port builds its own library from native/'s sources into
    .kernel_build/; the resampler equals JAX's."""
    assert tnl.available()
    assert tnl._lib_path().parent.name == ".kernel_build"
    x = np.random.default_rng(0).standard_normal(999).astype(np.float32)
    for rates in ((24000, 24000), (16000, 24000), (48000, 24000)):
        np.testing.assert_array_equal(tnl.resample(x, *rates),
                                      jnl.resample(x, *rates))


def test_unknown_container_goes_to_ffmpeg(tmp_path):
    path = tmp_path / "clip.flac"
    path.write_bytes(b"fLaC" + bytes(64))
    assert tproc.decoder_for(str(path)) == "ffmpeg"
    assert tproc.ffmpeg_available() == jproc.ffmpeg_available()


# ---------------------------------------------------------------------------
# manifest and batches
# ---------------------------------------------------------------------------

def test_manifest_cache_crosses_packages(corpus, tmp_path):
    """JAX writes tokenized_byt5_96.json and the port reads it, and the
    other way round in a fresh copy; entries, items and labels agree."""
    jds, tds = _datasets(corpus)
    cache = os.path.join(corpus, "tokenized_byt5_96.json")
    assert os.path.exists(cache) and tds.entries == jds.entries
    assert len(tds) == len(DURATIONS)
    other = str(tmp_path / "copy")
    shutil.copytree(corpus, other)
    os.remove(os.path.join(other, "tokenized_byt5_96.json"))
    t2 = tmls.MLSDataset(other, ttok.ByT5Tokenizer(), 96, sample_rate=SR,
                         tokenizer_name="byt5", strict_duration=False)
    j2 = jmls.MLSDataset(other, jtok.ByT5Tokenizer(), 96, sample_rate=SR,
                         tokenizer_name="byt5", strict_duration=False)
    with open(os.path.join(other, "tokenized_byt5_96.json")) as f:
        written = json.load(f)
    assert written == t2.entries == j2.entries
    assert [e[1:] for e in t2.entries] == [e[1:] for e in tds.entries]
    for i in range(len(tds)):
        got, want = tds[i], jds[i]
        for k in want:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # shards and nb_samples take the same entries
    _, a = _datasets(corpus, shard_index=1, num_shards=2, nb_samples=2)
    b, _ = _datasets(corpus, shard_index=1, num_shards=2, nb_samples=2)
    assert a.entries == b.entries == tds.entries[1::2][:2]


def test_strict_duration_and_labels(corpus):
    """The 10-20 s bound and clip(int(s) - 10, 0, 10), on a 24 kHz read of
    the same files (a 0.5 s clip is out of bounds, as in JAX)."""
    ds = tmls.MLSDataset(corpus, ttok.ByT5Tokenizer(), 24,
                         tokenizer_name="byt5")
    with pytest.raises(ValueError, match="out of"):
        ds[0]
    assert tmls.default_buckets() == jmls.default_buckets() == (
        240000, 300000, 360000, 420000, 480000)
    for n in (1, 240000, 240001, 10 ** 7):
        assert tmls.bucket_for(n, BUCKETS) == jmls.bucket_for(n, BUCKETS)


@pytest.mark.parametrize("shuffle,drop", [(True, True), (False, False)])
def test_batches_match_jax(corpus, shuffle, drop):
    jds, tds = _datasets(corpus)
    _assert_batches_equal(
        tmls.batches(tds, 4, buckets=BUCKETS, shuffle=shuffle, seed=3,
                     drop_remainder=drop),
        jmls.batches(jds, 4, buckets=BUCKETS, shuffle=shuffle, seed=3,
                     drop_remainder=drop))
    b = next(tmls.batches(tds, 6, buckets=BUCKETS, shuffle=False))
    # the padding is marked 0 (quirk #6 corrected)
    n = (b["padding_mask"] == 1).sum(axis=1)
    assert list(n) == [int(s * SR) for s in DURATIONS]
    assert not b["audio"][0, 0, n[0]:].any()


def _by_text(batches):
    """{text ids: (samples, mask sum, label)} over batches of any order and
    padding."""
    out = {}
    for b in batches:
        for r in range(len(b["label"])):
            n = int(b["padding_mask"][r].sum())
            out[tuple(b["text_ids"][r])] = (b["audio"][r, 0, :n].copy(), n,
                                            int(b["label"][r]))
    return out


def test_batches_native_match_jax_and_the_python_batches(corpus):
    jds, tds = _datasets(corpus)
    # one worker: JAX's batches in JAX's order
    _assert_batches_equal(
        tmls.batches_native(tds, 2, buckets=BUCKETS, workers=1, seed=5),
        jmls.batches_native(jds, 2, buckets=BUCKETS, workers=1, seed=5))
    # several workers: the same batches in an order of their own, and the
    # same items as the Python collate
    native = list(tmls.batches_native(tds, 2, buckets=BUCKETS, workers=3,
                                      seed=5))
    assert len(native) == 3
    got = _by_text(native)
    want = _by_text(tmls.batches(tds, 2, buckets=BUCKETS, seed=1))
    assert sorted(got) == sorted(want)
    for key, (audio, n, label) in want.items():
        np.testing.assert_array_equal(got[key][0], audio)
        assert got[key][1:] == (n, label)


# ---------------------------------------------------------------------------
# the latent cache
# ---------------------------------------------------------------------------

def _frozen(ds):
    npt = numpy_tree(jax_generator_params())
    audio = tmls.collate([ds[i] for i in range(len(ds))], BUCKETS)["audio"]
    return {"codec": varied_codebooks(npt["codec"], audio),
            "embedding_head": npt["embedding_head"]}


def test_latent_cache_matches_jax_and_a_direct_encode(corpus, tmp_path):
    jds, tds = _datasets(corpus)
    frozen = _frozen(tds)
    tfrozen = tree_map(tt, frozen)
    jfrozen = jax.tree_util.tree_map(jnp.asarray, frozen)
    tcfg = to_torch_cfg(CODEC_CFG)
    for dtype in ("float32", "bfloat16"):
        tdir = str(tmp_path / f"t_{dtype}")
        index = tlat.precompute(tds, tfrozen, tcfg, cache_dir=tdir,
                                batch_size=4, buckets=BUCKETS,
                                encode_dtype=dtype, device="cpu")
        assert sorted(os.listdir(tdir)) == ["bucket_1600.npy",
                                            "bucket_3200.npy", "index.json"]
        encode = tlat.make_encode_fn(tcfg, dtype)
        seen = set()
        for b in tlat.latent_batches(tdir, tds, 2, shuffle=True, seed=3):
            idxs = list(b["indices"])
            seen.update(idxs)
            audio = tmls.collate([tds[i] for i in idxs], BUCKETS)
            direct = encode(tfrozen, tt(audio["audio"]),
                            tt(audio["padding_mask"])).numpy()
            np.testing.assert_array_equal(b["latents"], direct)
            np.testing.assert_array_equal(b["text_ids"], audio["text_ids"])
            np.testing.assert_array_equal(b["label"], audio["label"])
        assert seen == set(range(len(DURATIONS)))
        assert tlat.precompute(tds, tfrozen, tcfg, cache_dir=tdir,
                               device="cpu") == index       # a no-op

    # fp32: JAX's index, JAX's latents, and each package reads the other's
    jdir = str(tmp_path / "j_float32")
    jindex = jlat.precompute(jds, jfrozen, CODEC_CFG, cache_dir=jdir,
                             batch_size=4, buckets=BUCKETS,
                             encode_dtype="float32")
    tdir = str(tmp_path / "t_float32")
    with open(os.path.join(tdir, "index.json")) as f:
        assert json.load(f) == jindex
    for blen in BUCKETS:
        got = np.load(os.path.join(tdir, f"bucket_{blen}.npy"))
        want = np.load(os.path.join(jdir, f"bucket_{blen}.npy"))
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    _assert_batches_equal(
        tlat.latent_batches(jdir, tds, 2, seed=4),
        jlat.latent_batches(jdir, jds, 2, seed=4))
    _assert_batches_equal(
        jlat.latent_batches(tdir, jds, 2, seed=4),
        tlat.latent_batches(tdir, tds, 2, seed=4))
    with pytest.raises(ValueError, match="re-run precompute"):
        next(tlat.latent_batches(tdir, _datasets(corpus, nb_samples=3)[1],
                                 2))


# ---------------------------------------------------------------------------
# load_state_dict
# ---------------------------------------------------------------------------

def test_load_state_dict_matches_jax(tmp_path):
    pytest.importorskip("safetensors")
    from safetensors.torch import save_file
    gen = torch.Generator().manual_seed(0)
    sd = {"a.weight": torch.randn(3, 4, generator=gen),
          "a.bias": torch.randn(3, generator=gen).half()}
    (tmp_path / "d").mkdir()
    save_file(sd, str(tmp_path / "d" / "m.safetensors"))
    save_file({"b": torch.randn(2, generator=gen).bfloat16()},
              str(tmp_path / "bf16.safetensors"))
    torch.save({"model_state_dict": sd}, str(tmp_path / "m.pth"))
    for path in ("d/m.safetensors", "d", "bf16.safetensors", "m.pth"):
        got = tweights.load_state_dict(str(tmp_path / path))
        want = jweights.load_state_dict(str(tmp_path / path))
        assert sorted(got) == sorted(want), path
        for k in want:
            assert got[k].dtype == want[k].dtype, (path, k)
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(FileNotFoundError):
        tweights.load_state_dict(str(tmp_path / "nothing"))
