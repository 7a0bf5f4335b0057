"""Faults planted in the program under test, each a context manager: the
comparison has to read every one of them as not correct. The CPU tests
drive a run with each planted (``tests/test_bench_faults.py``), and
``calibrate.py --faults`` reads them on the card at a cell's own size.

Serving: a code altered where the VQ produces it, a waveform altered
where the vocoder produces it, half of the batch left out (the other
half served twice). Training: a step that returns its state unchanged,
half of the batch left out (the mean taken over the rest).
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, name, make):
    real = getattr(module, name)
    setattr(module, name, make(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def alter_code():
    from ditto_tts_tpu_torch.codec import rvq

    def make(real):
        def fault(params, latents, **kw):
            idx = real(params, latents, **kw).clone()
            flat = idx.view(-1)
            flat[3] = (flat[3] + 1) % params["codebook"].shape[0]
            return idx
        return fault
    return _patched(rvq, "vq_indices", make)


def alter_wave():
    from ditto_tts_tpu_torch.models import vocoder

    def make(real):
        def fault(*a, **kw):
            out = real(*a, **kw).clone()
            out[..., 100:110] = 0.0
            return out
        return fault
    return _patched(vocoder, "bigvgan_forward", make)


def half_batch_served():
    import torch
    from ditto_tts_tpu_torch.infer import generator

    def make(real):
        def fault(params, cfg, schedule, taus, x_init, text_emb, **kw):
            h = max(1, x_init.shape[0] // 2)
            out = real(params, cfg, schedule, taus, x_init[:h],
                       text_emb[:h], **kw)
            return torch.cat([out] * (x_init.shape[0] // h + 1))[
                :x_init.shape[0]]
        return fault
    return _patched(generator, "_sample", make)


def state_unchanged():
    from ditto_tts_tpu_torch.train import steps

    def make(real):
        def fault(opt, state, loss_fn, mesh=None):
            _, metrics = real(opt, state, loss_fn, mesh)
            return dict(state, step=state["step"] + 1), metrics
        return fault
    return _patched(steps, "_apply_gradient", make)


def half_batch_trained():
    from ditto_tts_tpu_torch.train import steps

    def make(real):
        def fault(dev, state, frozen, batch):
            out = real(dev, state, frozen, batch)
            return {k: v[:max(1, v.shape[0] // 2)] for k, v in out.items()}
        return fault
    return _patched(steps, "_placed", make)


SERVING = {"alter_code": alter_code, "alter_wave": alter_wave,
           "half_batch": half_batch_served}
TRAINING = {"state_unchanged": state_unchanged,
            "half_batch": half_batch_trained}
