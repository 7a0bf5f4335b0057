"""The train steps of the three models (the JAX ``train/steps.py``:
``make_adamw``, ``build_ditto_train_step``, ``build_nac_train_step`` and
``build_slp_train_step``).

Each builder returns ``(init_state, step_fn, eval_fn)`` and runs on
``device`` (``cuda`` unless the caller passes ``"cpu"``): ``init_state``
puts the trainable tree there, ``step_fn(state, frozen, batch,
generator=None)`` and ``eval_fn`` move the batch (tensors or numpy
arrays, as ``data/`` yields them) there and raise on a state or frozen
tree that lies elsewhere. ``step_fn`` differentiates the loss with
respect to the trainable leaves (zeros for a leaf the loss does not read,
as ``jax.grad`` gives), applies AdamW and adds one to ``step``;
``eval_fn`` returns the metrics without a step. The states are JAX's
(``params.py``), so checkpoints cross.

  * DiTTo (``build_ditto_train_step``): the frozen encode under ``torch.no_grad()``: a batch's ``"latents"``
    ([B, T, H], channel-meaned) as they are, else the audio through the
    EnCodec encoder at 1.5 kbps (kernel B on the card, in ``encode_dtype``)
    and the embedding head, channel-meaned; latents cut to GPT2's
    ``n_positions`` frames, text ids to the latents' length, then GPT2's
    ``wte``. The loss: t ~ U[0, diffusion_steps), noise, ``q_sample`` (the
    reference's inverted schedule under ``ref_compat``), the DiT with
    cross-attention dropout from the step's generator, and the MSE against
    the eps / v / x0 target; ``eval_fn`` keeps dropout on, as JAX's (whose
    ``eval_fn`` passes the key too). A ``torch.Generator`` on the device
    stands in for JAX's key: t, then the noise, then the dropout masks, as
    ``jax.random.split(key, 3)`` orders them; ``t=`` and ``noise=`` replace
    the first two draws (parity runs).
  * NAC (``build_nac_train_step``): ``models.nac.nac_forward`` (frozen
    codec and GPT2; the straight-through VQ, or quirk #4 under
    ``ref_compat``); the loss is ``total_loss``, the metrics every scalar
    it returns. The generator is not read (nor is JAX's key).
  * SLP (``build_slp_train_step``): ``models.slp.slp_forward`` (frozen
    codec and ByT5), fp32 log-softmax cross-entropy over the duration
    classes; metrics ``loss`` and ``accuracy`` (the first index wins an
    argmax tie, as ``jnp.argmax``). The generator is not read.

Each step records the spans (``utils/profiling.py``) ``train.step`` over
``train.place`` (``_placed``), ``train.encode`` (the DiTTo frozen encode),
``train.forward`` (the loss), ``train.backward`` (``torch.autograd.grad``)
and ``train.optimizer`` (the gradient's mean over the data group and
AdamW).

AdamW is optax's ``adamw`` (the reference's torch.optim.AdamW defaults:
betas (0.9, 0.999), eps 1e-8, weight decay 1e-6, decay decoupled and
applied after the moment update, bias correction from an int32 count),
over one flat fp32 vector in ``ravel_tree`` order (``flat``, JAX's
``make_adamw(flat=True)``) or leaf by leaf. ``torch.optim.AdamW`` is not
used: its state layout is not JAX's, and it decays before the step.

Under a mesh (``mesh=``, a ``parallel.mesh.Mesh``; None for one process)
the state is this rank's share (``parallel/train_setup.py``) and the
batch its rows of the global batch. The gradient averages over the data
group (one all-reduce of every gradient raveled into one vector) and so do
the metrics: every loss here is a plain mean over equal per-rank rows, so
the mean of the ranks' means is the global mean, as JAX reports it. The
DiTTo step draws t, the noise and the dropout masks for the global batch
and keeps its rows (``t=`` / ``noise=`` are the global draws too), so a
mesh step takes the draws of one process stepping the global batch; the
DiT and the SLP decoder run tensor-parallel over the model group
(``models/dit.py``, ``nn/transformer.py``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .. import resolve_device
from ..config import (ByT5Config, CodecConfig, DiTConfig, GPT2Config,
                      NACConfig, SLPConfig)
from ..diffusion.schedule import NoiseSchedule, q_sample
from ..models import dit as dit_mod
from ..models import nac as nac_mod
from ..models import slp as slp_mod
from ..params import (new_train_state, ravel_tree, tree_leaves, tree_map,
                      tree_unflatten, zero_adamw_state)
from ..text import gpt2 as gpt2_mod
from ..utils.profiling import span


class AdamW:
    """optax ``adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay)`` in
    torch, out of place: ``init(params) -> opt_state`` and
    ``update(grads, opt_state, params) -> (params, opt_state)``."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, learning_rate: float, weight_decay: float = 1e-6,
                 flat: bool = True):
        self.lr = learning_rate
        self.weight_decay = weight_decay
        self.flat = flat

    def init(self, params):
        return zero_adamw_state(params, self.flat)

    def _leaf(self, p, g, mu, nu, count):
        """optax's scale_by_adam -> add_decayed_weights -> scale(-lr) ->
        apply_updates on one tensor; ``count`` is the incremented count."""
        mu = (1.0 - self.b1) * g + self.b1 * mu
        nu = (1.0 - self.b2) * (g * g) + self.b2 * nu
        c = count.float()
        mu_hat = mu / (1.0 - torch.pow(self.b1, c))
        nu_hat = nu / (1.0 - torch.pow(self.b2, c))
        upd = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        upd = upd + self.weight_decay * p
        return (p + (-self.lr) * upd).to(p.dtype), mu, nu

    def update(self, grads, opt_state, params):
        (st,) = opt_state
        count = st["count"] + 1
        if self.flat:
            flat_p, unravel = ravel_tree(params)
            flat_g, _ = ravel_tree(grads)
            p, mu, nu = self._leaf(flat_p, flat_g, st["mu"], st["nu"], count)
            new_params = unravel(p)
        else:
            cols = [[leaf for _, leaf in tree_leaves(tree)]
                    for tree in (params, grads, st["mu"], st["nu"])]
            new = [self._leaf(p, g, m, n, count) for p, g, m, n in zip(*cols)]
            new_params, mu, nu = (tree_unflatten(params,
                                                 [n[j] for n in new])
                                  for j in range(3))
        return new_params, [{"count": count, "mu": mu, "nu": nu}]


def make_adamw(learning_rate: float, weight_decay: float = 1e-6,
               flat: bool = True) -> AdamW:
    """The JAX ``make_adamw``: optax AdamW, over one flat vector by
    default."""
    return AdamW(learning_rate, weight_decay, flat)


def _placed(dev: torch.device, state, frozen, batch) -> Dict:
    """The batch's tensors or numpy arrays as tensors on ``dev``; raises if
    the state or the frozen tree lies elsewhere."""
    with span("train.place"):
        for what, tree in (("state", state), ("frozen", frozen)):
            for path, leaf in tree_leaves(tree):
                if leaf.device.type != dev.type:
                    raise ValueError(
                        f"the train step runs on {dev.type}, but {what}"
                        f"{path} lies on {leaf.device}")
        return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def _data_mean(tensors, mesh) -> list:
    """Each tensor's mean over the mesh's data group, from one all-reduce
    of them raveled into one fp32 vector (the identity without one)."""
    tensors = list(tensors)
    if mesh is None or mesh.data == 1:
        return tensors
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    flat = mesh.all_reduce(flat, "data") / mesh.data
    parts = torch.split(flat, [t.numel() for t in tensors])
    return [p.view(t.shape).to(t.dtype) for p, t in zip(parts, tensors)]


def _metrics_mean(metrics: Dict, mesh) -> Dict:
    return dict(zip(metrics, _data_mean((v.detach() for v in
                                         metrics.values()), mesh)))


def _apply_gradient(opt: AdamW, state, loss_fn, mesh=None
                    ) -> Tuple[Dict, Dict]:
    """One optimizer step: ``loss_fn(params) -> (loss, metrics)`` is
    differentiated with respect to every parameter leaf (zeros for a leaf
    it does not read, as ``jax.grad`` gives them), the gradient averaged
    over the data group, AdamW updates the state, ``step`` adds one; the
    metrics come back detached, averaged over the data group."""
    params = tree_map(lambda p: p.detach().requires_grad_(), state["params"])
    leaves = [leaf for _, leaf in tree_leaves(params)]
    with torch.enable_grad():
        with span("train.forward"):
            loss, metrics = loss_fn(params)
        with span("train.backward"):
            grad_leaves = torch.autograd.grad(loss, leaves,
                                              allow_unused=True,
                                              materialize_grads=True)
    with span("train.optimizer"):
        new_params, opt_state = opt.update(
            tree_unflatten(params, _data_mean(grad_leaves, mesh)),
            state["opt_state"], tree_map(torch.detach, params))
    return ({"params": new_params, "opt_state": opt_state,
             "step": state["step"] + 1}, _metrics_mean(metrics, mesh))


def build_ditto_train_step(dit_cfg: DiTConfig, codec_cfg: CodecConfig,
                           gpt2_cfg: GPT2Config, *,
                           learning_rate: Optional[float] = None,
                           weight_decay: float = 1e-6,
                           encode_dtype: str = "float32",
                           flat_opt: bool = True, device=None, mesh=None):
    """(init_state, step_fn, eval_fn) for DiTTo diffusion training:

      init_state(dit_params) -> {"params", "opt_state", "step"}
      step_fn(state, frozen, batch, generator=None, *, t=None, noise=None)
          -> (new_state, {"loss"})
      eval_fn(state, frozen, batch, generator=None, *, t=None, noise=None)
          -> {"loss"}

    ``frozen`` holds ``codec``, ``gpt2`` (its ``wte``) and
    ``embedding_head``; ``batch`` holds ``text_ids`` and either
    ``latents`` or ``audio`` (with an optional ``padding_mask``).
    ``device`` is resolved by ``resolve_device``: the state and the frozen
    tree must lie there, the batch is moved there. ``generator`` (on that
    device) draws t, the noise and the dropout masks; None draws from the
    default generator and drops nothing. ``mesh``: this rank's share of a
    (data, model) mesh (see the module docstring); tensor parallelism needs
    ``flat_opt=False``."""
    lr = learning_rate if learning_rate is not None else dit_cfg.learning_rate
    opt = make_adamw(lr, weight_decay, flat=flat_opt)
    if dit_cfg.ref_compat and dit_cfg.prediction_type != "eps":
        raise ValueError("v/x0 prediction assumes the corrected (non-"
                         "inverted) schedule; ref_compat supports eps only")
    if dit_cfg.prediction_type not in ("eps", "v", "x0"):
        raise ValueError(
            f"unknown prediction_type {dit_cfg.prediction_type!r}")
    enc_dt = getattr(torch, encode_dtype)
    dev = resolve_device(device)
    sc = NoiseSchedule.cosine(dit_cfg.diffusion_steps).to(dev)

    def init_state(dit_params) -> Dict:
        return new_train_state(tree_map(lambda p: p.to(dev), dit_params),
                               flat_opt)

    @torch.no_grad()
    def encode_batch(frozen, batch):
        with span("train.encode"):
            if "latents" in batch:
                latents = batch["latents"].float()[:, :gpt2_cfg.n_positions]
            else:
                codec, audio = frozen["codec"], batch["audio"]
                if enc_dt != torch.float32:
                    codec = tree_map(lambda a: a.to(enc_dt)
                                     if a.dtype == torch.float32 else a,
                                     codec)
                    audio = audio.to(enc_dt)
                latents, _ = nac_mod.audio_encoder(
                    {"embedding_head": frozen["embedding_head"]}, codec,
                    codec_cfg, audio, batch.get("padding_mask"))
                latents = latents.float()[:, :, :gpt2_cfg.n_positions]
                latents = latents.mean(dim=1)              # [B, T, H]
            text_ids = batch["text_ids"][:, :latents.shape[1]]
            return latents, gpt2_mod.embed_tokens(frozen["gpt2"], text_ids)

    def loss_fn(dit_params, latents, text_emb, generator, t, noise):
        # draws for the global batch; this rank keeps its rows
        b = latents.shape[0]
        d, nd = (0, 1) if mesh is None else (mesh.data_index, mesh.data)
        if t is None:
            t = torch.randint(0, dit_cfg.diffusion_steps, (b * nd,),
                              generator=generator, device=dev)
        if noise is None:
            noise = torch.randn((b * nd,) + tuple(latents.shape[1:]),
                                generator=generator, dtype=latents.dtype,
                                device=dev)
        t, noise = t.to(dev)[d * b:(d + 1) * b], \
            noise.to(dev)[d * b:(d + 1) * b]
        noisy = q_sample(sc, latents, t, noise,
                         ref_compat=dit_cfg.ref_compat)
        pred = dit_mod.ditto_forward(dit_params, dit_cfg, noisy, text_emb, t,
                                     generator=generator, mesh=mesh)
        if dit_cfg.prediction_type == "eps":
            target = noise
        elif dit_cfg.prediction_type == "x0":
            target = latents
        else:
            ab = sc.alphas_cumprod[t].reshape(
                (b,) + (1,) * (latents.dim() - 1))
            target = torch.sqrt(ab) * noise - torch.sqrt(1.0 - ab) * latents
        return torch.mean(torch.square(pred - target))

    def step_fn(state, frozen, batch, generator=None, *, t=None,
                noise=None) -> Tuple[Dict, Dict]:
        with span("train.step"):
            batch = _placed(dev, state, frozen, batch)
            latents, text_emb = encode_batch(frozen, batch)

            def loss_of(params):
                # ref_compat's self-attention out_proj is not read: zeros
                loss = loss_fn(params, latents, text_emb, generator, t,
                               noise)
                return loss, {"loss": loss}

            return _apply_gradient(opt, state, loss_of, mesh)

    @torch.no_grad()
    def eval_fn(state, frozen, batch, generator=None, *, t=None,
                noise=None) -> Dict:
        batch = _placed(dev, state, frozen, batch)
        latents, text_emb = encode_batch(frozen, batch)
        return _metrics_mean({"loss": loss_fn(
            state["params"], latents, text_emb, generator, t, noise)}, mesh)

    return init_state, step_fn, eval_fn


def _step_fns(dev: torch.device, opt: AdamW, loss_fn, mesh):
    """(init_state, step_fn, eval_fn) around ``loss_fn(trainable, frozen,
    batch) -> (loss, metrics)``: the NAC's and the SLP's shape, whose
    steps draw nothing (the generator is not read)."""
    def init_state(trainable) -> Dict:
        return new_train_state(tree_map(lambda p: p.to(dev), trainable),
                               opt.flat)

    def step_fn(state, frozen, batch, generator=None) -> Tuple[Dict, Dict]:
        with span("train.step"):
            batch = _placed(dev, state, frozen, batch)
            return _apply_gradient(opt, state,
                                   lambda p: loss_fn(p, frozen, batch), mesh)

    @torch.no_grad()
    def eval_fn(state, frozen, batch, generator=None) -> Dict:
        batch = _placed(dev, state, frozen, batch)
        return _metrics_mean(loss_fn(state["params"], frozen, batch)[1],
                             mesh)

    return init_state, step_fn, eval_fn


def build_nac_train_step(nac_cfg: NACConfig, codec_cfg: CodecConfig,
                         gpt2_cfg: GPT2Config, *, ref_compat: bool = False,
                         learning_rate: Optional[float] = None,
                         weight_decay: float = 1e-6, device=None,
                         mesh=None):
    """(init_state, step_fn, eval_fn) for NAC training:

      init_state(trainable) -> {"params", "opt_state", "step"}
      step_fn(state, frozen, batch, generator=None) -> (new_state, metrics)
      eval_fn(state, frozen, batch, generator=None) -> metrics

    ``trainable`` holds ``embedding_head`` and ``vector_quantizer``,
    ``frozen`` ``codec`` and ``gpt2`` (the whole stack); ``batch`` holds
    ``audio``, ``text_ids``, ``text_mask`` and an optional
    ``padding_mask``. The metrics: ``total_loss``, ``lm_loss``,
    ``reconstruction_loss``, and without ``ref_compat`` ``codebook_loss``
    and ``commitment_loss``. ``mesh``: data parallelism (the NAC's
    trainables are replicated, as JAX's CLI keeps them)."""
    lr = learning_rate if learning_rate is not None else nac_cfg.learning_rate

    def loss_fn(trainable, frozen, batch):
        out = nac_mod.nac_forward(
            trainable, frozen["codec"], frozen["gpt2"], nac_cfg, codec_cfg,
            gpt2_cfg, batch["text_ids"], batch["text_mask"], batch["audio"],
            batch.get("padding_mask"), ref_compat=ref_compat)
        return out["total_loss"], {k: v for k, v in out.items()
                                   if v.dim() == 0}

    return _step_fns(resolve_device(device), make_adamw(lr, weight_decay),
                     loss_fn, mesh)


def build_slp_train_step(slp_cfg: SLPConfig, codec_cfg: CodecConfig,
                         byt5_cfg: ByT5Config, *,
                         learning_rate: Optional[float] = None,
                         weight_decay: float = 1e-6, flat_opt: bool = True,
                         device=None, mesh=None):
    """(init_state, step_fn, eval_fn) for SLP training, with the signatures
    of ``build_nac_train_step``. ``trainable`` holds ``embedding_head``,
    ``decoder`` and ``length_predictor``, ``frozen`` ``codec`` and
    ``byt5``; ``batch`` holds ``audio``, ``text_ids``, ``text_mask``,
    ``label`` (the duration class) and an optional ``padding_mask``. The
    metrics: ``loss`` and ``accuracy``. ``mesh``: data and tensor
    parallelism (the decoder's feed-forward splits over the model group;
    its one head stays whole), which needs ``flat_opt=False``."""
    lr = learning_rate if learning_rate is not None else slp_cfg.learning_rate

    def loss_fn(trainable, frozen, batch):
        logits = slp_mod.slp_forward(
            trainable, frozen["byt5"], frozen["codec"], slp_cfg, byt5_cfg,
            codec_cfg, batch["text_ids"], batch["text_mask"], batch["audio"],
            batch.get("padding_mask"), mesh=mesh)
        labels = batch["label"].long()
        logp = torch.log_softmax(logits.float(), dim=-1)
        loss = -logp.gather(-1, labels[:, None])[:, 0].mean()
        acc = (logits.argmax(dim=-1) == labels).float().mean()
        return loss, {"loss": loss, "accuracy": acc}

    return _step_fns(resolve_device(device),
                     make_adamw(lr, weight_decay, flat=flat_opt), loss_fn,
                     mesh)
