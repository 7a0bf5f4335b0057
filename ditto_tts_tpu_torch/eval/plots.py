"""Training-curve plots from a checkpoint's history (the JAX package's
``eval/plots.py``; ref Visualization.ipynb cells 1-8 plot the Trainer's
history stored in its checkpoints). ``matplotlib`` is imported when a plot
is drawn, not with the module."""

from __future__ import annotations

from typing import Dict, Optional


def plot_history(history: Dict, out_path: str,
                 title: Optional[str] = None) -> str:
    """A loss-curve PNG of a ``Trainer`` history dict at ``out_path``."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    train_loss = [x for x in history["train"]["loss"] if x is not None]
    val_loss = [x for x in history["validation"]["loss"] if x is not None]

    fig, ax = plt.subplots(figsize=(7, 4))
    if train_loss:
        ax.plot(range(1, len(train_loss) + 1), train_loss, label="train")
    if val_loss:
        ax.plot(range(1, len(val_loss) + 1), val_loss, label="validation")
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.set_title(title or history.get("params", {}).get("model_name",
                                                        "training"))
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_from_checkpoint(checkpoint_path: str, out_path: str) -> str:
    """``plot_history`` of the history in a checkpoint's ``.json``
    metadata (what ``Trainer.fit`` writes)."""
    from ..train.checkpoint import load_metadata

    meta = load_metadata(checkpoint_path)
    if not meta or "history" not in meta:
        raise ValueError(f"no history in {checkpoint_path}")
    return plot_history(meta["history"], out_path)
