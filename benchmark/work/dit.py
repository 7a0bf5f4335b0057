"""Operations of the DiT (``pipeline.dit`` of a configuration file) from
its shapes: dense layers and attention products, 2 operations a
multiply-add. Elementwise work (norms, RoPE, gates, residuals) is not
counted, so a share of a peak built on these counts is a lower bound.

The per-request part (the text's cross-attention keys and values,
projected once per request) is counted apart from the per-step part.
"""

from . import attention


def _dims(dit: dict):
    h = dit["hidden_dim"]
    return (h, dit["num_layers"], dit["num_heads"], h // dit["num_heads"],
            dit["mlp_ratio"] * h, dit["time_dim"], dit["text_dim"])


def text_tokens(dit: dict, ids: int) -> int:
    return min(ids, dit["max_token_length"])


def block_dtype(dit: dict) -> str:
    return dit["compute_dtype"]


def step_flops(dit: dict, b: int, s: int, st: int):
    """(block flops, other flops) of one forward at batch b, s latent
    frames and st text tokens: the block stack runs in the compute dtype,
    the time embedding, AdaLN and the skip projections in fp32."""
    h, layers, nh, hd, m, td, xd = _dims(dit)
    tok = b * s
    per_layer = 2.0 * tok * h * 3 * h                   # packed q, k, v
    per_layer += attention.call(b, nh, s, s, hd, "float32")[0]
    if not dit["ref_compat"]:
        per_layer += 2.0 * tok * h * h                  # self out_proj
    per_layer += 2.0 * tok * h * h                      # cross q
    per_layer += attention.call(b, nh, s, st, hd, "float32")[0]
    per_layer += 2.0 * tok * h * h                      # cross out_proj
    per_layer += 3 * 2.0 * tok * h * m                  # fc1, gate, fc2
    other = 2 * 2.0 * tok * h * h                       # proj_in, proj_out
    other += 2.0 * b * (2 * td * td + td * 2 * h + xd * 2 * h)
    return layers * per_layer, other


def request_flops(dit: dict, b: int, st: int) -> float:
    """The cross-attention K and V of every layer, once per request."""
    h, layers = dit["hidden_dim"], dit["num_layers"]
    return layers * 2 * 2.0 * b * st * h * h


def attention_calls(dit: dict, b: int, s: int, st: int):
    """[(flops, bytes)] of one forward's attention calls (self, then
    cross, per layer) at the compute dtype."""
    h, layers, nh, hd = _dims(dit)[:4]
    dt = block_dtype(dit)
    return [attention.call(b, nh, s, s, hd, dt),
            attention.call(b, nh, s, st, hd, dt)] * layers


def train_step_flops(dit: dict, b: int, s: int, st: int) -> float:
    """One training step: the forward, a backward of twice its operations,
    and, where blocks are rematerialized under the policy that saves the
    weight products, the attention products computed again (under
    ``nothing_saveable``, the whole block stack again)."""
    blocks, other = step_flops(dit, b, s, st)
    fwd = blocks + other + request_flops(dit, b, st)
    total = 3.0 * fwd
    if dit.get("remat_blocks"):
        if dit.get("remat_policy") == "nothing_saveable":
            total += blocks
        else:
            h, layers, nh, hd = _dims(dit)[:4]
            total += layers * (attention.call(b, nh, s, s, hd, "float32")[0]
                               + attention.call(b, nh, s, st, hd,
                                                "float32")[0])
    return total
