"""The work of the MoE cell's measured pieces, from its shapes: the
yardstick of the ``moe.*`` metrics, frozen beside ``cost.py``.

For a decoder whose every layer is attention and an MoE FFN, of which this
chip holds ``experts_held`` of the router's ``n_experts`` experts (the
configuration file's ``model``):

- the step's model work: 6 times the parameters a token multiplies by
  (every parameter outside the experts but the input embedding, which a
  lookup reads, plus the expected share of the held experts a token is
  routed to: top_k * held / n_experts of them, 3 * D * F each), times the
  tokens; plus causal attention's score and PV products forward and
  backward (3.5 times the forward's, ``cost.flash``); no recompute;
- the held experts' products for a number of routed rows (assignments):
  gate, up and down, 2 * D * F operations each;
- the least bytes of routing, dispatch and combine: the router reads each
  token's row and writes its top-k gates (fp32) and expert ids (4 bytes);
  the dispatch reads and writes each held assignment's row; the combine
  reads each held assignment's expert output and writes each token's row.
  The router's weight, 0.5 MB against 64 MB of rows a pass at the cell's
  size, is left out, so the count stays a lower bound.
"""
from __future__ import annotations

from harness import cost


def non_expert_params(model: dict) -> int:
    """Parameters outside the experts that a token multiplies by: attention
    (with the q and k norms), the layer norms, the router, the final norm
    and the untied unembedding; not the input embedding."""
    d, h, hkv, hd = (model[k] for k in ("d_model", "n_heads", "n_kv_heads", "head_dim"))
    attn = d * h * hd + 2 * d * hkv * hd + h * hd * d
    if model["qk_norm"]:
        attn += (h + hkv) * hd
    per_layer = attn + 2 * d + d * model["n_experts"]
    return model["n_layers"] * per_layer + d * model["vocab"] + d


def active_expert_params(model: dict) -> float:
    """The held experts' parameters an average token is routed through."""
    share = model["top_k"] * model["experts_held"] / model["n_experts"]
    return model["n_layers"] * share * 3 * model["d_model"] * model["d_expert"]


def moe_model_flops(model: dict, batch: int, seq: int) -> float:
    """One optimizer step's model work over ``batch`` x ``seq`` tokens, with
    no rematerialization's recompute."""
    attn = model["n_layers"] * cost.flash(batch, model["n_heads"], model["n_kv_heads"], seq, seq,
                                          model["head_dim"], True, None, model["dtype"]).ops
    return 6.0 * (non_expert_params(model) + active_expert_params(model)) * batch * seq + 3.5 * attn


def expert_flops(model: dict, rows: float) -> float:
    """The held experts' three products over ``rows`` routed rows."""
    return 3 * 2.0 * model["d_model"] * model["d_expert"] * rows


def dispatch_bytes(model: dict, tokens: float, rows: float) -> float:
    """The least bytes of routing ``tokens`` token rows, of which ``rows``
    assignments go to held experts, and of their dispatch and combine."""
    row = model["d_model"] * cost.ITEMSIZE[model["dtype"]]
    route = tokens * (row + 8 * model["top_k"])
    return route + 2 * rows * row + rows * row + tokens * row
