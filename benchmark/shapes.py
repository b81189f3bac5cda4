"""The parameter tree of CSM (the port's layout: stacked layers, input-major
linear weights), as shapes from a configuration.  The weight maker, the
yardstick and the reference all read it, so none of them needs the
program."""

from __future__ import annotations

import math


def stack_shapes(c) -> dict:
    """One Llama stack: ``c`` is a ``LlamaConfig``-like object."""
    L, D, F = c.num_hidden_layers, c.hidden_size, c.intermediate_size
    hd = c.hidden_size // c.num_attention_heads
    q, kv = c.num_attention_heads * hd, c.num_key_value_heads * hd
    return {"layers": {"attn_norm": (L, D), "wq": (L, D, q), "wk": (L, D, kv),
                       "wv": (L, D, kv), "wo": (L, q, D), "mlp_norm": (L, D),
                       "w_gate": (L, D, F), "w_up": (L, D, F), "w_down": (L, F, D)},
            "final_norm": (D,)}


def csm_shapes(cfg) -> dict:
    """Every parameter of the CSM model under ``cfg`` (a ``CSMConfig``)."""
    D, Dd, Va = cfg.backbone.hidden_size, cfg.decoder.hidden_size, cfg.audio_vocab_size
    return {"backbone": stack_shapes(cfg.backbone), "decoder": stack_shapes(cfg.decoder),
            "text_embeddings": (cfg.text_vocab_size, D),
            "audio_embeddings": (cfg.audio_vocab_size * cfg.audio_num_codebooks, D),
            "projection": (D, Dd), "codebook0_head": (D, Va),
            "audio_head": (cfg.audio_num_codebooks - 1, Dd, Va)}


def is_norm(path: str) -> bool:
    """Norm weights start at one; every other leaf is drawn."""
    return path.endswith("norm")


def leaves(tree: dict, prefix: str = "") -> list:
    """``[(dotted path, value)]`` in sorted key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(leaves(v, f"{prefix}{k}."))
        else:
            out.append((prefix + k, v))
    return out


def layer_params(c) -> int:
    """Parameters of a stack's layers, norms included (the count the
    prefill's model FLOPs use)."""
    return sum(math.prod(s) for s in stack_shapes(c)["layers"].values())


def nest(flat: dict) -> dict:
    """``{"a.b": x}`` -> ``{"a": {"b": x}}``."""
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *parents, last = path.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = t
    return tree
