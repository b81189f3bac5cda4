"""Weights made on the device from the run's seed, in the type they are
served or trained in: one ``torch.Generator`` on the card, one draw for all
the drawn leaves of a tree, each leaf a view of it.  The model's leaves as
its family's ``shapes`` lists them (for CSM: linear and embedding weights
``N(0, 0.02)`` and norms 1, as the port's ``init_params``); Mimi's
codebooks ``N(0, 1)``, layer norms and layer scales at their real init, as
its ``random_mimi_params``.  The same seed gives the same values, so the
reference remakes what the program was given."""

from __future__ import annotations

import math

import torch

from benchmark.reference import mimi as ref_mimi
from benchmark.shapes import nest

# Offsets of the generator streams, so the model and the codec draw apart.
_MODEL_STREAM, _MIMI_STREAM = 0x5EED, 0xC0DEC


def _generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((seed * 0x9E3779B1 + stream) % (1 << 63))
    return g


def _fill(shapes: list, gen, dtype, device) -> dict:
    """``{path: tensor}`` for ``[(path, shape, scale or None, const)]``:
    drawn leaves scaled N(0, 1) views of one draw; constant leaves filled."""
    drawn = [(p, s, sc) for p, s, sc, _ in shapes if sc is not None]
    total = sum(math.prod(s) for _, s, _ in drawn)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for p, s, sc in drawn:
        n = math.prod(s)
        out[p] = flat[at:at + n].view(s).mul_(sc)
        at += n
    for p, s, sc, const in shapes:
        if sc is None:
            out[p] = torch.full(s, const, dtype=dtype, device=device)
    return out


def model_params(family, cfg, seed: int, dtype, device) -> dict:
    """The model's parameter tree in the port's layout, from its family's
    ``shapes`` (a module of ``families/``)."""
    return nest(_fill(family.shapes(cfg), _generator(seed, _MODEL_STREAM, device), dtype, device))


def mimi_decoder_params(cfg, seed: int, device) -> dict:
    """Float32 Mimi decoder parameters (``cfg``: the codec's namespace):
    the quantizer's codebooks and output projections, the upsample, the
    decoder transformer and the SEANet decoder, in the port's layout."""
    L, H, I = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    V, Dq = cfg.codebook_size, cfg.codebook_dim
    ns = cfg.num_semantic_quantizers
    shapes = [
        ("quantizer.semantic.codebooks", (ns, V, Dq), 1.0, 0),
        ("quantizer.semantic.output_proj", (Dq, H), 0.02, 0),
        ("quantizer.acoustic.codebooks", (cfg.num_quantizers - ns, V, Dq), 1.0, 0),
        ("quantizer.acoustic.output_proj", (Dq, H), 0.02, 0),
    ]
    up = ref_mimi.upsample_spec(cfg)
    shapes.append(("upsample.w", (up.in_ch, up.out_ch // up.groups, up.kernel), 0.02, 0))
    t = "decoder_transformer.layers."
    shapes += [(t + "ln1_w", (L, H), None, 1.0), (t + "ln1_b", (L, H), 0.02, 0),
               (t + "wq", (L, H, nh * hd), 0.02, 0), (t + "wk", (L, H, nh * hd), 0.02, 0),
               (t + "wv", (L, H, nh * hd), 0.02, 0), (t + "wo", (L, nh * hd, H), 0.02, 0),
               (t + "scale_attn", (L, H), None, cfg.layer_scale_initial_scale),
               (t + "ln2_w", (L, H), None, 1.0), (t + "ln2_b", (L, H), 0.02, 0),
               (t + "fc1", (L, H, I), 0.02, 0), (t + "fc2", (L, I, H), 0.02, 0),
               (t + "scale_mlp", (L, H), None, cfg.layer_scale_initial_scale)]
    plan = ref_mimi.decoder_plan(cfg)
    for i, item in enumerate(plan):
        if item[0] == "conv":
            s = item[1]
            w = (s.in_ch, s.out_ch // s.groups, s.kernel) if s.transposed else \
                (s.out_ch, s.in_ch // s.groups, s.kernel)
            shapes += [(f"decoder.{i}.w", w, 0.02, 0), (f"decoder.{i}.b", (s.out_ch,), 0.02, 0)]
        elif item[0] == "resnet":
            for j, s in enumerate(item[1]):
                shapes += [(f"decoder.{i}.block.{j}.w", (s.out_ch, s.in_ch, s.kernel), 0.02, 0),
                           (f"decoder.{i}.block.{j}.b", (s.out_ch,), 0.02, 0)]
    flat = _fill(shapes, _generator(seed, _MIMI_STREAM, device), torch.float32, device)
    tree = nest({k: v for k, v in flat.items() if not k.startswith("decoder.")})
    tree["decoder"] = []
    for i, item in enumerate(plan):
        if item[0] == "elu":
            tree["decoder"].append({})
        elif item[0] == "conv":
            tree["decoder"].append({"w": flat[f"decoder.{i}.w"], "b": flat[f"decoder.{i}.b"]})
        else:
            tree["decoder"].append({"block": [
                {"w": flat[f"decoder.{i}.block.{j}.w"], "b": flat[f"decoder.{i}.block.{j}.b"]}
                for j in range(len(item[1]))]})
    return tree
