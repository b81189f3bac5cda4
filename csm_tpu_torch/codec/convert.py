"""Mimi parameters (counterpart of ``csm_tpu/codec/convert.py``): random
ones from a seed, the HF ``MimiModel`` state dict, and the JAX package's
parameter tree carried across.

Key layout of the HF state dict:
- SEANet stacks are ``nn.ModuleList``s whose indices include the ELU
  modules; the layer plan in :mod:`csm_tpu_torch.codec.mimi` has the same
  order, so conversion walks plan entries and HF indices in lockstep.
- Residual blocks store their convs at ``block.1`` and ``block.3``.
- Codebook centroids are EMA state: ``embed = embed_sum /
  clamp(cluster_usage, eps)``.
- Linear and 1x1-conv projections become input-major matrices; conv kernels
  keep the torch ``[out, in/groups, k]`` layout, transposed-conv kernels
  ``[in, out/groups, k]``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from csm_tpu_torch.codec.mimi import (
    MimiCodecConfig,
    decoder_plan,
    downsample_spec,
    encoder_plan,
    upsample_spec,
)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x)


def _t(a, dtype) -> torch.Tensor:
    """A tensor of ``dtype``, rounded once from the array's own precision."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _convert_seanet(sd: Mapping, prefix: str, plan, dtype) -> list:
    params = []
    for hf_idx, item in enumerate(plan):
        kind = item[0]
        if kind == "elu":
            params.append({})
        elif kind == "conv":
            base = f"{prefix}.layers.{hf_idx}.conv"
            p = {"w": _t(_np(sd[f"{base}.weight"]), dtype)}
            if f"{base}.bias" in sd:
                p["b"] = _t(_np(sd[f"{base}.bias"]), dtype)
            params.append(p)
        elif kind == "resnet":
            block = []
            for bi in (1, 3):  # block indices of the two convs
                base = f"{prefix}.layers.{hf_idx}.block.{bi}.conv"
                cp = {"w": _t(_np(sd[f"{base}.weight"]), dtype)}
                if f"{base}.bias" in sd:
                    cp["b"] = _t(_np(sd[f"{base}.bias"]), dtype)
                block.append(cp)
            params.append({"block": block})
        else:
            raise ValueError(kind)
    return params


def _convert_transformer(sd: Mapping, prefix: str, cfg: MimiCodecConfig, dtype) -> dict:
    L = cfg.num_hidden_layers

    def lin(i, name):
        return _np(sd[f"{prefix}.layers.{i}.{name}.weight"]).T

    def vec(i, name):
        return _np(sd[f"{prefix}.layers.{i}.{name}"])

    def stack(fn):
        return _t(np.stack([fn(i) for i in range(L)]), dtype)

    return {"layers": {
        "ln1_w": stack(lambda i: vec(i, "input_layernorm.weight")),
        "ln1_b": stack(lambda i: vec(i, "input_layernorm.bias")),
        "wq": stack(lambda i: lin(i, "self_attn.q_proj")),
        "wk": stack(lambda i: lin(i, "self_attn.k_proj")),
        "wv": stack(lambda i: lin(i, "self_attn.v_proj")),
        "wo": stack(lambda i: lin(i, "self_attn.o_proj")),
        "scale_attn": stack(lambda i: vec(i, "self_attn_layer_scale.scale")),
        "ln2_w": stack(lambda i: vec(i, "post_attention_layernorm.weight")),
        "ln2_b": stack(lambda i: vec(i, "post_attention_layernorm.bias")),
        "fc1": stack(lambda i: lin(i, "mlp.fc1")),
        "fc2": stack(lambda i: lin(i, "mlp.fc2")),
        "scale_mlp": stack(lambda i: vec(i, "mlp_layer_scale.scale")),
    }}


def _convert_rvq(sd: Mapping, prefix: str, n_quantizers: int, dtype, eps=1e-5) -> dict:
    embeds = []
    for i in range(n_quantizers):
        base = f"{prefix}.layers.{i}.codebook"
        embed_sum = _np(sd[f"{base}.embed_sum"])
        usage = _np(sd[f"{base}.cluster_usage"])
        embeds.append(embed_sum / np.clip(usage, eps, None)[:, None])
    return {
        "codebooks": _t(np.stack(embeds), dtype),
        # 1x1 convs [out, in, 1] -> input-major matrices [in, out]
        "input_proj": _t(_np(sd[f"{prefix}.input_proj.weight"])[:, :, 0].T, dtype),
        "output_proj": _t(_np(sd[f"{prefix}.output_proj.weight"])[:, :, 0].T, dtype),
    }


def random_mimi_params(cfg: MimiCodecConfig, seed: int = 0, dtype=torch.float32) -> dict:
    """Random parameters, shaped as :func:`mimi_params_from_state_dict`'s
    output: ``N(0, 0.02)`` weights (codebooks ``N(0, 1)``), layer norms and
    layer scales at their real init.  Drawn from numpy in the JAX package's
    order, so one seed gives both packages the same values.  Codec time does
    not depend on weight values, so these measure the published size's cost
    without the checkpoint."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.02):
        return _t(rng.standard_normal(shape) * scale, dtype)

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype)

    def seanet(plan):
        out = []
        for item in plan:
            kind = item[0]
            if kind == "elu":
                out.append({})
            elif kind == "conv":
                s = item[1]
                if s.transposed:  # [in, out/groups, k]
                    w = t(s.in_ch, s.out_ch // s.groups, s.kernel)
                else:  # [out, in/groups, k]
                    w = t(s.out_ch, s.in_ch // s.groups, s.kernel)
                p = {"w": w}
                if s.bias:
                    p["b"] = t(s.out_ch)
                out.append(p)
            else:  # resnet: two convs with groups 1
                block = []
                for s in item[1]:
                    w = t(s.out_ch, s.in_ch, s.kernel)
                    block.append({"w": w, "b": t(s.out_ch)})
                out.append({"block": block})
        return out

    L, H, I = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    def transformer():
        layers = {"ln1_w": full((L, H), 1.0)}
        layers["ln1_b"] = t(L, H)
        layers["wq"] = t(L, H, nh * hd)
        layers["wk"] = t(L, H, nkv * hd)
        layers["wv"] = t(L, H, nkv * hd)
        layers["wo"] = t(L, nh * hd, H)
        layers["scale_attn"] = full((L, H), cfg.layer_scale_initial_scale)
        layers["ln2_w"] = full((L, H), 1.0)
        layers["ln2_b"] = t(L, H)
        layers["fc1"] = t(L, H, I)
        layers["fc2"] = t(L, I, H)
        layers["scale_mlp"] = full((L, H), cfg.layer_scale_initial_scale)
        return {"layers": layers}

    def rvq(n):
        codebooks = t(n, cfg.codebook_size, cfg.codebook_dim, scale=1.0)
        input_proj = t(H, cfg.codebook_dim)
        return {"codebooks": codebooks, "input_proj": input_proj,
                "output_proj": t(cfg.codebook_dim, H)}

    ds, us = downsample_spec(cfg), upsample_spec(cfg)
    out = {"encoder": seanet(encoder_plan(cfg))}
    out["encoder_transformer"] = transformer()
    out["downsample"] = {"w": t(ds.out_ch, ds.in_ch, ds.kernel)}
    semantic = rvq(cfg.num_semantic_quantizers)
    out["quantizer"] = {"semantic": semantic,
                        "acoustic": rvq(cfg.num_quantizers - cfg.num_semantic_quantizers)}
    out["upsample"] = {"w": t(us.in_ch, us.out_ch // us.groups, us.kernel)}
    out["decoder_transformer"] = transformer()
    out["decoder"] = seanet(decoder_plan(cfg))
    return out


def mimi_params_from_state_dict(state_dict: Mapping, cfg: MimiCodecConfig,
                                dtype=torch.float32) -> dict:
    """Parameters from an HF ``MimiModel`` state dict (numpy arrays or
    tensors)."""
    sd = state_dict
    return {
        "encoder": _convert_seanet(sd, "encoder", encoder_plan(cfg), dtype),
        "encoder_transformer": _convert_transformer(sd, "encoder_transformer", cfg, dtype),
        "downsample": {"w": _t(_np(sd["downsample.conv.weight"]), dtype)},
        "quantizer": {
            "semantic": _convert_rvq(sd, "quantizer.semantic_residual_vector_quantizer",
                                     cfg.num_semantic_quantizers, dtype),
            "acoustic": _convert_rvq(sd, "quantizer.acoustic_residual_vector_quantizer",
                                     cfg.num_quantizers - cfg.num_semantic_quantizers, dtype),
        },
        "upsample": {"w": _t(_np(sd["upsample.conv.weight"]), dtype)},
        "decoder_transformer": _convert_transformer(sd, "decoder_transformer", cfg, dtype),
        "decoder": _convert_seanet(sd, "decoder", decoder_plan(cfg), dtype),
    }


def mimi_params_from_jax(tree, dtype=torch.float32) -> dict:
    """The JAX package's Mimi parameter tree, its leaves as numpy arrays
    (``jax.tree.map(np.asarray, params)``), carried across: the layouts are
    the same, so each leaf becomes a tensor as it is."""
    if isinstance(tree, dict):
        return {k: mimi_params_from_jax(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [mimi_params_from_jax(v, dtype) for v in tree]
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(dtype)
