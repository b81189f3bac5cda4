"""Configuration system for csm_tpu_torch (a copy of ``csm_tpu/config.py``:
the port imports nothing of the JAX package, so it keeps its own).

Mirrors the reference's two-tier config (``modeling_csm.py:52-143``): a CSM
config holding two nested Llama sub-configs plus the CSM hyper-parameters
(``text_vocab_size=128256``, ``audio_vocab_size=2051``,
``audio_num_codebooks=32``, ``max_seq_len=2048``), JSON-serializable, with a
dict-or-object constructor and the same derived overrides (backbone
``max_position_embeddings`` ← ``max_seq_len``; decoder
``max_position_embeddings`` ← ``audio_num_codebooks``; both vocab sizes ←
``text_vocab_size``).

Implemented as plain frozen dataclasses (hashable, so they can key caches)
rather than HF ``PretrainedConfig`` objects.

The backbone may also be a hybrid state-space stack (:class:`HybridConfig`,
HF ``GraniteMoeHybrid``: Mamba-2 mixers beside position-free attention
layers), chosen by ``backbone_config.model_type == "granitemoehybrid"``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Optional, Tuple, Union


@dataclasses.dataclass(frozen=True)
class RopeScalingConfig:
    """Llama-3 long-context RoPE scaling (reference ``modeling_csm.py:79-85``).

    ``rope_type="llama3"`` rescales low-frequency components of the inverse
    frequencies by ``1/factor`` with a smooth ramp between the high/low
    frequency cutoffs, as in HF ``_compute_llama3_parameters``.
    """

    rope_type: str = "llama3"
    factor: float = 32.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Optional[Mapping[str, Any]]) -> Optional["RopeScalingConfig"]:
        if d is None:
            return None
        d = dict(d)
        # HF serializes the discriminator as either "type" or "rope_type".
        rope_type = d.pop("type", None) or d.pop("rope_type", "llama3")
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(rope_type=rope_type, **{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Shape of one Llama transformer stack.

    Defaults are the CSM backbone: Llama-3.2-1B shape (reference
    ``modeling_csm.py:68-88``) — 16 layers, hidden 2048, FFN 8192, GQA with
    32 query / 8 KV heads, RMSNorm eps 1e-5, SiLU, rope_theta 500000 with
    llama3 scaling.
    """

    vocab_size: int = 128256
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_hidden_layers: int = 16
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    rope_scaling: Optional[RopeScalingConfig] = RopeScalingConfig()

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_query_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["rope_scaling"] = self.rope_scaling.to_dict() if self.rope_scaling else None
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "LlamaConfig":
        d = dict(d)
        scaling = RopeScalingConfig.from_dict(d.pop("rope_scaling", None))
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(rope_scaling=scaling, **{k: v for k, v in d.items() if k in known})


HYBRID_MODEL_TYPE = "granitemoehybrid"


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Shape of a hybrid Mamba-2 / attention stack (HF ``GraniteMoeHybrid``
    without experts; defaults are ``ibm-granite/granite-4.0-h-micro``): 40
    layers at hidden 2048, ``layer_types`` naming each a ``"mamba"`` mixer or
    an ``"attention"`` block (GQA 32 / 8 heads of 64, no position embedding,
    scores scaled by ``attention_multiplier``), each followed by a SwiGLU MLP
    of ``shared_intermediate_size``.  A mixer's ``in_proj`` gives ``z``
    (``mamba_expand * hidden``), ``xBC`` (that plus two ``n_groups *
    d_state`` blocks) and ``dt`` (``mamba_n_heads``); a causal depthwise conv
    of width ``mamba_d_conv`` runs over ``xBC``.  μP multipliers: the input
    embeddings times ``embedding_multiplier``, every residual branch times
    ``residual_multiplier``, the logits over ``logits_scaling``."""

    vocab_size: int = 100352
    hidden_size: int = 2048
    intermediate_size: int = 8192
    shared_intermediate_size: int = 8192
    num_hidden_layers: int = 40
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 131072
    rms_norm_eps: float = 1e-5
    layer_types: Tuple[str, ...] = tuple(
        "attention" if i % 10 == 5 else "mamba" for i in range(40))
    mamba_n_heads: int = 64
    mamba_d_head: int = 64
    mamba_d_state: int = 128
    mamba_n_groups: int = 1
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_chunk_size: int = 256
    mamba_conv_bias: bool = True
    mamba_proj_bias: bool = False
    attention_bias: bool = False
    attention_multiplier: float = 0.015625
    embedding_multiplier: float = 12.0
    residual_multiplier: float = 0.22
    logits_scaling: float = 8.0
    position_embedding_type: str = "nope"

    model_type = HYBRID_MODEL_TYPE

    def __post_init__(self):
        object.__setattr__(self, "layer_types", tuple(self.layer_types))
        if len(self.layer_types) != self.num_hidden_layers or \
                set(self.layer_types) - {"mamba", "attention"}:
            raise ValueError(f"layer_types must name {self.num_hidden_layers} layers, each "
                             f"'mamba' or 'attention'; got {self.layer_types}")
        if self.position_embedding_type != "nope":
            raise ValueError("only position-free attention (position_embedding_type 'nope') "
                             "is supported")
        if self.attention_bias or self.mamba_proj_bias:
            raise ValueError("attention and in/out projection biases are not supported")
        if self.mamba_n_heads * self.mamba_d_head != self.mamba_inner:
            raise ValueError(f"mamba_n_heads * mamba_d_head ({self.mamba_n_heads} * "
                             f"{self.mamba_d_head}) must equal mamba_expand * hidden_size "
                             f"({self.mamba_inner})")
        if self.mamba_n_heads % self.mamba_n_groups:
            raise ValueError("mamba_n_groups must divide mamba_n_heads")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_query_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    @property
    def mamba_inner(self) -> int:
        """Channels of ``x`` and ``z``: ``mamba_expand * hidden_size``."""
        return self.mamba_expand * self.hidden_size

    @property
    def conv_dim(self) -> int:
        """Channels of ``xBC``, the conv's input."""
        return self.mamba_inner + 2 * self.mamba_n_groups * self.mamba_d_state

    @property
    def in_proj_dim(self) -> int:
        """Columns of ``in_proj``: ``z``, ``xBC`` and ``dt``."""
        return self.mamba_inner + self.conv_dim + self.mamba_n_heads

    @property
    def mamba_layers(self) -> Tuple[int, ...]:
        return tuple(i for i, t in enumerate(self.layer_types) if t == "mamba")

    @property
    def attention_layers(self) -> Tuple[int, ...]:
        return tuple(i for i, t in enumerate(self.layer_types) if t == "attention")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["layer_types"] = list(self.layer_types)
        d["model_type"] = self.model_type
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "HybridConfig":
        """From HF ``config.json`` keys (those that say nothing of the
        shape ignored); refuses what the port does not run: experts, another
        activation or norm."""
        if d.get("num_local_experts", 0) or d.get("num_experts_per_tok", 0):
            raise ValueError("a hybrid backbone with experts is not supported")
        if d.get("hidden_act", "silu") != "silu" or \
                d.get("normalization_function", "rmsnorm") != "rmsnorm":
            raise ValueError("a hybrid backbone runs SiLU MLPs and RMSNorm")
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in dict(d).items() if k in known})

    @classmethod
    def tiny(cls, **overrides) -> "HybridConfig":
        """One whole period of the published pattern (five mixers, an
        attention layer, four mixers) at tiny widths, with a chunk of 8 so
        a short prompt crosses chunk edges."""
        kwargs = dict(hidden_size=64, intermediate_size=128, shared_intermediate_size=128,
                      num_hidden_layers=10, num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=64,
                      layer_types=tuple("attention" if i == 5 else "mamba" for i in range(10)),
                      mamba_n_heads=8, mamba_d_head=16, mamba_d_state=16, mamba_chunk_size=8,
                      attention_multiplier=1.0 / 16)
        kwargs.update(overrides)
        return cls(**kwargs)


def backbone_from_dict(d: Mapping[str, Any]):
    """A backbone config by its ``model_type``: ``"granitemoehybrid"`` gives
    a :class:`HybridConfig`, anything else a :class:`LlamaConfig`."""
    if d.get("model_type") == HYBRID_MODEL_TYPE:
        return HybridConfig.from_dict(d)
    return LlamaConfig.from_dict(d)


def is_hybrid(config) -> bool:
    """Whether a CSM config's backbone is a hybrid state-space stack."""
    return isinstance(config.backbone, HybridConfig)


def _default_backbone() -> LlamaConfig:
    return LlamaConfig()


def _default_decoder() -> LlamaConfig:
    # Reference decoder shape: ``modeling_csm.py:89-109`` — 4 layers, hidden
    # 1024, FFN 8192, GQA 8 query / 2 KV heads, same RoPE regime.
    return LlamaConfig(
        hidden_size=1024,
        intermediate_size=8192,
        num_hidden_layers=4,
        num_attention_heads=8,
        num_key_value_heads=2,
        max_position_embeddings=32,
    )


@dataclasses.dataclass(frozen=True)
class CSMConfig:
    """Two nested Llama configs + CSM hyper-parameters.

    Construction applies the same forced overrides as the reference
    constructor (``modeling_csm.py:112-143``): both sub-config vocab sizes are
    set to ``text_vocab_size``; backbone ``max_position_embeddings`` is set to
    ``max_seq_len``; decoder ``max_position_embeddings`` is set to
    ``audio_num_codebooks``.

    Note the reference quirk (SURVEY §7 "hard parts"): the decoder is *run*
    with 33 positions during training (frame hidden + 32 codebooks,
    ``modeling_csm.py:432-441``) even though ``max_position_embeddings`` is
    32; the RoPE table must therefore cover ``audio_num_codebooks + 1``
    positions.  :func:`decoder_rope_positions` exposes that bound.
    """

    text_vocab_size: int = 128256
    audio_vocab_size: int = 2051
    audio_num_codebooks: int = 32
    max_seq_len: int = 2048
    backbone: Union[LlamaConfig, HybridConfig] = dataclasses.field(
        default_factory=_default_backbone)
    decoder: LlamaConfig = dataclasses.field(default_factory=_default_decoder)

    def __post_init__(self):
        # Forced overrides, mirroring ``modeling_csm.py:128-141``.
        object.__setattr__(
            self,
            "backbone",
            dataclasses.replace(
                self.backbone,
                vocab_size=self.text_vocab_size,
                max_position_embeddings=self.max_seq_len,
            ),
        )
        object.__setattr__(
            self,
            "decoder",
            dataclasses.replace(
                self.decoder,
                vocab_size=self.text_vocab_size,
                max_position_embeddings=self.audio_num_codebooks,
            ),
        )

    # -- derived quantities -------------------------------------------------

    @property
    def frame_width(self) -> int:
        """Tokens per frame: 32 audio codebooks + 1 text column = 33."""
        return self.audio_num_codebooks + 1

    @property
    def audio_embedding_rows(self) -> int:
        """Shared audio embedding table height: 32 × 2051 = 65632
        (reference ``modeling_csm.py:222-225``)."""
        return self.audio_vocab_size * self.audio_num_codebooks

    @property
    def decoder_rope_positions(self) -> int:
        """RoPE table length needed by the decoder: 33 (positions 0..32 are
        exercised by the training forward, ``modeling_csm.py:432-441``)."""
        return self.audio_num_codebooks + 1

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "model_type": "csm",
            "text_vocab_size": self.text_vocab_size,
            "audio_vocab_size": self.audio_vocab_size,
            "audio_num_codebooks": self.audio_num_codebooks,
            "max_seq_len": self.max_seq_len,
            "backbone_config": self.backbone.to_dict(),
            "decoder_config": self.decoder.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "CSMConfig":
        d = dict(d)
        backbone = d.get("backbone_config") or d.get("backbone")
        decoder = d.get("decoder_config") or d.get("decoder")
        kwargs = {}
        for k in ("text_vocab_size", "audio_vocab_size", "audio_num_codebooks", "max_seq_len"):
            if k in d:
                kwargs[k] = d[k]
        return cls(
            backbone=backbone_from_dict(backbone) if backbone else _default_backbone(),
            decoder=LlamaConfig.from_dict(decoder) if decoder else _default_decoder(),
            **kwargs,
        )

    def to_json(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.to_dict(), indent=2)
        if path is not None:
            with open(path, "w") as f:
                f.write(s)
        return s

    @classmethod
    def from_json(cls, path_or_str: str) -> "CSMConfig":
        if path_or_str.lstrip().startswith("{"):
            return cls.from_dict(json.loads(path_or_str))
        with open(path_or_str) as f:
            return cls.from_dict(json.load(f))

    # -- test helpers -------------------------------------------------------

    @classmethod
    def tiny(cls, **overrides) -> "CSMConfig":
        """A miniature config for unit/parity tests: same structure, tiny
        shapes.  Keeps GQA (2 KV groups) so grouped attention is exercised."""
        kwargs = dict(
            text_vocab_size=97,
            audio_vocab_size=23,
            audio_num_codebooks=32,
            max_seq_len=64,
            backbone=LlamaConfig(
                hidden_size=64,
                intermediate_size=128,
                num_hidden_layers=2,
                num_attention_heads=4,
                num_key_value_heads=2,
                max_position_embeddings=64,
            ),
            decoder=LlamaConfig(
                hidden_size=32,
                intermediate_size=64,
                num_hidden_layers=2,
                num_attention_heads=2,
                num_key_value_heads=1,
                max_position_embeddings=32,
            ),
        )
        kwargs.update(overrides)
        return cls(**kwargs)

    @classmethod
    def tiny_hybrid(cls, **overrides) -> "CSMConfig":
        """:meth:`tiny` with :meth:`HybridConfig.tiny` as its backbone."""
        return cls.tiny(**{"backbone": HybridConfig.tiny(), **overrides})
