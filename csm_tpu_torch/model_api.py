"""Class-style model API (counterpart of ``csm_tpu/model_api.py``): a
``CSMModel`` holding ``(config, params, device)`` over the functional core.

Checkpoint format: a directory with ``config.json`` (reference-compatible
CSM config) and ``*.safetensors`` in the reference key layout, read and
written by the port's own safetensors code.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from csm_tpu_torch.config import CSMConfig
from csm_tpu_torch.device import DeviceLike, resolve_device
from csm_tpu_torch.models import csm
from csm_tpu_torch.models.csm import CSMOutput


def _tensor(x, device, dtype=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), device=device, dtype=dtype)


class CSMModel:
    """Holds ``config``, ``params`` and ``device``; CUDA unless
    ``device="cpu"`` is given."""

    def __init__(self, config: CSMConfig, params: Optional[dict] = None,
                 dtype=torch.float32, seed: int = 0, device: DeviceLike = None):
        self.config = config
        self.dtype = dtype
        self.device = resolve_device(device)
        if params is None:
            params = csm.init_params(config, seed, dtype, self.device)
        self.params = params
        self._qdec = self._qbb = self._qsb = None
        self._specdec = False

    # -- reference API ------------------------------------------------------

    def setup_caches(self, max_batch_size: int) -> None:
        """Shim (``modeling_csm.py:284-287``): generation builds its own
        static cache."""

    def reset_caches(self) -> None:
        """No-op shim (``modeling_csm.py:289-290``)."""

    @torch.no_grad()
    def forward(self, input_ids, attention_mask=None, labels=None,
                max_decoder_frames: Optional[int] = None,
                return_dict: Optional[bool] = None,
                output_attentions=None, output_hidden_states=None, **_ignored):
        """Reference-compatible forward.  ``return_dict=False`` returns the
        tuple ``(loss?, last_hidden_state, logits)``."""
        del output_attentions, output_hidden_states
        ids = _tensor(input_ids, self.device, torch.long)
        mask = (
            _tensor(attention_mask, self.device, torch.float32)
            if attention_mask is not None
            else torch.ones(ids.shape, dtype=torch.float32, device=self.device)
        )
        lbl = _tensor(labels, self.device, torch.long) if labels is not None else None
        out = csm.forward(self.params, self.config, ids, mask, labels=lbl,
                          max_decoder_frames=max_decoder_frames)
        if return_dict is False:
            tup = (out.last_hidden_state, out.logits)
            return tup if out.loss is None else (out.loss,) + tup
        return out

    __call__ = forward

    @torch.no_grad()
    def generate_frame(self, input_ids, attention_mask, temperature: float = 1.0,
                       topk: int = 50, generator: Optional[torch.Generator] = None,
                       greedy: bool = False, **_ignored) -> CSMOutput:
        from csm_tpu_torch import generation

        return generation.generate_frame(
            self.params, self.config,
            _tensor(input_ids, self.device, torch.long),
            _tensor(attention_mask, self.device, torch.float32),
            temperature=temperature, topk=topk, generator=generator, greedy=greedy,
        )

    def quantize(self, bits: int = 8, head_bits: int = 16) -> "CSMModel":
        """The quantized fast tiers: each frame's codebook loop runs the
        fused int8 kernel (``head_bits=8`` also quantizes its per-codebook
        head slices), per-frame backbone steps of up to 32 streams the
        backbone kernel of ``bits`` (8: int8 layer weights; 4: row-packed
        int4 with per-row equilibration, the c0 head int8) and larger ones
        W8A16 products.  The prompt's prefill stays in the param dtype.
        Quantized numerics: tokens differ from the plain path's.  Returns
        ``self``; the later of :meth:`quantize` and :meth:`exact` wins."""
        from csm_tpu_torch.ops.bb_kernel import prepare_streamed_backbone
        from csm_tpu_torch.ops.fused_decoder import prepare_fused_decoder
        from csm_tpu_torch.ops.quant import prepare_quantized_backbone

        qsb = prepare_streamed_backbone(self.params, self.config, bits=bits)
        self._qdec = prepare_fused_decoder(self.params, self.config, head_bits=head_bits)
        self._qbb = prepare_quantized_backbone(self.params, self.config)
        self._qsb = qsb
        self._specdec = False
        return self

    def exact(self) -> "CSMModel":
        """The exact fast tier, the plain path's tokens: per-frame backbone
        steps of up to 8 streams run the exact bf16 backbone kernel (same
        rounding points as the plain bf16 path), and the codebook loop of up
        to 8 streams runs speculative decoding (:mod:`..ops.specdec`): the
        int8 fused kernel drafts, one teacher-forced plain pass verifies.
        Returns ``self``; the later of :meth:`quantize` and :meth:`exact`
        wins."""
        from csm_tpu_torch.ops.bb_kernel import prepare_streamed_backbone
        from csm_tpu_torch.ops.fused_decoder import prepare_fused_decoder

        self._qdec = prepare_fused_decoder(self.params, self.config, head_bits=8)
        self._qbb = None  # W8A16 products would break exactness
        self._qsb = prepare_streamed_backbone(self.params, self.config, bits=16)
        self._specdec = True
        return self

    def generate(self, input_ids, attention_mask, max_new_frames: int = 100,
                 temperature: float = 1.0, topk: int = 50, use_cache: bool = True,
                 stop_on_all_zeros: bool = True,
                 generator: Optional[torch.Generator] = None,
                 greedy: bool = False, stop_mode: str = "batch") -> np.ndarray:
        from csm_tpu_torch import generation
        from csm_tpu_torch.ops import bb_kernel, fused_decoder

        B = np.asarray(input_ids).shape[0]
        qsb_cap = bb_kernel.MAX_VALIDATED_B_EXACT if self._specdec else bb_kernel.MAX_VALIDATED_B
        return generation.generate(
            self.params, self.config, input_ids, attention_mask,
            max_new_frames=max_new_frames, temperature=temperature, topk=topk,
            use_cache=use_cache, stop_on_all_zeros=stop_on_all_zeros,
            generator=generator, greedy=greedy, stop_mode=stop_mode,
            qdec=self._qdec if B <= fused_decoder.MAX_CHUNKED_B else None,
            qbb=self._qbb,
            qsb=self._qsb if B <= qsb_cap else None,
            specdec=self._specdec,
        )

    # -- persistence --------------------------------------------------------

    @classmethod
    def from_pretrained(cls, path: str, dtype=torch.float32,
                        device: DeviceLike = None) -> "CSMModel":
        """Load a local directory with ``config.json`` and reference-layout
        safetensors (single file or shards, f32 or bf16)."""
        from csm_tpu_torch.checkpoint import load_params_from_safetensors

        device = resolve_device(device)
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path}: no such checkpoint directory")
        cfg_path = os.path.join(path, "config.json")
        config = CSMConfig.from_json(cfg_path) if os.path.exists(cfg_path) else CSMConfig()
        params = load_params_from_safetensors(path, config, device, dtype)
        return cls(config, params, dtype=dtype, device=device)

    def save_pretrained(self, path: str) -> None:
        from csm_tpu_torch.checkpoint import save_params_to_safetensors

        os.makedirs(path, exist_ok=True)
        self.config.to_json(os.path.join(path, "config.json"))
        save_params_to_safetensors(os.path.join(path, "model.safetensors"), self.params)
