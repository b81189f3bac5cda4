"""Checkpoint I/O: the port's own safetensors reader/writer, the
reference-layout converter, and training-state bundles with rotation."""

from csm_tpu_torch.checkpoint.hf_convert import (  # noqa: F401
    load_params_from_safetensors,
    params_from_jax,
    params_from_state_dict,
    save_params_to_safetensors,
    state_dict_from_params,
)
from csm_tpu_torch.checkpoint.train_state import (  # noqa: F401
    latest_step,
    load_checkpoint,
    on_rank_zero,
    save_checkpoint,
)
