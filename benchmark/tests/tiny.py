"""Tiny cells for the CPU tests: the committed traffic files with small
sizes, on ``CSMConfig.tiny()`` and ``MimiCodecConfig.tiny()``."""

import dataclasses
import json
import os

from benchmark import spec


def tiny_config(tier: str) -> dict:
    from csm_tpu_torch.codec.mimi import MimiCodecConfig
    from csm_tpu_torch.config import CSMConfig

    with open(os.path.join(spec.HERE, "configs",
                           "csm-1b-int4.json" if tier == "int4" else "csm-1b-bf16.json")) as f:
        conf = json.load(f)
    conf["model"] = CSMConfig.tiny(max_seq_len=256).to_dict()
    codec = dataclasses.asdict(MimiCodecConfig.tiny(num_quantizers=32))
    codec["upsampling_ratios"] = list(codec["upsampling_ratios"])
    conf["codec"] = codec
    return conf


def tiny_cell(traffic: str, tier: str, **overrides) -> dict:
    with open(os.path.join(spec.HERE, "traffic", traffic + ".json")) as f:
        t = json.load(f)
    if t["kind"] == "serve":
        t.update(window=128, prompt_frames=dict(t["prompt_frames"], min=8, max=40, median=16),
                 response_frames=dict(t["response_frames"], min=3, max=8), turn_frames=16,
                 text_frames=2, audio_codes=20, trace_start_s=0.5, trace_seconds=0.5,
                 check_requests=2, check_sampled=2, greedy_share=0.5, topk=8)
        if t["loop"] == "closed":
            t.update(clients=min(t["clients"], 4), slots=min(t["slots"], 4), pool=16)
    else:
        t.update(seq_len=96, accum=2, n_text=16, check_steps=2, trace_after_steps=0)
    t.update(overrides)
    return {"name": f"tiny-{traffic}", "chips": 1, "config_name": tier, "traffic_name": traffic,
            "config": tiny_config(tier), "traffic": t}
