"""Tiny cells for the CPU tests: a cell of ``BENCHMARK.json`` with its
configuration's CPU twin (its family's ``tiny``) and its traffic file at
small sizes."""

from benchmark import spec


def tiny_traffic(t: dict) -> dict:
    """A traffic mix at a size the tiny model serves or trains in seconds."""
    t = dict(t)
    if t["kind"] == "serve":
        t.update(window=128, response_frames=dict(t["response_frames"], min=3, max=8),
                 audio_codes=20, trace_start_s=0.5, trace_seconds=0.5, check_requests=2,
                 check_sampled=2, greedy_share=0.5, topk=8)
        if t["loop"] == "closed":
            t.update(clients=min(t["clients"], 4), slots=min(t["slots"], 4))
        if t.get("sessions"):
            t.update(sessions=4, prefixes=min(t["prefixes"], 2),
                     prefix_segments=[[2, 10]] * len(t["prefix_segments"]),
                     turn_text_frames=dict(t["turn_text_frames"], min=2, max=4))
        else:
            t.update(prompt_frames=dict(t["prompt_frames"], min=8, max=40, median=16),
                     turn_frames=16, text_frames=2, pool=16)
    else:
        t.update(seq_len=96, accum=2, n_text=16, check_steps=2, trace_after_steps=0)
    return t


def tiny_cell(workload: str, bench: dict = None, root: str = None, **overrides) -> dict:
    """The cell ``workload`` of ``bench`` (default: the committed
    ``BENCHMARK.json``; ``root``: where its configuration files lie) at a
    tiny size; ``overrides`` replace traffic parameters."""
    bench = spec.load_benchmark() if bench is None else bench
    cell = spec.cell(bench, workload, root or spec.ROOT)
    t = dict(tiny_traffic(cell["traffic"]), **overrides)
    return dict(cell, config=spec.family(cell["config"]).tiny(cell["config"]), traffic=t)
