"""Model families as files: the ``csm`` family gives the existing
configurations bitwise the weights, the FLOPs and the check's readings that
the benchmark gave them before families existed (literals read from that
tree), and a family added as files alone runs a cell through ``run.py``."""

import hashlib
import json
import math
import os

import numpy as np
import pytest
import torch

from benchmark import spec
from benchmark import traffic as gen
from benchmark import weights
from benchmark.drivers import serve, train
from benchmark.shapes import csm_shapes, leaves
from benchmark.tests.harness import run_tiny
from benchmark.tests.tiny import tiny_cell

CONFIGS = [c["name"] for c in spec.load_benchmark()["configs"]]


def conf_of(name: str) -> dict:
    bench = spec.load_benchmark()
    path = {c["name"]: c["file"] for c in bench["configs"]}[name]
    with open(os.path.join(spec.ROOT, path)) as f:
        return json.load(f)


def digest(tree: dict) -> str:
    h = hashlib.sha256()
    for n, p in leaves(tree):
        h.update(n.encode())
        h.update(str(tuple(p.shape)).encode())
        h.update(str(p.dtype).encode())
        raw = p.view(torch.int16) if p.dtype == torch.bfloat16 else p.contiguous().view(torch.uint8)
        h.update(raw.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", CONFIGS)
def test_the_family_draws_the_weights_as_before(name):
    conf = conf_of(name)
    assert "family" not in conf
    fam = spec.family(conf)
    tiny = fam.config(fam.tiny(conf)["model"])
    seed = 2 ** 31 + 11
    assert digest(weights.model_params(fam, tiny, seed, torch.float32, "cpu")) == \
        "c203a85e7d3bfc43dcd542a479577563956932117e042edaa30e7b9b44ecb8e1"
    assert digest(weights.model_params(fam, tiny, seed, torch.bfloat16, "cpu")) == \
        "1b9dba549902d3b5bd3e1c7e83ca6764b2167849e496e69ab09add07f27f821d"
    cfg = fam.config(conf["model"])
    got = [(p, tuple(s)) for p, s, _, _ in fam.shapes(cfg)]
    assert got == [(p, tuple(s)) for p, s in leaves(csm_shapes(cfg))]
    assert len(got) == 25 and sum(math.prod(s) for _, s in got) == 1_552_791_552


@pytest.mark.parametrize("name", CONFIGS)
def test_the_family_counts_the_flops_as_before(name):
    conf = conf_of(name)
    fam = spec.family(conf)
    cfg = fam.config(conf["model"])
    assert [fam.prefill_flops(cfg, S) for S in (128, 512, 2048)] == \
        [250198622208.0, 1013679390720.0, 4260875993088.0]
    assert [fam.frame_flops(cfg, c) for c in (100, 1024)] == [9132627968.0, 9253738496.0]
    assert fam.train_sequence_flops(cfg, 2048, 124) == 15666623324160.0
    assert [fam.request_flops(cfg, 128, 40), fam.request_flops(cfg, 300, 0),
            fam.request_flops(cfg, 37, 5)] == [613806489600.0, 0.0, 115779254272.0]
    assert fam.prefill_flops(cfg, 300, 300) == fam.prefill_flops(cfg, 300)


def test_a_continuation_attends_its_prefix():
    """A 48-frame continuation of a 128-frame prefix: each of its positions
    attends the prefix's 128 keys besides its own causal half, and each of
    its 10 frames 128 more keys than without the prefix."""
    fam = spec.family({})
    cfg = fam.config(conf_of("csm-1b-int4")["model"])
    attn = 4 * 32 * 64 * 16  # 2 * 2 * heads * head size * layers, per (query, key)
    assert fam.prefill_flops(cfg, 48, 176) - fam.prefill_flops(cfg, 48) == attn * 48 * 128
    assert fam.request_flops(cfg, 48, 10, 128) - fam.request_flops(cfg, 48, 10) == \
        attn * 48 * 128 + 10 * attn * 128


# The check's readings on fixed requests and frames (tiny model, seed 77),
# program and controls, as the benchmark read them before families existed.
CHECKS = {
    "int4": {"program": [3, 1, 0.6138260364532471, 0.3310355842113495],
             "lower": [3, 1, 0.0617014616727829, 0.06327180564403534],
             "no_topk": [3, 1, 0.0, 0.4076725244522095]},
    "exact": {"program": [3, 1, 0.6155191659927368, 0.19482968747615814, 0.3329971730709076],
              "lower": [3, 1, 0.0027027428150177, 1.6605481505393982e-05, 0.0006795898079872131],
              "fp8": [3, 1, 0.011104017496109009, 0.00022481786436401308, 0.006023608148097992],
              "drafts": [3, 1, 0.0027027428150177, 1.383467224513879e-05, 0.0006795898079872131],
              "no_topk": [3, 1, 0.0, 0.0, 0.4076725244522095]},
}


@pytest.mark.parametrize("workload", ["int4-serve-audio", "bf16-exact-stream"])
def test_the_check_reads_as_before(workload):
    cell = tiny_cell(workload)
    conf, t = cell["config"], cell["traffic"]
    fam = spec.family(conf)
    cfg = fam.config(conf["model"])
    params = weights.model_params(fam, cfg, 77, torch.bfloat16, "cpu")
    reqs = gen.requests(t, cfg, 5, 2.0)[:4]
    rng = np.random.default_rng(9)
    got = [(r, r.ids, r.mask, rng.integers(0, cfg.audio_vocab_size, (5, 32)), None) for r in reqs]
    want = CHECKS[conf["tier"]]
    assert set(fam.reference.controls(conf["tier"])) == set(want) - {"program"}
    for control, values in want.items():
        c = None if control == "program" else control
        read = [v for _, v, _, _ in serve.check(fam, params, cfg, conf, t, None, None, got,
                                                control=c, seed=123)]
        assert read == pytest.approx(values, rel=1e-5, abs=1e-9), control


def test_the_training_reference_reads_as_before():
    cell = tiny_cell("bf16-train-s2048")
    conf, t = cell["config"], cell["traffic"]
    fam = spec.family(conf)
    cfg = fam.config(conf["model"])
    r = train.reference_readings(fam, cfg, conf, t, 41, torch.device("cpu"),
                                 train.straight_through(fam.reference.bf16_round))
    assert r["loss"] == pytest.approx([6.298168897628784, 6.297521352767944], rel=1e-6)
    assert r["grad_norm"] == pytest.approx([1.1604076623916626, 1.1385630369186401], rel=1e-5)
    assert fam.train_sequence_flops(cfg, 96, 5) == 73717824.0


def stand_in(tmp_path) -> tuple:
    """A checkout in ``tmp_path`` whose benchmark has one more family,
    ``alt`` (the ``csm`` functions bound under another name), one more
    configuration naming it and one more cell: new files and entries only,
    the rest of the benchmark linked in as it is."""
    root = tmp_path / "root"
    here = root / "benchmark"
    (here / "families").mkdir(parents=True)
    (here / "configs").mkdir()
    for d in ("metrics", "traffic", "drivers"):
        (here / d).symlink_to(os.path.join(spec.HERE, d))
    real = os.path.join(spec.HERE, "families", "csm.py")
    (here / "families" / "alt.py").write_text(
        "import importlib.util\n"
        f"_spec = importlib.util.spec_from_file_location('alt_as_csm', {real!r})\n"
        "_csm = importlib.util.module_from_spec(_spec)\n"
        "_spec.loader.exec_module(_csm)\n"
        "globals().update({k: v for k, v in vars(_csm).items() if not k.startswith('__')})\n")
    conf = dict(conf_of("csm-1b-int4"), name="alt-int4", family="alt")
    (here / "configs" / "alt-int4.json").write_text(json.dumps(conf))
    bench = spec.load_benchmark()
    bench["configs"].append(dict(bench["configs"][0], name="alt-int4",
                                 file="benchmark/configs/alt-int4.json"))
    bench["workloads"].append({"name": "alt-serve-audio", "config": "alt-int4",
                               "traffic": "serve-audio", "chips": 1, "why": "a stand-in"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "int4-serve-audio" in m.get("workloads", []):
            m["workloads"].append("alt-serve-audio")
    return str(root), str(here), bench


def test_a_family_added_as_files_runs_a_cell(tmp_path, monkeypatch, capsys):
    root, here, bench = stand_in(tmp_path)
    monkeypatch.setattr(spec, "HERE", here)
    fam = spec.family({"family": "alt"})
    assert fam.__file__ == os.path.join(here, "families", "alt.py")
    with pytest.raises(FileNotFoundError):
        spec.family({"family": "no-such-family"})
    out = run_tiny(monkeypatch, capsys, "alt-serve-audio", bench=bench, root=root, seconds=2.0)
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {m["name"] for m in spec.cell_metrics(bench, "alt-serve-audio",
                                                                        "end_to_end")}
