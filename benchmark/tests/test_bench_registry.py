"""The registry finds a configuration, a cell and a metric by name, and
``BENCHMARK.json`` keeps to the shape the benchmark's contract gives it."""

import copy
import json
import os
import re

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "benchmark/run.py"] and bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024


def cells(bench: dict, root: str = None) -> dict:
    return {w["name"]: spec.cell(bench, w["name"], root or spec.ROOT) for w in bench["workloads"]}


def problems(bench: dict, loaded: dict) -> list:
    """What breaks the registry's rules, which follow the files: a traffic
    ``kind`` needs ``drivers/<kind>.py``, a configuration's family
    ``families/<family>.py``; ``chips`` is 1 or 4, with at most a quarter of
    the cells (rounded down; one is always allowed) on 4; ``reduced`` names
    keys of the configuration's ``model``."""
    out = []
    for w in bench["workloads"]:
        c = loaded[w["name"]]
        kind, fam = c["traffic"]["kind"], c["config"].get("family", "csm")
        if not os.path.exists(os.path.join(spec.HERE, "drivers", kind + ".py")):
            out.append(f"{w['name']}: no driver for kind {kind!r}")
        if not os.path.exists(os.path.join(spec.HERE, "families", fam + ".py")):
            out.append(f"{w['name']}: no family {fam!r}")
        if w["chips"] not in (1, 4):
            out.append(f"{w['name']}: {w['chips']} chips")
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    if four > max(1, len(bench["workloads"]) // 4):
        out.append(f"{four} of {len(bench['workloads'])} cells on 4 chips")
    for c in bench["configs"]:
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            model = json.load(f)["model"]
        if not isinstance(c["reduced"], list) or any(k not in model for k in c["reduced"]):
            out.append(f"{c['name']}: reduced {c['reduced']!r} names no key of its model")
    return out


def test_cells_find_their_files(bench):
    loaded = cells(bench)
    assert problems(bench, loaded) == []
    for w in bench["workloads"]:
        c = loaded[w["name"]]
        assert c["config"]["name"] == w["config"]
        assert spec.driver(c["traffic"]["kind"]).run
        assert spec.family(c["config"]).bundles
        assert len(w["why"]) <= 200 and NAME.match(w["name"])
    with pytest.raises(KeyError):
        spec.cell(bench, "no-such-cell")
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_configs(bench):
    """Each configuration's file lies under ``benchmark/configs/``, its
    source is a public URL, some cell uses it, and its ``reduced`` keeps to
    the rule of :func:`problems` (tested there)."""
    for c in bench["configs"]:
        assert c["file"].startswith("benchmark/configs/") and os.path.exists(
            os.path.join(spec.ROOT, c["file"]))
        assert isinstance(c["reduced"], list) and c["source"].startswith("https://")
        assert any(w["config"] == c["name"] for w in bench["workloads"])


def more_cells(bench: dict, n: int, four: int) -> tuple:
    """``bench`` grown to ``n`` cells (copies of its first), ``four`` of them
    on 4 chips."""
    b = copy.deepcopy(bench)
    first = b["workloads"][0]
    b["workloads"] = [dict(first, name=f"cell-{i}", chips=4 if i < four else 1) for i in range(n)]
    loaded = cells(bench)
    return b, {w["name"]: loaded[first["name"]] for w in b["workloads"]}


@pytest.mark.parametrize("n,four,ok", [(5, 1, True), (5, 2, False), (4, 1, True), (16, 4, True),
                                       (16, 5, False), (24, 6, True), (24, 7, False)])
def test_at_most_a_quarter_of_the_cells_take_four_chips(bench, n, four, ok):
    b, loaded = more_cells(bench, n, four)
    assert (problems(b, loaded) == []) is ok


@pytest.mark.parametrize("part,key,value,found", [
    ("traffic", "kind", "stream-of-consciousness", "no driver"),
    ("config", "family", "no-such-family", "no family"),
])
def test_an_unknown_kind_or_family_is_refused(bench, part, key, value, found):
    loaded = cells(bench)
    name = bench["workloads"][0]["name"]
    loaded[name] = dict(loaded[name], **{part: dict(loaded[name][part], **{key: value})})
    assert [p for p in problems(bench, loaded) if found in p]


def test_reduced_names_keys_of_the_model(bench):
    loaded = cells(bench)
    b = copy.deepcopy(bench)
    b["configs"][0]["reduced"] = ["max_seq_len"]
    assert problems(b, loaded) == []
    b["configs"][0]["reduced"] = ["num_hidden_layerz"]
    assert problems(b, loaded) == [f"{b['configs'][0]['name']}: reduced ['num_hidden_layerz'] "
                                   "names no key of its model"]
    b["configs"][0]["reduced"] = "max_seq_len"
    assert problems(b, loaded)


def test_every_metric_has_a_reader_and_every_cell_its_metrics(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
        assert m["better"] in ("lower", "higher") and re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in bench["end_to_end"]}["setup_s"] == 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and len({x["layer"] for x in bench["per_layer"]
                                         if x["name"].split(".")[0] == m["name"].split(".")[0]}) == 1
        for w in m["workloads"]:
            assert m["moves"] in [x["name"] for x in spec.cell_metrics(bench, w, "end_to_end")]
    for w in bench["workloads"]:
        got = [m["name"] for m in spec.cell_metrics(bench, w["name"], "end_to_end")]
        assert "setup_s" in got and len(got) >= 2
        assert spec.cell_metrics(bench, w["name"], "per_layer")


def test_reader_loads_by_file_name(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "answer.x.py").write_text("def read(run):\n    return 42.0\n")
    monkeypatch.setattr(spec, "HERE", str(tmp_path))
    assert spec.reader("answer.x")(None) == 42.0


def test_a_dotted_metric_falls_back_to_its_prefix(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "answer.py").write_text("def read(run):\n    return 1.0\n")
    (tmp_path / "metrics" / "answer.own.py").write_text("def read(run):\n    return 2.0\n")
    monkeypatch.setattr(spec, "HERE", str(tmp_path))
    assert spec.reader("answer.stream")(None) == 1.0
    assert spec.reader("answer.own")(None) == 2.0
    with pytest.raises(FileNotFoundError):
        spec.reader("question.stream")
