"""The registry finds a configuration, a cell and a metric by name, and
``BENCHMARK.json`` keeps to the shape the benchmark's contract gives it."""

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


def test_cells_find_their_files(bench):
    for w in bench["workloads"]:
        c = spec.cell(bench, w["name"])
        assert c["config"]["name"] == w["config"] and c["traffic"]["kind"] in ("serve", "train")
        assert spec.driver(c["traffic"]["kind"]).run
        assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["name"])
    with pytest.raises(KeyError):
        spec.cell(bench, "no-such-cell")
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_configs(bench):
    for c in bench["configs"]:
        assert c["file"].startswith("benchmark/configs/") and os.path.exists(
            os.path.join(spec.ROOT, c["file"]))
        assert c["reduced"] == [] and c["source"].startswith("https://")
        assert any(w["config"] == c["name"] for w in bench["workloads"])


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
