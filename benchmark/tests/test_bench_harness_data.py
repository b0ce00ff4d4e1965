"""The harness is driven by data: a mix and a metric are found by name,
and ``BENCHMARK.json`` keeps to the characters and keys its format
allows."""

import json
import os
import re

import pytest

from benchmark import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as _fh:
    SPEC = json.load(_fh)

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "workloads", "layer", "moves"}


def test_mix_and_metric_found_by_name(tmp_path, monkeypatch):
    mixes, metrics = tmp_path / "mixes", tmp_path / "metrics"
    mixes.mkdir()
    metrics.mkdir()
    (mixes / "tiny_mix.json").write_text(json.dumps({"molecules": 3}))
    (metrics / "twice_reads.demo.py").write_text("def read(obs):\n    return 2 * obs['reads']\n")
    (metrics / "twice_reads.py").write_text("def read(obs):\n    return obs['reads']\n")
    monkeypatch.setattr(run, "MIXES", str(mixes))
    monkeypatch.setattr(run, "METRICS", str(metrics))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "umi_correction.tiny_mix", "config": "umi_correction",
                              "traffic": "tiny_mix", "chips": 1, "why": "test"})
    next(m for m in spec["end_to_end"] if m["name"] == "peak_gib.correction")[
        "workloads"].append("umi_correction.tiny_mix")
    spec["per_layer"].append({"name": "twice_reads.demo", "unit": "reads", "better": "higher",
                              "source": "host_clock", "layer": "entry points",
                              "moves": "peak_gib.correction",
                              "workloads": ["umi_correction.tiny_mix"]})
    cell, config, mix, chain, e2e, layer = run.load_cell("umi_correction.tiny_mix", spec)
    assert mix == {"molecules": 3} and chain.__name__.endswith("umi_correction")
    assert [m["name"] for m in layer][-1] == "twice_reads.demo"
    assert {"peak_gib.correction", "setup_s"} == {m["name"] for m in e2e}
    assert run.reader("twice_reads.demo")({"reads": 21}) == 42
    assert run.reader("twice_reads.other.x")({"reads": 21}) == 21  # the stem's reader


def _metrics():
    return SPEC["end_to_end"] + SPEC["per_layer"]


@pytest.mark.parametrize("m", _metrics(), ids=lambda m: m["name"])
def test_metric_entries(m):
    assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
    assert set(m) <= METRIC_KEYS and m["better"] in ("lower", "higher")
    assert os.path.exists(run.reader_path(m["name"]))
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if "bound" in m:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    else:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cells(w):
    assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"])
    assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    assert 1 <= len(w["why"]) <= 200
    assert os.path.exists(os.path.join(run.MIXES, w["traffic"] + ".json"))
    e2e = [m for m in SPEC["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert any(w["name"] in m.get("workloads", [w["name"]]) for m in SPEC["per_layer"])


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_configs(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.fullmatch(c["name"]) and all(NAME.fullmatch(k) for k in c["reduced"])
    assert c["file"].startswith(SPEC["paths"][0] + "/") and os.path.exists(
        os.path.join(ROOT, c["file"]))
    assert os.path.exists(os.path.join(run.BENCH, "configs", c["name"] + ".py"))
    with open(os.path.join(ROOT, c["file"])) as fh:
        assert set(c["reduced"]) <= set(json.load(fh))


def test_spec_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51 and SPEC["paths"] == ["benchmark"]
    names = [m["name"] for m in _metrics()]
    assert len(names) == len(set(names)) and "setup_s" in names
    assert len(json.dumps(SPEC)) < 64 * 1024
