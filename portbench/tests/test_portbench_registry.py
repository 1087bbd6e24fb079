"""The benchmark finds every cell, configuration and metric by name, and a
cell, configuration or metric added as files is picked up with no edit."""

import json
import re

from portbench import harness
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    return harness.load_json(harness.CHECKOUT, "BENCHMARK.json")


def test_spec_keys_and_names():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["portbench"]
    assert s["command"] == ["python3", "portbench/run.py"]
    assert 1 <= s["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in s[k]]
    assert all(NAME.match(n) for n in names)
    assert len({x["name"] for x in s["configs"]}) == len(s["configs"])
    assert len({x["name"] for x in s["workloads"]}) == len(s["workloads"])
    metrics = s["end_to_end"] + s["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in s["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
    pairs = {(w["config"], w["traffic"]) for w in s["workloads"]}
    assert len(pairs) == len(s["workloads"])
    assert sum(w["chips"] == 4 for w in s["workloads"]) <= 1
    assert len(json.dumps(s, indent=2)) < 64 * 1024


def test_every_cell_config_and_metric_is_found_by_name():
    s = spec()
    for c in s["configs"]:
        cfg = json.loads((harness.CHECKOUT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in s["workloads"])
    for w in s["workloads"]:
        cell = harness.Cell(harness.CHECKOUT, w["name"])
        assert cell.config["name"] == w["config"]
        for fn in ("setup", "solve", "release", "reference", "compare"):
            assert callable(getattr(cell.driver, fn))
        assert cell.limits
        reported = {m["name"] for m in cell.end_to_end + cell.per_layer}
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        assert all(m["moves"] in e2e for m in cell.per_layer)
    for m in s["end_to_end"] + s["per_layer"]:
        mod = harness.load_module(harness.HERE, "metrics", m["name"])
        assert callable(mod.read)


def test_added_files_are_picked_up_without_an_edit(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric, added
    as files and BENCHMARK.json entries only, run with no code edited."""
    root = tiny.make_copy(tmp_path)
    base = root / "portbench"
    cfg = json.loads((base / "configs" / "tiny-sphere2500.json").read_text())
    cfg.update(name="dummy-sphere", n_poses=30, n_loops=20)
    (base / "configs" / "dummy-sphere.json").write_text(json.dumps(cfg))
    tr = json.loads((base / "traffic" / "lm-dense.json").read_text())
    tr.update(starts=2, trace_solves=2)
    (base / "traffic" / "dummy-lm.json").write_text(json.dumps(tr))
    wl = json.loads((base / "workloads" / "sphere2500-lm-dense.json")
                    .read_text())
    wl.update(config="dummy-sphere", traffic="dummy-lm")
    (base / "workloads" / "dummy-cell.json").write_text(json.dumps(wl))
    (base / "metrics" / "dummy_solves.py").write_text(
        "def read(ctx):\n    return float(len(ctx['solves']))\n")
    s = json.loads((root / "BENCHMARK.json").read_text())
    s["configs"].append({"name": "dummy-sphere", "source": "test",
                         "file": "portbench/configs/dummy-sphere.json",
                         "reduced": ["n_poses"], "why": "test"})
    s["workloads"].append({"name": "dummy-cell", "config": "dummy-sphere",
                           "traffic": "dummy-lm", "chips": 1, "why": "t"})
    s["per_layer"].append({"name": "dummy_solves", "unit": "solves",
                           "better": "higher", "source": "program_counter",
                           "layer": "solver", "moves": "g2o_solve_ms",
                           "workloads": ["dummy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    res = harness.run(tiny.args("dummy-cell", trace=1), root=root,
                         device="cpu", require_card=False)
    assert res["correct"] is True
    assert res["metrics"]["dummy_solves"] == {"value": 2.0,
                                              "unit": "solves"}
    assert "lm_iters_per_solve" not in res["metrics"]   # not listed for it
