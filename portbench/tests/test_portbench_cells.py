"""The harness is driven by data: a cell, a configuration, a traffic mix,
a generator or a metric is a file found by name, and BENCHMARK.json names
only what the files hold."""

import json
import os
import re
import shutil

import pytest

from portbench import core
from portbench.testing import CHECKOUT_ROOT, run_small

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def benchmark():
    with open(os.path.join(CHECKOUT_ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def reports(workload: str) -> tuple:
    """The end-to-end metrics a cell reports (its generator's)."""
    return ("setup_s", "peak_gib") + tuple(core.load_module("generators", core.cell(workload)["generator"]).E2E)


def test_every_cell_resolves_to_its_files():
    for w in core.names("workloads", ".json"):
        c = core.cell(w)
        assert NAME.match(w) and NAME.match(c["config_name"]) and NAME.match(c["traffic"])
        assert c["chips"] in (1, 4)
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        generator = core.load_module("generators", c["generator"])
        assert generator.E2E and all(callable(f) for f in generator.E2E.values())
        assert set(c["limits"]) and all(v >= 0 for v in c["limits"].values())


def test_benchmark_json_names_what_the_files_hold():
    b = benchmark()
    assert b["command"] == ["python3", "portbench/run.py"] and b["paths"] == ["portbench"]
    cells = {w["name"]: w for w in b["workloads"]}
    assert set(cells) <= set(core.names("workloads", ".json"))
    for name, w in cells.items():
        c = core.cell(name)
        assert (w["config"], w["traffic"], w["chips"], w["why"]) == (c["config_name"], c["traffic"], c["chips"], c["why"])
    for cfg in b["configs"]:
        assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
        assert cfg["reduced"] == core.load_json("configs", cfg["name"])["reduced"]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for name in cells:
        listed = {m for m, d in e2e.items() if name in d.get("workloads", cells)}
        assert listed == set(reports(name)), name
    mods = core.metric_modules()
    for m in b["per_layer"]:
        mod = mods[m["name"]]
        assert (m["unit"], m["moves"]) == (mod.UNIT, mod.MOVES), m["name"]
        for name in m.get("workloads", cells):
            assert m["moves"] in reports(name), (m["name"], name)


def test_every_pair_of_config_and_traffic_is_given_once():
    b = benchmark()
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in core.names("workloads", ".json"):
        assert "generator" not in core.load_json("workloads", w)
    for mix in core.names("traffic", ".json"):
        spec = core.load_json("traffic", mix)
        assert NAME.match(mix) and spec["generator"] in core.names("generators", ".py")


def test_a_new_workload_file_adds_a_cell(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(core.ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    mix = core.load_json("traffic", "fixed_base.gather")
    mix["params"]["a"] = 4  # another base of the same configuration: a new mix, as data alone
    (root / "traffic" / "fixed_base.a4.json").write_text(json.dumps(mix))
    spec = core.load_json("workloads", "shor8191-n28.gather")
    spec["traffic"] = "fixed_base.a4"
    spec["why"] = "a cell added as data alone"
    (root / "workloads" / "shor8191-n28.base4.json").write_text(json.dumps(spec))
    assert "shor8191-n28.base4" in core.names("workloads", ".json", str(root))
    assert "shor8191-n28.base4" not in core.names("workloads", ".json")
    assert core.cell("shor8191-n28.base4", str(root))["params"]["a"] == 4
    r = run_small("shor8191-n28.base4", root=str(root))
    assert r["correct"] and r["attempted"] > 0


def test_a_new_metric_file_is_read(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(core.ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "metrics" / "attempts.count.py").write_text(
        'UNIT = "1"\nMOVES = "attempt_ms"\n\n\ndef read(obs):\n    return obs.counters.get("attempts") or None\n'
    )
    r = run_small("shor8191-n28.gather", trace=True, root=str(root))
    assert r["metrics"]["attempts.count"]["value"] >= 1
    assert "driver.host_ms" in r["metrics"]


@pytest.mark.parametrize("workload", ["shor8191-n28.gather", "shor8191-n28.gather-sweep", "sc1060314373-m30.attempts"])
def test_result_line_keys(workload):
    r = run_small(workload, seconds=0.2)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["metrics"]) >= {"setup_s", "peak_gib"}
    assert all(set(v) == {"value", "limit"} for v in r["checks"].values())
