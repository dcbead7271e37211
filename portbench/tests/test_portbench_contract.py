"""The benchmark's files as the contract has them: names, units, files
found by name, and no import of JAX or of the JAX package."""

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CHECKOUT = ROOT.parent
BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
FORBIDDEN = {"jax", "jaxlib", "flax", "orbax", "dynamic_multiview_3d_tpu"}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("name", [e["name"] for e in BENCH["configs"]
                                  + BENCH["workloads"] + METRICS]
                         + [w["config"] for w in BENCH["workloads"]]
                         + [w["traffic"] for w in BENCH["workloads"]])
def test_names_use_allowed_characters(name):
    assert NAME.fullmatch(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.fullmatch(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert any(m["name"] == metric["moves"] for m in BENCH["end_to_end"])
        assert (ROOT / "metrics" / f"{metric['name']}.py").is_file()
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(cell):
    from portbench import harness
    loaded = harness.load_cell(cell["name"])
    driver = harness.kind(loaded)        # kinds/<kind>.py
    assert loaded["config_file"]["name"] == cell["config"]
    assert cell["chips"] in (1, 4)
    # the limits name numbers the cell's check computes
    assert set(loaded["limits"]) <= set(driver.NUMBERS)
    assert loaded["limits"]
    reported = {m["name"] for m in loaded["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2
    assert loaded["per_layer"]
    for m in loaded["per_layer"]:
        assert m["moves"] in reported


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    data = json.loads((CHECKOUT / conf["file"]).read_text())
    assert conf["file"].startswith("portbench/")
    assert data["reduced"] == conf["reduced"] == []
    assert data["source"] == conf["source"]
    from dynamic_multiview_3d_torch import config as config_lib
    preset = config_lib.to_dict(config_lib.get_config(conf["name"]))
    assert data["config"] == preset          # the preset verbatim


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


@pytest.mark.parametrize("path", sorted(ROOT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert tops <= {"__future__", "contextlib", "math", "torch",
                    "portbench"}, tops
    names = set(_imports(path))
    assert {n for n in names if n.startswith("portbench")} <= {
        "portbench", "portbench.byname", "portbench.reference"}, names


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys
    from portbench import run
    assert "dynamic_multiview_3d_torch" not in run.FORBIDDEN
    present = run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "dynamic_multiview_3d_tpu_like", sys)
    assert run.loaded_forbidden() == present
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert "flax" in run.loaded_forbidden()


def test_no_file_reads_the_jax_benchmarks():
    folder = "bench" + "marks/"
    for path in ROOT.rglob("*.py"):
        assert folder not in path.read_text(), path
