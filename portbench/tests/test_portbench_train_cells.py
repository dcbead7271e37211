"""The files of the two train cells that run the recurrent encoder under
remat, ``c5.train-b128`` and ``c3md.train``: c5's configuration (the
preset with its mesh cut to one device, the cut listed), their traffic
files and kinds, and the reader of the encoder's recomputation."""

import json
import types

import pytest

from portbench import harness
from portbench.trace import Trace
from dynamic_multiview_3d_torch.utils import profiling

BENCH = json.loads((harness.CHECKOUT / "BENCHMARK.json").read_text())
CELLS = {"c5.train-b128": ("c5", "train_hostbatch_blocked"),
         "c3md.train": ("c3md", "train_resident")}
T0 = 1_792_320_405_000_000_000          # ns, a time.time_ns() of 2026
MS = 1_000_000


def _flat(d: dict, pre="") -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}."))
        else:
            out[f"{pre}{k}"] = v
    return out


def test_c5_is_the_preset_with_only_its_mesh_cut():
    from dynamic_multiview_3d_torch import config as config_lib
    conf = next(c for c in BENCH["configs"] if c["name"] == "c5")
    data = json.loads((harness.CHECKOUT / conf["file"]).read_text())
    assert data["reduced"] == conf["reduced"] == ["mesh.data",
                                                   "mesh.multihost"]
    assert data["source"] == conf["source"]
    preset = _flat(config_lib.to_dict(config_lib.get_config("c5")))
    got = _flat(data["config"])
    assert set(got) == set(preset)
    assert {k for k in got if got[k] != preset[k]} == set(conf["reduced"])
    assert (got["mesh.data"], got["mesh.multihost"]) == (1, False)
    # the published step whole: every width, B 128, T 4, K 2, remat
    assert (got["data.batch_size"], got["data.seq_len"],
            got["data.num_targets"], got["model.image_size"],
            got["model.num_levels"], got["model.remat_scan"]) == (
        128, 4, 2, 256, 6, True)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_traffic_and_kind(name):
    config, kind = CELLS[name]
    cell = harness.load_cell(name)
    t = cell["traffic_file"]
    assert cell["config"] == config and t["kind"] == kind
    module = harness.kind(cell)
    for attr in ("Work", "flops", "control", "FAULTS", "NUMBERS"):
        assert hasattr(module, attr), attr
    assert set(cell["limits"]) <= set(module.NUMBERS)
    assert {"unchanged", "half_batch", "double"} <= set(module.FAULTS)
    d = cell["config_file"]["config"]["data"]
    # the traffic is the configuration's own batch, frames and targets
    assert (t["batch"], t["seq_len"], t["targets"], t["src_views"]) == (
        d["batch_size"], d["seq_len"], d["num_targets"], d["src_views"])
    names = {m["name"] for m in cell["per_layer"]}
    assert "recompute_ms_per_step.train" in names
    assert {m["name"] for m in cell["end_to_end"]} == {
        "train_views_per_s", "peak_mem_gib", "setup_s"}


def _recording(spans):
    rec = profiling.Recording(profiling.LIMIT)
    for uid in (1, 2):
        base = 20 * (uid - 1)
        rec.add(rec.units, profiling.Unit(uid, 1, T0 + base * MS,
                                          T0 + (base + 20) * MS))
        first = len(rec.spans)
        for name, s, e, parent in spans:
            rec.add(rec.spans, profiling.Span(
                name, uid, None if parent is None else first + parent, 1,
                T0 + (base + s) * MS, T0 + (base + e) * MS))
    return rec


REMAT = [("dmv3d.encode", 0, 3, None),
         ("dmv3d.train.backward", 5, 15, None),
         ("dmv3d.encode.recompute", 6, 8, 1),
         ("dmv3d.encode.recompute", 9, 10, 1)]


@pytest.mark.parametrize("name,want", [
    ("recompute_ms_per_step.train", 2 + 1),
    ("backward_ms_per_step.train", 10 - 3),    # less the recomputation
])
def test_recompute_reads_its_self_ms_and_leaves_the_backward(
        monkeypatch, name, want):
    monkeypatch.setattr(profiling, "recordings",
                        lambda: [_recording(REMAT)], raising=False)
    got = harness.run_reader(name, types.SimpleNamespace(trace=None))
    assert got == pytest.approx(want, rel=1e-9)


def test_recompute_reads_none_without_a_recording(monkeypatch):
    run = types.SimpleNamespace(trace=Trace(2, 0.02, 0.0, [], {}, 0))
    name = "recompute_ms_per_step.train"
    monkeypatch.delattr(profiling, "recordings")
    assert harness.run_reader(name, run) is None
    monkeypatch.setattr(profiling, "recordings", lambda: [], raising=False)
    assert harness.run_reader(name, run) is None
    # c2.train's step: a backward and no recomputation
    flat = _recording([("dmv3d.train.backward", 5, 15, None)])
    monkeypatch.setattr(profiling, "recordings", lambda: [flat])
    assert harness.run_reader(name, run) is None
