"""The manifest's names and files, and a cell added by files alone."""
import json
import shutil

import pytest

from portbench.harness import manifest

BENCH = manifest.load_manifest()


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_valid(kind):
    for item in BENCH[kind]:
        assert manifest.NAME_RE.match(item["name"]), item["name"]
        if "unit" in item:
            assert manifest.UNIT_RE.match(item["unit"]), item["unit"]
        if "traffic" in item:
            assert manifest.NAME_RE.match(item["traffic"])


def test_manifest_has_no_problems():
    assert manifest.problems(BENCH) == []


@pytest.mark.parametrize("bad", ["a b", "a,b", "a/b", "", "-a", "x" * 65,
                                 "μs"])
def test_bad_names_refused(bad):
    assert not manifest.NAME_RE.match(bad)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    entry = manifest.entry(BENCH["workloads"], cell, "workload")
    params = manifest.cell_params(cell)
    assert params["config"] == entry["config"]
    assert manifest.config_params(BENCH, entry["config"])["name"] == \
        entry["config"]
    drv = manifest.load_module(manifest.driver_path(params["driver"]),
                               "drivers." + params["driver"])
    for fn in ("setup", "window", "release", "check"):
        assert callable(getattr(drv, fn))
    ref = manifest.load_module(manifest.reference_path(entry["config"]),
                               "reference." + entry["config"])
    assert ref.__doc__
    e2e = manifest.end_to_end_metrics(BENCH, cell)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    layers = manifest.per_layer_metrics(BENCH, cell)
    assert layers
    names = {m["name"] for m in e2e}
    for m in layers:
        assert m["moves"] in names
        reader = manifest.load_module(manifest.metric_path(m["name"]),
                                      "metrics." + m["name"])
        assert reader.read({"spans": [], "counts": {}, "profiled": None,
                            "window_s": 1.0}) is None


def test_new_workload_found_without_edit(tmp_path):
    """A cell that a later change adds: one workload file and one entry;
    every file already there stays byte for byte."""
    root = tmp_path / "checkout"
    shutil.copytree(manifest.BENCH_DIR, root / "portbench")
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    old = BENCH["workloads"][0]
    bench["workloads"].append(dict(old, name="extra-cell",
                                   traffic="extra", why="a test cell"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if old["name"] in m.get("workloads", []):
            m["workloads"].append("extra-cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    params = dict(manifest.cell_params(old["name"]), note="new mix")
    (root / "portbench" / "workloads" / "extra-cell.json").write_text(
        json.dumps(params))
    loaded = manifest.load_manifest(root)
    assert manifest.problems(loaded, root) == []
    assert manifest.cell_params("extra-cell",
                                root / "portbench")["note"] == "new mix"
    assert {m["name"] for m in manifest.per_layer_metrics(loaded,
                                                          "extra-cell")} \
        == {m["name"] for m in manifest.per_layer_metrics(loaded,
                                                          old["name"])}
    for p, data in before.items():
        assert p.read_bytes() == data
