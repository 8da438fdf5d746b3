"""BENCHMARK.json against the benchmark's contract, and the harness's
finding of every part by name."""
import json
import os
import re
import shutil

import pytest

from benchmark.harness import spec

ROOT = spec.ROOT
BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["benchmark"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_benchmark_names_and_units_use_allowed_characters():
    names = [e["name"] for part in ("configs", "workloads", "end_to_end",
                                    "per_layer") for e in BENCH[part]]
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in BENCH[part]]
        assert len(got) == len(set(got)), part


def test_benchmark_one_line_texts():
    texts = [c["source"] for c in BENCH["configs"]]
    texts += [e["why"] for e in BENCH["configs"] + BENCH["workloads"]]
    texts += [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t


def test_benchmark_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_benchmark_cell_parts_are_found_by_name(cell):
    c = spec.Cell(cell)
    assert c.config["name"] == c.workload["config"]
    assert c.driver.Driver is not None
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.traffic["rate_metric"] in names
    assert c.per_layer and set(c.readers) == {m["name"]
                                              for m in c.per_layer}
    for m in c.per_layer:
        assert m["moves"] in names
        assert callable(c.readers[m["name"]].read)


def test_benchmark_config_files_lie_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith("benchmark/") and os.path.exists(
            os.path.join(ROOT, f))


@pytest.mark.parametrize("kind", ["config", "traffic"])
def test_benchmark_a_new_file_is_found_without_edits(tmp_path, kind):
    """A cell added as data (a configuration or a traffic file and a
    BENCHMARK.json entry) is found without editing any file."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cell = dict(bench["workloads"][0])
    if kind == "config":
        cfg = json.loads((tmp_path / "benchmark" / "configs"
                          / "sloika_pretrained.json").read_text())
        cfg["name"] = "sloika_pretrained_copy"
        (tmp_path / "benchmark" / "configs"
         / "sloika_pretrained_copy.json").write_text(json.dumps(cfg))
        bench["configs"].append(dict(
            bench["configs"][0], name="sloika_pretrained_copy",
            file="benchmark/configs/sloika_pretrained_copy.json"))
        cell.update(name="basecall_chunked.copy",
                    config="sloika_pretrained_copy")
    else:
        t = json.loads((tmp_path / "benchmark" / "traffic"
                        / "basecall_chunked.json").read_text())
        t["reads"] = 7
        (tmp_path / "benchmark" / "traffic"
         / "basecall_short.json").write_text(json.dumps(t))
        cell.update(name="basecall_short.sloika_pretrained",
                    traffic="basecall_short")
    bench["workloads"].append(cell)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if cell["config"] != "raw_0.98_rgrgr" and "workloads" in m and \
                bench["workloads"][0]["name"] in m["workloads"]:
            m["workloads"].append(cell["name"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.Cell(cell["name"], root=str(tmp_path))
    assert c.config["name"] == cell["config"]
    if kind == "traffic":
        assert c.traffic["reads"] == 7
    assert {m["name"] for m in c.per_layer} >= {"idle_pct.basecall"}
