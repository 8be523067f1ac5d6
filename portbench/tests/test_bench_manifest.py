"""The harness finds a cell's configuration, traffic, limits and metric
readers by name: a new cell, configuration, mix and metric need new files
and manifest entries only."""
import hashlib
import json
import shutil
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]


def digest(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "portbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_every_cell_resolves():
    man = harness.load_manifest()
    for w in man["workloads"]:
        cell = harness.find_cell(w["name"])
        assert (ROOT / "portbench" / "drivers"
                / f"{cell.traffic['driver']}.py").is_file()
        assert cell.limits["numbers"]
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(harness.reader(m["name"]))
            assert m["moves"] in [e["name"] for e in cell.end_to_end]


def test_new_files_are_found_without_edits(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digest(tmp_path)
    pb = tmp_path / "portbench"
    (pb / "configs" / "lss-r50.json").write_text(json.dumps(
        {"name": "lss-r50", "function": "ocrfdet_config",
         "overrides": {"with_ocrf": False, "head": {"post_max_size": 400},
                       "data": {"input_size": [256, 704]}},
         "reduced": [], "assumed": []}))
    (pb / "traffic" / "serve-closed-b2.json").write_text(json.dumps(
        {"driver": "serve", "batch": 2, "inputs": 4, "warmup": 1,
         "forward_m": [0, 7.5], "yaw_rad": [-0.1, 0.1], "sample": 2,
         "traced": 2, "untraced_share": 0.67}))
    (pb / "limits" / "lss-serve-b2.json").write_text(json.dumps(
        {"numbers": {"heads": {"limit": 0.5}}}))
    (pb / "metrics" / "requests.serve.py").write_text(
        "def read(rec):\n    return float(len(rec.get('timings', []))) or None\n")
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "lss-r50", "source": "x",
                           "file": "portbench/configs/lss-r50.json",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": "lss-serve-b2", "config": "lss-r50",
                             "traffic": "serve-closed-b2", "chips": 1,
                             "why": "x"})
    man["per_layer"].append({"name": "requests.serve", "unit": "n",
                             "better": "higher", "source": "host_clock",
                             "layer": "entry", "moves": "setup_s",
                             "workloads": ["lss-serve-b2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    after = digest(tmp_path)
    assert all(after[k] == v for k, v in before.items())   # nothing edited
    cell = harness.find_cell("lss-serve-b2", root=tmp_path)
    assert cell.config["overrides"]["with_ocrf"] is False
    assert cell.traffic["batch"] == 2
    assert cell.limits["numbers"]["heads"]["limit"] == 0.5
    assert [m["name"] for m in cell.per_layer] == ["requests.serve"]
    read = harness.reader("requests.serve", root=tmp_path)
    assert read({"timings": [{}, {}]}) == 2.0
    for cfg in (harness.reference_config(cell.config, batch_size=2),
                harness.program_config(cell.config, batch_size=2)):
        assert cfg.with_ocrf is False and cfg.batch_size == 2
        assert cfg.head.post_max_size == 400 and cfg.head.max_num == 500
        assert cfg.data.input_size == (256, 704) and cfg.data.num_cams == 6


def test_manifest_shape():
    man = harness.load_manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["command"] == ["python3", "portbench/run.py"]
    names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(names) == len(set(names))
    for c in man["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    assert any(m["name"] == "setup_s" for m in man["end_to_end"])
    for w in man["workloads"]:
        assert (ROOT / "portbench" / "limits" / f"{w['name']}.json").is_file()
