"""One short run of a cell on the card (`cuda` marker; skips without
one), and the run's refusals without the program or without a card."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def run(cwd: Path, workload: str, seconds: str = "3", trace: str = "0"):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 99), "--seconds", seconds, "--trace", trace],
        capture_output=True, text=True, cwd=cwd, timeout=600)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", ["0", "1"])
def test_serve_cell_on_the_card(card, trace):
    r = run(ROOT, "flagship-serve-b1", trace=trace)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(out)[-1] == "compared"
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert out["device"]["memory_peak_bytes"] > 0
    if trace == "1":
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert "breakdown" in out


def test_without_the_program_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and portbench/, a run fails
    and prints no result (without a card it fails before looking)."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    r = run(tmp_path, "flagship-serve-b1", seconds="1")
    assert r.returncode != 0
    assert r.stdout.strip() == ""
