"""What every cell shares: the manifest (`BENCHMARK.json`) and the files
it names, found by name; the card's description; the checks on what a
run imported; the result line.

A cell (`workloads` entry) names a configuration and a traffic mix:
  * `configs/<file>` (the configuration's `file`): the port's config
    function, its overrides, the source and what was cut or assumed;
  * `traffic/<traffic>.json`: the mix's parameters, and under `driver`
    the module of `drivers/` that drives it;
  * `limits/<workload>.json`: the limits of the numbers that decide the
    cell's `correct`, each with the readings it was set from;
  * `metrics/<metric>.py`: one reader per per-layer metric, a function
    `read(record) -> float or None` of the run's record.
Adding a cell, a configuration, a mix or a metric adds files and
manifest entries and edits none.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "ocrfdet_tpu")
PROGRAM = "ocrfdet_tpu_torch"


def load_manifest(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict            # the configuration file, with its manifest entry
    traffic: Dict           # the traffic file
    limits: Dict            # the limits file
    end_to_end: list        # the manifest's metrics that this cell reports
    per_layer: list


def reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of the manifest, with every file it names."""
    man = load_manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    config = dict(json.loads((root / conf["file"]).read_text()), entry=conf)
    here = root / "portbench"
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((here / "limits" / f"{name}.json").read_text())
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits,
                end_to_end=[m for m in man["end_to_end"] if reports(m, name)],
                per_layer=[m for m in man["per_layer"] if reports(m, name)])


def driver(cell: Cell):
    """The module of `drivers/` that the cell's traffic names."""
    return importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")


def reader(metric: str, root: Path = ROOT) -> Callable:
    """`metrics/<metric>.py`'s `read`."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _replaced(obj, overrides: Dict):
    """`obj` (a config dataclass) with `overrides`: a dict overrides the
    fields of a nested config, a JSON list is a tuple."""
    def value(cur, v):
        if isinstance(v, dict) and dataclasses.is_dataclass(cur):
            return _replaced(cur, v)
        if isinstance(v, list):
            return tuple(value(None, x) for x in v)
        return v
    return dataclasses.replace(obj, **{k: value(getattr(obj, k), v)
                                       for k, v in overrides.items()})


def program_config(config: Dict, **extra):
    """The port's config object of a configuration file: its function,
    then its overrides."""
    from ocrfdet_tpu_torch import config as C
    return _replaced(getattr(C, config["function"])(**extra),
                     config.get("overrides", {}))


def reference_config(config: Dict, **extra):
    """The frozen reference's config object of a configuration file."""
    from .ref import config as C
    return _replaced(getattr(C, config["function"])(**extra),
                     config.get("overrides", {}))


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (`ocrfdet_tpu_torch` is not
    `ocrfdet_tpu`)."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def card(count: int) -> Dict:
    """The card's name, the count of cards a run uses and their power
    limit (nvidia-smi)."""
    import torch
    limit = None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
        limit = out[0].split(",")[-1].strip() if out else None
    except (OSError, subprocess.SubprocessError):
        pass
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=count, power_limit=limit)


def cache_dirs(root: Path = ROOT) -> None:
    """Fixed compile caches inside the checkout, and no JAX under
    libraries that would load it."""
    build = root / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict, device: Dict, compared: Dict,
                breakdown: Optional[Dict] = None) -> str:
    """The last line of standard output; `compared` comes last: each
    number that decided `correct` beside its limit."""
    out = dict(correct=bool(correct), attempted=int(attempted),
               failed=int(failed), metrics=metrics, device=device)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = compared
    return json.dumps(out)


def sync(dev) -> None:
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev) -> None:
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_bytes(dev) -> int:
    """The device's peak allocation since `reset_peak` (0 off the card)."""
    import torch
    if torch.device(dev).type == "cuda":
        return torch.cuda.max_memory_allocated(dev)
    return 0


def free(dev) -> None:
    import gc
    import torch
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
