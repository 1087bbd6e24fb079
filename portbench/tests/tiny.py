"""A copy of the benchmark with small cells for the CPU tests.

``make_copy(dst)`` copies ``BENCHMARK.json`` and ``portbench/`` to ``dst``
and adds two cells of the real traffic mixes at a size a CPU test run
holds: ``tiny-sphere-lm-dense`` (60 poses) and ``tiny-ba-sqrt`` (40
cameras, 300 landmarks, 1,300 projections), each with the limits of the real cell it stands
for.
"""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY = {
    "tiny-sphere-lm-dense": ("sphere2500", "lm-dense", "sphere2500-lm-dense",
                             {"n_poses": 60, "n_loops": 40}),
    "tiny-ba-sqrt": ("bal-ladybug-318", "sqrt", "bal-ladybug-318-sqrt",
                     {"n_poses": 40, "n_points": 300,
                      "n_observations": 1300}),
}


def make_copy(dst):
    dst = Path(dst)
    shutil.copytree(REPO / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    base = dst / "portbench"
    for cell, (cfg_name, traffic, real, sizes) in TINY.items():
        cfg = json.loads((base / "configs" / f"{cfg_name}.json").read_text())
        cfg.update(sizes, name=f"tiny-{cfg_name}")
        (base / "configs" / f"tiny-{cfg_name}.json").write_text(
            json.dumps(cfg))
        wl = json.loads((base / "workloads" / f"{real}.json").read_text())
        wl["config"] = cfg["name"]
        (base / "workloads" / f"{cell}.json").write_text(json.dumps(wl))
        spec["workloads"].append({"name": cell, "config": cfg["name"],
                                  "traffic": traffic, "chips": 1,
                                  "why": f"{real} at a CPU test's size"})
        if cfg["name"] not in {c["name"] for c in spec["configs"]}:
            spec["configs"].append({
                "name": cfg["name"], "source": cfg["source"],
                "file": f"portbench/configs/{cfg['name']}.json",
                "reduced": list(sizes), "why": "CPU tests"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(cell)
    (dst / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dst


def args(workload, seed=5, seconds=0.5, trace=0):
    return argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                              trace=trace)
