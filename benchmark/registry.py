"""Finds what a cell names, by name, from BENCHMARK.json: its workload
entry, its configuration file, its traffic mix
(``benchmark/traffic/<traffic>.json``), the limits of its correctness check
(``benchmark/limits/<workload>.json``) and the reader of each per-layer
metric (``benchmark/metrics/<metric>.py``, a module with ``read(run)``).
A cell, a configuration, a mix or a metric is added by adding files and
entries; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Registry:
    def __init__(self, root=ROOT):
        self.root = root
        self.dir = os.path.join(root, "benchmark")
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)

    def _load_json(self, *parts):
        with open(os.path.join(*parts)) as f:
            return json.load(f)

    def workload(self, name):
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        for c in self.spec["configs"]:
            if c["name"] == name:
                return self._load_json(self.root, c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name):
        return self._load_json(self.dir, "traffic", f"{name}.json")

    def limits(self, workload):
        return self._load_json(self.dir, "limits", f"{workload}.json")

    def end_to_end(self, workload):
        """The end-to-end metrics this cell reports."""
        return [m for m in self.spec["end_to_end"]
                if "workloads" not in m or workload in m["workloads"]]

    def per_layer(self, workload):
        """The per-layer metrics this cell reports, each with its reader."""
        out = []
        for m in self.spec["per_layer"]:
            if "workloads" in m and workload not in m["workloads"]:
                continue
            out.append((m, self.reader(m["name"])))
        return out

    def reader(self, metric):
        path = os.path.join(self.dir, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
