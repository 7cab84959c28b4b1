"""train.graph_launch_ms: the median over the traced window's epochs of the
host's time in train/steps.py's EpochGraph replay call (span train.replay:
the graph launch)."""
from benchmark.metrics import _spans


def read(run):
    if run["kind"] != "train":
        return None
    records = _spans.window(run)
    if records is None:
        return None
    return _spans.median_ms([r["end_ns"] - r["start_ns"]
                             for r in _spans.named(records, "train.replay")])
