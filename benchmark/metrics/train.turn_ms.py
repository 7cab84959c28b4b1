"""train.turn_ms: the median over the traced window's epochs of the host's
turn in train/steps.py's train_epoch: span train.epoch less its
train.replay child (the order lookup, the hyper rows, the graph's buffer
writes and key)."""
from benchmark.metrics import _spans


def read(run):
    if run["kind"] != "train":
        return None
    records = _spans.window(run)
    if records is None:
        return None
    return _spans.median_ms([_spans.self_ns(r, records, {"train.replay"})
                             for r in _spans.named(records, "train.epoch")])
