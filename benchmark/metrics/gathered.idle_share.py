"""gathered.idle_share: train.idle_share (train.idle_share.py) in a cell
whose epochs gather their batches: the share of the traced train window in
which no device operation runs."""
from benchmark.registry import Registry

read = Registry().reader("train.idle_share")
