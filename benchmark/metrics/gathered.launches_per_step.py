"""gathered.launches_per_step: train.launches_per_step
(train.launches_per_step.py) in a cell whose epochs gather their batches:
the port's kernel launches in the traced window (ops/launches.py's
counters) per train step; the host issues each of them."""
from benchmark.registry import Registry

read = Registry().reader("train.launches_per_step")
