"""gathered.train_mfu: train_mfu (train_mfu.py) in a cell whose epochs
gather their batches: the model FLOPs of every train step in the traced
window over the window's seconds times the card's bf16 peak."""
from benchmark.registry import Registry

read = Registry().reader("train_mfu")
