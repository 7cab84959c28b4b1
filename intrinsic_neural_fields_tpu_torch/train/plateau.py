"""Host-side ReduceLROnPlateau (reference trainer.py:35-36 uses torch's with
mode="min", factor=0.2 and default patience 10). The learning rate lives in
the optax inject_hyperparams state, so updating it between epochs does not
recompile the jitted epoch."""
from __future__ import annotations


class ReduceLROnPlateau:
    def __init__(self, factor=0.2, patience=10, threshold=1e-4, min_lr=0.0):
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad_epochs = 0

    def step(self, metric, current_lr):
        """Returns the (possibly reduced) learning rate."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.num_bad_epochs = 0
            new_lr = max(current_lr * self.factor, self.min_lr)
            if new_lr < current_lr:
                print(f"ReduceLROnPlateau: reducing learning rate to {new_lr:.3e}")
            return new_lr
        return current_lr
