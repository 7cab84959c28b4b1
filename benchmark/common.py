"""What the cell drivers share: the run's context, its outcome, the
harness's host-side ranges and the comparisons of the correctness check."""
from __future__ import annotations

import contextlib
import os
import statistics
import time
from dataclasses import dataclass, field

import torch


def process_start_time():
    """The wall-clock time this process started (Linux /proc; the import of
    this module where /proc cannot tell)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _IMPORTED


_IMPORTED = time.time()


@dataclass
class Ctx:
    cfg: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    started: float = field(default_factory=process_start_time)
    phases: list = field(default_factory=list)  # (set-up phase, seconds it took)

    def phase(self, name):
        """Close a set-up phase: the seconds since the last one (or since the
        process started) go to `phases` under `name`."""
        now = time.time()
        last = self.started + sum(s for _, s in self.phases)
        self.phases.append((name, now - last))

    def span(self, name):
        """A record_function range named bench.<name> in a traced run, else
        nothing (the untraced window carries no profiler hooks)."""
        if not self.trace:
            return contextlib.nullcontext()
        return torch.profiler.record_function("bench." + name)

    def window(self):
        """The window's context: a profiled ``metrics._trace.Window`` (its
        value) in a traced run, else nothing (value None)."""
        if not self.trace:
            return contextlib.nullcontext()
        from .metrics._trace import Window

        return Window(self.device.type == "cuda")

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup_done(self):
        """Seconds from the process's start to now: set-up."""
        return time.time() - self.started


@dataclass
class Outcome:
    e2e: dict                  # end-to-end metric -> value
    attempted: int
    failed: int
    checks: dict               # compared number -> (value, limit)
    record: dict               # what the per-layer readers read
    memory_peak_bytes: int
    busy_s: float = None       # traced runs
    window_s: float = None
    breakdown: dict = None
    phases: list = ()          # set-up phases and their seconds
    check_s: float = None      # seconds the check took, after the window

    @property
    def correct(self):
        return self.failed == 0 and all(v <= lim for v, lim in self.checks.values())


def device_kind(device):
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def read_trace(tracer, record, out):
    """Fill the run's record (device ops, the traced window) and its
    outcome (busy and window seconds, the breakdown) from a traced window."""
    from .metrics import _trace

    dev, host = tracer.events()
    t0, t1 = tracer.start_ns, tracer.end_ns
    out.busy_s = _trace.busy_seconds(dev, t0, t1)
    out.window_s = (t1 - t0) / 1e9
    out.breakdown = _trace.breakdown(dev, host, t0, t1)
    record.update(dev=dev, t0=t0, t1=t1, traced_s=out.window_s, busy_s=out.busy_s)


def peak_bytes(device):
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def leaf_norms(sd):
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in sd.items()}


def worst_leaf_gap(prog, ref, keep=None):
    """max over leaves of |norm(prog) - norm(ref)| / max(norm(ref), the
    median leaf's reference norm): the gap between the two norms of a leaf,
    scaled so that a leaf that is all but zero reads against the median
    leaf. keep: the leaves compared (all by default)."""
    keys = [k for k in ref if keep is None or k in keep]
    pn, rn = leaf_norms({k: prog[k] for k in keys}), leaf_norms({k: ref[k] for k in keys})
    med = statistics.median(rn.values())
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys)


def moved_leaves(grad1_ref, rel=1e-3):
    """The leaves whose reference first gradient is at least `rel` of the
    median leaf's: the others move under Adam by round-off alone."""
    n = leaf_norms(grad1_ref)
    med = statistics.median(n.values())
    return {k for k, v in n.items() if v >= rel * med}


def train_numbers(prog, ref, check_steps, b1=0.9):
    """The train check's numbers from the program's readings and the
    reference's (reference.train_steps over the check steps, then the check
    epoch). prog: {"losses": the check steps' losses, "mu1": Adam's first
    moment after step 1, "params0", "params_check": the parameters after
    the check steps, "epoch_loss": the check epoch's mean loss,
    "params_end", "mu_end": the parameters and first moment after it}.

    The check steps: the widest relative gap of a step's loss, the worst
    leaf's gap of the first gradient's norm (the program's worked out from
    Adam's first moment: mu / (1 - b1)), the share of its elements whose
    sign differs, the worst moved leaf's gap of the norm of the change over
    the steps. The check epoch: the relative gap of its mean loss, the
    worst moved leaf's gap of the norm of the change from the start, and
    the share of the first moment's elements whose sign differs after it
    (the moment follows the epoch's last blocks, so it reads the order)."""
    import numpy as np

    n = check_steps
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"][:n]))
    g1 = {k: v / float(1.0 - np.float32(b1)) for k, v in prog["mu1"].items()}
    keep = moved_leaves(ref["grad1"])
    p0 = prog["params0"]

    def change(params):
        return {k: params[k].double() - p0[k].double() for k in keep}

    ref_epoch = statistics.fmean(ref["losses"][n:])
    return {"loss_gap": loss_gap,
            "grad1_gap": worst_leaf_gap(g1, ref["grad1"]),
            "grad1_sign_share": sign_share(g1, ref["grad1"]),
            "change3_gap": worst_leaf_gap(change(prog["params_check"]),
                                          change(ref["params"][n]), keep),
            "epoch_loss_gap": abs(prog["epoch_loss"] - ref_epoch) / abs(ref_epoch),
            "epoch_change_gap": worst_leaf_gap(change(prog["params_end"]),
                                               change(ref["params_end"]), keep),
            "epoch_mu_sign_share": sign_share(prog["mu_end"], ref["mu_end"])}


def sign_share(prog, ref, rel=0.1):
    """The share of the elements of `prog` whose sign differs from the
    reference's, among the elements the reference gives at least `rel` of
    their leaf's root mean square, where the reference is not round-off.
    Of the first gradient: the parameters Adam's first step moves the other
    way (its first update is lr times the gradient's sign)."""
    flips = counted = 0
    for k, r in ref.items():
        big = r.abs() >= rel * r.double().pow(2).mean().sqrt().float()
        flips += int(((prog[k] > 0) != (r > 0))[big].sum())
        counted += int(big.sum())
    return flips / counted
