"""neutex.train_mfu: the model FLOPs of the rays the traced window's NeuTex
train steps trained (benchmark/work_neutex.py, per ray, times the rows of
nonzero weight of every span train.autograd) over the window's seconds
times the card's float32 peak (the step runs in float32, TF32 off)."""
from benchmark import work_neutex
from benchmark.metrics import _spans


def read(run):
    if run["kind"] != "train" or run["cfg"]["model"].get("type") != "neutex":
        return None
    peak = work_neutex.f32_peak(run["device_kind"])
    records = _spans.window(run)
    if peak is None or records is None:
        return None
    rows = sum(r["attrs"]["rows"] for r in _spans.named(records, "train.autograd"))
    if not rows:
        return None
    return 100.0 * work_neutex.train_flops_per_ray(run["cfg"]) * rows / (run["window_s"] * peak)
