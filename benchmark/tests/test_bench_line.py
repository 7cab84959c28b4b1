"""The result line's shape, and a run without a card."""
import json

import pytest
import torch

from benchmark.run import main, result_line, run_cell

SEED = 2**31 + 11


@pytest.mark.parametrize("workload", ["intrinsic_cat.train_blocks",
                                      "viewdep_intrinsic_blob.train_blocks",
                                      "intrinsic_cat.render_orbit"])
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_shape(small_bench, workload, trace):
    _, reg = small_bench
    out, metrics = run_cell(reg, workload, SEED, 0.3, trace, torch.device("cpu"))
    line = json.loads(json.dumps(result_line(out, metrics, {"platform": "gpu"})))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert ("breakdown" in line) == bool(trace)
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    names = {m["name"] for m in (reg.per_layer(workload) and [m for m, _ in reg.per_layer(workload)]
                                 if trace else reg.end_to_end(workload))}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
        assert all(v["value"] > 0 for v in line["metrics"].values())
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"}


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = main(["--workload", "intrinsic_cat.train_blocks", "--seed", "1", "--seconds", "1",
               "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "CUDA" in err
