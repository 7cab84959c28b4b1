"""The bitonic argsort kernel's launch plan (ops/sort.py:sort_plan and
run_steps), checked on the CPU.

The plan is what the CUDA entry point launches, so its shape is checked for
every size (CTAs, shared memory, launches). A numpy executor then runs the
plan the way the kernel moves its words, tier by tier: round trips that
load the 16 words whose positions differ in a 4-bit window (shared memory,
the run's buffer between grid barriers, a global pass, or the thread's own
registers), and warp shuffles between lanes, each substage with the
direction bit of its stage. Its order must equal torch.sort(stable=True)
and the JAX package's Pallas kernel (_bitonic_argsort_vmem in interpret
mode) to the bit.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intrinsic_neural_fields_tpu.ops.raster import _bitonic_argsort_vmem

from intrinsic_neural_fields_tpu_torch.ops.sort import (
    GLOBAL,
    GROUP,
    PER_THREAD_LOG,
    RUN,
    RUN_LOG_MAX,
    SHARED_LO,
    SHUFFLE_LO,
    SMEM_BYTES,
    TILE_LOG,
    run_steps,
    sort_plan,
)

# chip_smoke.py's random sizes up to one past 2^18 (2^20 is left to the card)
SORT_SIZES = (1, 255, 1000, 5000, 1 << 18, (1 << 18) + 1)
U32 = np.uint64(0xFFFFFFFF)


def _launches_formula(n, run_log):
    return 1 + sum(math.ceil((s - run_log) / GROUP) + 1 for s in range(run_log + 1, n + 1))


# An H100 holds 132 SMs x 16 CTAs of the run kernel (128 threads, 16 KB)
H100_CTAS = 132 * 16


@pytest.mark.parametrize("max_ctas", [H100_CTAS, 64])
def test_plan_shape_for_every_size(max_ctas):
    """One launch up to 2^18 keys (on a card holding fewer CTAs than a
    2^18 run needs, the plan falls back to tiles); launches by the formula;
    a cooperative launch never asks for more CTAs than the card holds."""
    assert SMEM_BYTES <= 227 * 1024
    for m in range(1, 31):
        plan = sort_plan(1 << m, max_ctas)
        assert plan.n == max(m, PER_THREAD_LOG)
        assert plan.threads <= 1024 and plan.threads << PER_THREAD_LOG == 1 << min(plan.n,
                                                                                   TILE_LOG)
        assert plan.ctas * plan.threads << PER_THREAD_LOG == 1 << plan.n
        assert not plan.cooperative or plan.ctas <= max_ctas
        assert len(plan.launches) == _launches_formula(plan.n, plan.run_log)
        if (1 << max(m - TILE_LOG, 0)) <= max_ctas and m <= RUN_LOG_MAX:
            assert plan.launches == ((RUN, 1, plan.n, 0, 0),)
        # one past a power of two pads to the next network
        assert sort_plan((1 << m) + 1, max_ctas).n == max(m + 1, PER_THREAD_LOG)
    # above 2^18: one-CTA runs of 2^11 words and global passes
    assert sort_plan((1 << 18) + 1, H100_CTAS).run_log == TILE_LOG
    assert len(sort_plan((1 << 18) + 1, H100_CTAS).launches) == 21
    assert len(sort_plan(1 << 20, H100_CTAS).launches) == 25
    assert sort_plan(1 << 18, H100_CTAS).ctas == 128


def test_plan_covers_the_network_in_order():
    """Every launch's substages, flattened, are the network's: stages 1..n,
    substages stage-1..0, each once, in that order; each tier's substages lie
    in its range and inside its window."""
    for E in (1, 20, 5000, 1 << 14, (1 << 14) + 1, 1 << 18, (1 << 18) + 1, 1 << 21):
        plan = sort_plan(E, H100_CTAS)
        seen = []
        for kind, stage, a, b, w in plan.launches:
            if kind == GLOBAL:
                assert a >= plan.run_log and w <= b and a < w + 4 and w + 4 <= plan.n
                seen += [(stage, j) for j in range(a, b - 1, -1)]
                continue
            for tier, s, js, w in run_steps(plan, stage, a):
                lo, hi = {"grid": (TILE_LOG, plan.run_log), "shared": (SHARED_LO, TILE_LOG),
                          "shuffle": (SHUFFLE_LO, SHARED_LO), "thread": (0, SHUFFLE_LO)}[tier]
                assert all(lo <= j < hi for j in js), (tier, js)
                if w is not None:
                    assert len(js) <= GROUP and all(w <= j < w + 4 for j in js)
                seen += [(s, j) for j in js]
        assert seen == [(s, j) for s in range(1, plan.n + 1) for j in range(s - 1, -1, -1)]


# ------------------------------------------------------------ the executor

def _deposit(g, w):
    low = g & ((np.uint64(1) << np.uint64(w)) - np.uint64(1))
    return low | ((g >> np.uint64(w)) << np.uint64(w + PER_THREAD_LOG))


def _round_trip(v, plan, stage, js, w, container_log):
    """Each thread loads the 16 words at deposit(g, w) | a << w (all in one
    container of 2^container_log words: a CTA, a run, the array),
    runs substages js on them, stores them back."""
    g = np.arange(1 << (plan.n - PER_THREAD_LOG), dtype=np.uint64)
    a = np.arange(16, dtype=np.uint64)
    pos = _deposit(g, w)[:, None] | (a << np.uint64(w))[None, :]
    assert np.array_equal(np.sort(pos, axis=None), np.arange(1 << plan.n, dtype=np.uint64))
    box = pos >> np.uint64(container_log)
    assert (box == box[:, :1]).all(), "a round trip left its container"
    vals = v[pos]
    for j in js:
        bit = 1 << (j - w)
        lo_a = [i for i in range(16) if not i & bit]
        hi_a = [i | bit for i in lo_a]
        lo, hi = vals[:, lo_a], vals[:, hi_a]
        asc = ((pos[:, lo_a] >> np.uint64(stage)) & np.uint64(1)) == 0
        swap = (lo > hi) == asc
        vals[:, lo_a], vals[:, hi_a] = np.where(swap, hi, lo), np.where(swap, lo, hi)
    v[pos] = vals
    return v


def _shuffle(v, plan, stage, js):
    """Thread g holds words 16g..16g+15; its partner for stride 2^j is the
    lane g ^ 2^(j-4), inside its warp and its CTA."""
    T = 1 << (plan.n - PER_THREAD_LOG)
    vals = v.reshape(T, 16)
    g = np.arange(T)
    pos = (g[:, None] * 16 + np.arange(16)[None, :]).astype(np.uint64)
    for j in js:
        lb = j - SHUFFLE_LO
        assert lb < 5 and (1 << lb) < plan.threads
        other = vals[g ^ (1 << lb)]
        is_lo = ((g >> lb) & 1 == 0)[:, None]
        asc = ((pos >> np.uint64(stage)) & np.uint64(1)) == 0
        vals = np.where(asc == is_lo, np.minimum(vals, other), np.maximum(vals, other))
    return vals.reshape(-1)


def execute(plan, keys):
    """The plan on numpy words (key << 32 | position; pads key 2^31-1):
    the order's low 32 bits at the first E positions."""
    n = plan.n
    v = np.full(1 << n, 0x7FFFFFFF, dtype=np.uint64)
    v[:plan.E] = keys.astype(np.uint64)
    v = (v << np.uint64(32)) | np.arange(1 << n, dtype=np.uint64)
    local = min(plan.run_log, TILE_LOG)
    for kind, stage, a, b, w in plan.launches:
        if kind == GLOBAL:
            v = _round_trip(v, plan, stage, range(a, b - 1, -1), w, n)
            continue
        for tier, s, js, w in run_steps(plan, stage, a):
            if tier == "shuffle":
                v = _shuffle(v, plan, s, js)
            else:
                box = {"grid": plan.run_log, "shared": local, "thread": PER_THREAD_LOG}[tier]
                v = _round_trip(v, plan, s, js, w, box)
    return (v[:plan.E] & U32).astype(np.int32)


@pytest.mark.parametrize("E", SORT_SIZES)
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "sparse"])
def test_executor_equals_torch_sort_and_jax_kernel(E, dense):
    """Dense: about 8 keys per value, as chip_smoke.py's random keys."""
    hi = max(2, E // 8) if dense else 1 << 30
    keys = np.random.default_rng(E).integers(0, hi, E).astype(np.int32)
    got = execute(sort_plan(E, H100_CTAS), keys)
    want = torch.sort(torch.from_numpy(keys), stable=True).indices.numpy()
    np.testing.assert_array_equal(got, want)
    jax_order = np.asarray(_bitonic_argsort_vmem(jnp.asarray(keys), 31, interpret=True))
    np.testing.assert_array_equal(got, jax_order)


@pytest.mark.parametrize("E", [5000, (1 << 15) + 3, (1 << 18) + 1])
def test_executor_fallback_plan_equals_torch_sort(E):
    """The plan of a card that cannot hold a 2^18 run's CTAs at once
    (2^11-word tiles, global passes above)."""
    keys = np.random.default_rng(1).integers(0, 50, E).astype(np.int32)
    got = execute(sort_plan(E, 8), keys)
    np.testing.assert_array_equal(got, torch.sort(torch.from_numpy(keys),
                                                  stable=True).indices.numpy())


@pytest.mark.parametrize("run_log", [12, 14, 16, 18])
def test_executor_cooperative_run_plans_equal_torch_sort(run_log):
    """The other plans the entry point takes above 2^18 (cooperative runs
    of 2^run_log words, grid round trips inside them, global passes
    above), which tools/ab_port_kernels.py times against the shipped one."""
    E = (1 << 19) + 7
    plan = sort_plan(E, H100_CTAS, run_log)
    assert plan.cooperative and plan.run_log == run_log
    assert len(plan.launches) == _launches_formula(plan.n, run_log)
    keys = np.random.default_rng(run_log).integers(0, E // 8, E).astype(np.int32)
    np.testing.assert_array_equal(execute(plan, keys), torch.sort(
        torch.from_numpy(keys), stable=True).indices.numpy())


def test_plan_rejects_runs_it_cannot_launch():
    with pytest.raises(ValueError, match="runs of"):
        sort_plan(1 << 20, H100_CTAS, RUN_LOG_MAX + 1)
    with pytest.raises(ValueError, match="runs of"):
        sort_plan(1 << 22, 1024, 14)  # 2048 CTAs in one cooperative launch
    with pytest.raises(ValueError, match="runs of"):
        sort_plan(1 << 12, H100_CTAS, 13)  # a run past the network


def test_executor_on_duplicate_heavy_keys():
    """All keys equal, two values, and the largest key: the order is the
    positions' order within each key."""
    for keys in (np.zeros(20000, np.int32), np.tile(np.array([3, 1], np.int32), 9000),
                 np.full(7000, 2 ** 31 - 2, np.int32)):
        got = execute(sort_plan(keys.size, H100_CTAS), keys)
        np.testing.assert_array_equal(got, np.argsort(keys, kind="stable"))
