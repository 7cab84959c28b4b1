"""Stable ascending argsorts of int32 binning keys: the raster tracer's
``sort_method`` values and the CUDA bitonic kernel with its plain twin.

Every function returns the permutation ``torch.sort(keys, stable=True)``
returns, as int32 [E]:

  - ``stable_radix_argsort``: an LSD counting radix sort over 8-bit digits
    (per-block one-hot counts, f32 bucket bases, a strictly lower
    triangular matmul for the rank among equal digits, one scatter per
    pass);
  - ``bitonic_argsort``: the plain twin, a bitonic compare-exchange network
    over flat [2^m] (key, index) planes written with ``torch.roll``;
  - ``bitonic_argsort_vmem``: the same network as hand-written CUDA
    kernels (``csrc/bitonic_argsort.cu``) on a CUDA tensor, launched by the
    plan of ``sort_plan``: one cooperative launch up to 2^18 keys, 2^11-word
    tiles and global passes above; the twin on a CPU tensor.

A bitonic network is not stable, but it compares (key, index) pairs
lexicographically, and every pair is unique, so it returns exactly the
stable order by key. Pads carry the key 2^31-1 and their own position,
which is past every real index, so they sort after every real entry.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .launches import _launches, register

RADIX_BLOCK = 256     # rows per rank block (ranks <= 255: exact in f32)
RADIX_DIGITS = 256    # 8-bit digits
PAD_KEY = 2 ** 31 - 1
MAX_LOG = 30          # the kernel takes up to 2^30 keys
# The kernel's shape (csrc/bitonic_argsort.cu): each (key, index) pair is one
# 64-bit word; a CTA holds 2^TILE_LOG words, 2^PER_THREAD_LOG per thread; a
# network of up to 2^RUN_LOG_MAX words is one cooperative launch (a grid
# barrier between round trips through an L2-resident buffer).
TILE_LOG = 11
PER_THREAD_LOG = 4
SHUFFLE_LO = PER_THREAD_LOG      # first stride (log2) between threads: warp shuffles
SHARED_LO = SHUFFLE_LO + 5       # first stride (log2) between warps: shared memory
GROUP = PER_THREAD_LOG           # substages per shared, grid or global round trip
RUN_LOG_MAX = 18
SMEM_BYTES = 8 << TILE_LOG       # a CTA's shared words (16 KB, far below the 227 KB limit)
RUN, GLOBAL = 0, 1               # launch kinds of a plan row

register("bitonic_argsort")


class SortPlan(NamedTuple):
    """The kernel's launches for E keys: the network has 2^n words (n >= 4);
    a run launch sorts runs of 2^run_log words with ``ctas`` CTAs of
    ``threads`` threads (one cooperative launch when a run spans several
    CTAs: ``cooperative``). ``launches`` rows, in order, are (RUN,
    stage_lo, stage_hi, 0, 0): a run launch running those stages (of a stage
    above the run only the substages below the run's size), or (GLOBAL,
    stage, j_hi, j_lo, w): one pass over the whole array running substages
    j_hi..j_lo of the stage, each thread on the 16 words whose positions
    differ in bits [w, w+4)."""
    E: int
    n: int
    run_log: int
    ctas: int
    threads: int
    cooperative: bool
    launches: tuple


def _window(j_lo, limit):
    """Lowest bit of a round trip's 4-bit window: it holds j_lo and stays
    below `limit` (the tier's size in bits)."""
    return min(j_lo, limit - PER_THREAD_LOG)


def _groups(j_hi, j_lo):
    """Substages j_hi..j_lo (high to low) in round trips of up to GROUP."""
    return [tuple(range(hi, max(hi - GROUP + 1, j_lo) - 1, -1))
            for hi in range(j_hi, j_lo - 1, -GROUP)]


def sort_plan(E, max_ctas=None, run_log=None):
    """The launch plan of ``bitonic_argsort_vmem`` for E keys on a card that
    holds `max_ctas` CTAs of the run kernel at once (None: enough). A
    network of up to 2^18 words is one cooperative launch, as long as all
    its CTAs fit on the card at once. Above, the first launch sorts 2^11-word
    runs (one CTA each) of alternating direction and each larger stage
    takes a global pass per group of up to 4 substages whose stride reaches
    past the run, then one run launch for the rest: on an H100 that beat
    cooperative runs of 2^12..2^18 words at every size tried
    (tools/ab_port_kernels.py). run_log: plan runs of 2^run_log words
    instead (TILE_LOG..RUN_LOG_MAX; to time other plans)."""
    n = max(_log2_size(E), PER_THREAD_LOG)
    local = min(n, TILE_LOG)
    ctas = 1 << (n - local)
    fits = max_ctas is None or ctas <= max_ctas
    if run_log is None:
        run_log = n if n <= RUN_LOG_MAX and fits else local
    elif not (local <= run_log <= min(n, RUN_LOG_MAX) and (fits or run_log == local)):
        raise ValueError(f"sort_plan: runs of 2^{run_log} words for 2^{n} keys")
    rows = [(RUN, 1, run_log, 0, 0)]
    for stage in range(run_log + 1, n + 1):
        for grp in _groups(stage - 1, run_log):
            rows.append((GLOBAL, stage, grp[0], grp[-1], _window(grp[-1], n)))
        rows.append((RUN, stage, stage, 0, 0))
    return SortPlan(E, n, run_log, ctas, 1 << (local - PER_THREAD_LOG), run_log > TILE_LOG,
                    tuple(rows))


def run_steps(plan, stage_lo, stage_hi):
    """The steps of one run launch, in the kernel's order: (tier, stage,
    substages high to low, window). Tiers: "grid" (a round trip through the
    run's buffer between grid barriers, window in run bits), "shared" (a
    round trip through the CTA's shared memory), "shuffle" (partners in
    other lanes of the warp; window None), "thread" (inside the thread's 16
    consecutive words, window 0)."""
    local = min(plan.run_log, TILE_LOG)
    steps = []
    for stage in range(stage_lo, stage_hi + 1):
        top = min(stage, plan.run_log) - 1
        for grp in _groups(top, TILE_LOG):
            steps.append(("grid", stage, grp, _window(grp[-1], plan.run_log)))
        for grp in _groups(min(top, TILE_LOG - 1), SHARED_LO):
            steps.append(("shared", stage, grp, _window(grp[-1], local)))
        shuffle = tuple(range(min(top, SHARED_LO - 1), SHUFFLE_LO - 1, -1))
        if shuffle:
            steps.append(("shuffle", stage, shuffle, None))
        steps.append(("thread", stage, tuple(range(min(top, SHUFFLE_LO - 1), -1, -1)), 0))
    return steps


def stable_radix_argsort(keys, total_bits):
    """Stable ascending argsort of non-negative int32 keys < 2^total_bits
    by 8-bit counting passes; high zero digits skip their passes."""
    dev = keys.device
    E = keys.shape[0]
    R, K = RADIX_BLOCK, RADIX_DIGITS
    Ep = -(-E // R) * R
    # Bucket bases ride f32 cumsums: exact only while counts fit the f32
    # integer range. Fail loudly rather than silently mis-sort beyond it.
    assert Ep < (1 << 24), f"radix argsort: {Ep} entries exceed exact-f32 counting range"
    # All-ones pads: the largest digit in every pass, kept in order by
    # stability, so they stay at the end throughout.
    k = torch.nn.functional.pad(keys.to(torch.int32), (0, Ep - E), value=PAD_KEY)
    idx = torch.arange(Ep, dtype=torch.int32, device=dev)
    nb = Ep // R
    digits = torch.arange(K, dtype=torch.int32, device=dev)
    lower_tri = torch.tril(torch.ones(R, R, device=dev), -1)
    for shift in range(0, total_bits, 8):
        db = ((k >> shift) & (K - 1)).reshape(nb, R)
        oh = (db[:, :, None] == digits).to(torch.float32)            # [nb,R,K]
        t = oh.sum(dim=1)                                            # [nb,K]
        hist = t.sum(dim=0)
        base = torch.cat([torch.zeros(1, device=dev), torch.cumsum(hist, 0)[:-1]])
        block_base = base[None] + torch.cat(
            [torch.zeros(1, K, device=dev), torch.cumsum(t, 0)[:-1]], 0)
        rank = (torch.matmul(lower_tri, oh) * oh).sum(dim=-1)        # [nb,R]
        pos = (torch.gather(block_base, 1, db.long()) + rank).reshape(-1).long()
        k = torch.zeros_like(k).index_put_((pos,), k)
        idx = torch.zeros_like(idx).index_put_((pos,), idx)
    return idx[:E]


def _log2_size(E):
    return max(1, (E - 1).bit_length())


def bitonic_argsort(keys, total_bits=31):
    """Plain twin of the kernel: the bitonic network over [2^m] int32
    planes, each substage two rolls and elementwise selects. total_bits is
    accepted for signature parity; the network size depends only on E."""
    del total_bits
    dev = keys.device
    E = keys.shape[0]
    if E == 0:
        return torch.empty(0, dtype=torch.int32, device=dev)
    m = _log2_size(E)
    Ep = 1 << m
    k = torch.nn.functional.pad(keys.to(torch.int32), (0, Ep - E), value=PAD_KEY)
    idx = torch.arange(Ep, dtype=torch.int32, device=dev)
    iota = idx.clone()
    for stage in range(1, m + 1):
        # ascending block iff bit `stage` of the element index is 0; the
        # final stage has no such bit, so everything ascends
        asc = (iota & (1 << stage)) == 0
        for j in range(stage - 1, -1, -1):
            s = 1 << j
            is_lo = (iota & s) == 0
            pk = torch.where(is_lo, torch.roll(k, -s), torch.roll(k, s))
            pi = torch.where(is_lo, torch.roll(idx, -s), torch.roll(idx, s))
            self_gt = (k > pk) | ((k == pk) & (idx > pi))
            keep_self = self_gt ^ (asc == is_lo)
            k = torch.where(keep_self, k, pk)
            idx = torch.where(keep_self, idx, pi)
    return idx[:E]


def _kernel_lib():
    from ._build import load

    lib = load("bitonic_argsort")
    if lib.bitonic_argsort.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.bitonic_argsort.argtypes = [P, ctypes.c_longlong, P, P, I, I, P, I, P, P]
        lib.bitonic_argsort.restype = I
        lib.bitonic_argsort_max_ctas.restype = I
        lib.bitonic_argsort_tile_log.restype = I
        lib.bitonic_argsort_per_thread_log.restype = I
        if (lib.bitonic_argsort_tile_log(), lib.bitonic_argsort_per_thread_log()) != (
                TILE_LOG, PER_THREAD_LOG):
            raise RuntimeError("csrc/bitonic_argsort.cu's shape disagrees with ops/sort.py")
    return lib


def device_max_ctas():
    """CTAs of the run kernel the card holds at once (a cooperative run
    needs all of its CTAs resident)."""
    if device_max_ctas.value is None:
        n = _kernel_lib().bitonic_argsort_max_ctas()
        if n <= 0:
            raise RuntimeError(f"bitonic_argsort: occupancy query failed ({n})")
        device_max_ctas.value = n
    return device_max_ctas.value


device_max_ctas.value = None


def bitonic_argsort_vmem(keys, total_bits=31):
    """Stable ascending argsort of int32 keys [E] -> int32 order [E].

    CPU tensor: the plain twin. CUDA tensor: ``csrc/bitonic_argsort.cu`` on
    the current stream by the launches of ``sort_plan`` (E <= 2^30; no size
    goes to another sort), or an error. Each call that launches adds one to
    the ``bitonic_argsort`` count of ``kernel_launches()``;
    ``bitonic_argsort_vmem.cuda_launches`` adds the CUDA launches the
    entry point reports."""
    if keys.device.type == "cpu":
        return bitonic_argsort(keys, total_bits)
    if keys.device.type != "cuda":
        raise ValueError(f"bitonic_argsort_vmem: unsupported device {keys.device}")
    if keys.dtype != torch.int32 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError("bitonic_argsort_vmem: keys must be a contiguous 1-D int32 tensor, "
                         f"got {tuple(keys.shape)} {keys.dtype}")
    E = keys.shape[0]
    if E == 0:
        return torch.empty(0, dtype=torch.int32, device=keys.device)
    if _log2_size(E) > MAX_LOG:
        raise ValueError(f"bitonic_argsort_vmem: {E} keys exceed the kernel's 2^{MAX_LOG}")
    lib = _kernel_lib()
    plan = sort_plan(E, device_max_ctas())
    rows = (ctypes.c_int * (5 * len(plan.launches)))(*(v for r in plan.launches for v in r))
    launched = ctypes.c_int(0)
    order = torch.empty(E, dtype=torch.int32, device=keys.device)
    buf = (torch.empty(1 << plan.n, dtype=torch.int64, device=keys.device)
           if plan.n > TILE_LOG else None)
    rc = lib.bitonic_argsort(keys.data_ptr(), E, order.data_ptr(),
                             None if buf is None else buf.data_ptr(), plan.n, plan.run_log, rows,
                             len(plan.launches), ctypes.byref(launched),
                             torch.cuda.current_stream(keys.device).cuda_stream)
    bitonic_argsort_vmem.cuda_launches += launched.value
    if rc != 0:
        raise RuntimeError(f"bitonic_argsort launch failed: cudaError {rc}")
    _launches["bitonic_argsort"] += 1
    return order


bitonic_argsort_vmem.cuda_launches = 0
