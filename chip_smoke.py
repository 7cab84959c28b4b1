#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:
  (a) device: card name and power limit; build every CUDA kernel from the
      sources in the checkout (nvcc, one process per source, in parallel,
      into the package's ignored _build/);
  (p) hq_prep, the HQ recipe's data through the port's own CLIs (main(argv)
      in process): make_synthetic_dataset (256^2, 20 train / 2 val / 2 test
      / 2 vis views of the blob at subdivision 5, f64 host BVH) and
      preprocess_eigenfunctions (k=512 cotan, scipy shift-invert: the run's
      one eigensolve, which every later leg reuses);
  (b) HQ eval leg, the render path: that blob mesh (20,480 faces) and its
      k=512 eigenfunctions, a seeded
      6x128 skip-3 TextureField, a 256^2 Renderer with a bf16 feature table,
      evaluate_views over 8 ring cameras with the launch counters set to 0
      just before and read just after; then the same views with the plain
      MLP twin: valid masks must be equal and kernel-vs-plain PSNR >= 50 dB,
      and the kernel must have launched;
  (c) throughput: the port bench's render leg (bench.render_leg, bench.py's
      render scale): 512^2, blob subdivision 6 (81,920 faces), a random
      k=1023 basis drawn as bench.py draws it (not rescaled), 10 pipelined
      frames, best of 3 passes, the forward kernel launched in every frame;
      a stage split of one frame;
  (d) kernels: each kernel against its plain torch twin on the features
      each leg feeds it (its hit rays' interpolated rows), at B=8192 (the
      renderer's chunk) and a ragged B=1000 (tolerance 2e-3), timed with
      CUDA events beside its bound; the forward's launch shape (2-CTA
      clusters of 128-row CTAs at k=512, 64-row at k=1023) held to its
      design;
  (s) sort_kernel: the bitonic argsort kernel against its plain twin and
      torch.sort(stable=True), equal to the bit, on the tracer's own keys
      (entry and overflow sorts of a 512^2 view over 81,920 faces and of a
      256^2 view of the HQ blob, captured from bin_faces) and on random
      keys with dense duplicates, its CUDA launches per call equal to its
      plan's (one up to 2^18 keys); times beside the bound and torch.sort;
  (t) trace_methods: intersect_coords_pinhole at 512^2 over 81,920 faces
      with sort_method argsort, radix, bitonic and bitonic_vmem: t,
      face_idx, bary and valid bit-identical; the kernel's counts set to 0
      just before each trace and read just after (> 0 only for
      bitonic_vmem; one raster_traverse and three raster_bin launches per
      trace); then the traversal kernel against its lockstep twin on four
      orbit views' tables (bits and chunk counts equal), its time beside
      its bound; then the binning kernels against their twin on the same
      views (every table field equal to the bit), their device time beside
      their bound, the sorts', the twin's and the host's enqueue time;
  (q) hq_pipeline: preprocess_dataset on the card (raster tracer) for the
      train and test splits in process and the val split as a
      `python -m` subprocess; the train split again with --intersector host
      (f64 BVH): the share of rays whose hit and face id agree is gated;
  (e) HQ train leg, the training path: the hq_pipeline's ray caches; the
      Trainer on the HQ recipe
      (configs/synthetic/intrinsic_blob_hq.yaml: k=512, 6x128 skip 3, L1,
      Adam lr 1e-4, batch 4096, bf16 table, shuffle blocks, fused_mlp) for
      5 epochs with an in-memory writer, counters set to 0 just before and
      read just after (fwd_bwd and wgrad with its Adam epilogue once per
      step, each epoch one replay of a captured CUDA graph, and the forward
      kernel of the eval after training must have launched; the eager step,
      the grads-only wgrad and the Adam kernel never); train loss falls,
      the tags are the JAX Trainer's, the params finite; then a run resumed
      from checkpoint.pt (its graph captured anew) must equal the
      uninterrupted run to the bit; the same 5 epochs with fused_adam:
      false (per step from the host: fwd_bwd, grads-only wgrad, the Adam
      kernel; counters set to 0 just before, read just after) must give
      the same params, moments, bf16 weight copy and epoch losses, to the
      bit; PSNR/DSSIM on the val views before and after; the port's eval
      CLI (main(argv)) scores the test split;
  (e2) jax_checkpoint: the JAX package's own files for the HQ recipe's
      model (tests/data/jax_checkpoint_hq, written by
      tools/make_jax_checkpoint_fixture.py: model.ckpt, checkpoint.ckpt,
      expected.npz) read by the port's flax-msgpack decoder: the forward
      kernel on the fixture's 8,192 seeded rows within TOL of the JAX
      forward and of the plain twin, one launch; the eval CLI on an
      out_dir holding only model.ckpt, its PNGs and scores equal to the
      bit to the eval of the port's model.pt of the same weights, 8
      forward launches per 256^2 view as in (b); the HQ Trainer on an
      out_dir holding only checkpoint.ckpt: it starts at epoch + 1 with
      the decoded params, moments, count and lr to the bit, trains 2
      epochs (one fwd_bwd and one wgrad_adam per step, one graph replay
      per epoch) and writes checkpoint.pt, from which a second Trainer
      resumes to the same state, to the bit; the decode and phase
      seconds on a line of their own;
  (f) train throughput: the port bench's train leg (bench.train_leg) on
      bench.make_arrays, bench.py's numpy arrays (bench.py:26-42: V=30k,
      k=1023, N=2^21 bf16 table, batch 4096, 6x128 skip 3, L1, Adam): 3
      timed groups of 16 epochs after 1 warm-up (which captures the
      epoch's graph); kernels per step, host dispatches per epoch, the
      capture's seconds; then the bench line: bench.py's JSON dict from
      the two legs' rates and bench_torch_cpu (the reference's hot loop on
      the host's CPU, on the same arrays);
  (g) train kernels: fwd_bwd, wgrad, wgrad with its Adam epilogue and the
      standalone Adam each against its plain twin on
      the batches each train leg feeds them (k=512 and k=1023, B=4096;
      wgrad_adam to the bit against the Adam twin on the grads-only wgrad's
      gradients, moments random over the whole flat buffer;
      fwd_bwd's launch shape: 2-CTA clusters, 128 CTAs; wgrad's: one
      cluster of 8 CTAs per 128-row gradient tile, and two wgrad launches
      equal to the bit; Adam with and
      without its bf16 weight copy), the autograd backward of fused_apply
      against torch.autograd of the plain forward, and its time; CUDA-event
      times beside bounds, plain and library times;
  (h) view-dependent train leg: the same ray caches (they
      carry the unit ray directions and original face ids), the Trainer on
      configs/synthetic/viewdep_intrinsic_blob.yaml's model and training
      sections (k=512, 6x128 skip 3, bottleneck 128, intrinsic view angle,
      embed 4, directional 128; L1, Adam lr 1e-4, batch 4096, shuffle
      blocks) with fused_mlp and a bf16 table, 5 epochs, counters set to 0
      just before and read just after: the tail kernels (fwd_bwd, wgrad
      with Adam) once per step in one graph replay per epoch, the plain
      train kernels, the Adam kernel and the eager step never; loss falls,
      tags, finite state, bit-exact resume; the fused_adam: false run equal
      to the bit, as in (e); evaluate_views of the val views through the
      view-dependent forward kernel before and after, each held to the
      plain twin's render (equal masks, PSNR >= 50 dB);
  (i) view-dependent kernels: each tail kernel against its plain twin on
      the batches the leg feeds it (B=4096 train blocks, B=8192 render
      chunks, a ragged B), one extrinsic batch (27 view lanes), Adam on
      the view-dependent buffer; the launch shapes and wgrad's bits across
      two launches as in (d) and (g); times beside bounds;
  then the user's path with the HQ leg's trained model.pt (k=512, 6x128
  skip 3) through the port's `-m` entry points (main(argv) in process), the
  forward kernel's launches counted per path (counters set to 0 just
  before each entry point, read just after):
  (l) meshroom: the HQ train/val/test views as Meshroom-layout splits with
      radial-k3 coefficients [0.05, -0.02, 0.01] (the pinhole images as
      GT) and the test views again with zeros; the distorted views through
      the kernel and the plain twin (equal masks, PSNR >= 50 dB), the zero
      split against the pinhole renders (equal masks, PSNR >= 50 dB);
      preprocess_dataset --dataset_type meshroom_radial_k3, 2 epochs of the
      Trainer with the Meshroom vis renders every epoch (the vis scalars
      written, loss falls), the eval CLI on the distorted test split;
  (m) lpips: a seeded random AlexNet npz; LPIPS of the HQ eval leg's
      (render, ground truth) pairs on the card and on the CPU within 1e-4
      relative; the eval CLI with --lpips_weights gives a finite column;
  (n) transfer: make_transfer_targets --targets coarse from the HQ basis
      (a 512-function target basis, cut from 1024); identity
      self-transfer against the source render (equal masks, PSNR >= 50
      dB); texture_transfer --eval_dataset onto the coarse target against
      the source test views, its renders through the kernel and the plain
      twin (equal masks, PSNR >= 50 dB);
  (o) bake: a per-face UV atlas of the HQ blob (20,480 faces),
      bake_texture_field at 1024^2 through the kernel and bake_texture
      through the plain twin, within 2/255 on every texel; the kernel
      launched once per 8,192 texels;
  (v) video: render_video --resolution 720p --fps 10 --duration 1 (10
      frames of 1280x720 written) and the render loop alone; render_view at
      640x360 of the HQ and the view-dependent leg's models, each within one
      8-bit step of a direct render of the same camera;
  (r) families: configs/synthetic/{xyz_blob,tf_rff_blob}.yaml through the
      Trainer on the HQ pipeline's caches (full width, 5 epochs, f32
      embedded tables at k_in 3 and 515, fused_mlp, blocks), counters set
      to 0 just before and read just after (one fwd_bwd and one wgrad_adam
      per step, one graph replay per epoch, no eager step): the card's
      embedded rows against the CPU's, loss falls, resume equal to the bit,
      the eval CLI's test PSNR, kernel vs plain renders (equal masks,
      >= 50 dB), rays/s beside the HQ leg's; hks_blob.yaml for 2 epochs
      through the eager step (the standalone Adam once per step); an FF
      field (10 log bands, 63 columns); a seeded view-dependent xyz field's
      renders through fused_mlp_fwd_viewdep at k_in 3 against the plain
      twin's; eval_on_mesh of the xyz field on
      the transfer phase's coarse target; then the forward kernel against
      its twin on each field's encoded hit rows and the train kernels on
      each recipe's trained weights and f32 table, with (g)'s gates;
  (y) neutex: pretrain_neutex_mapping (main(argv) in process) on the HQ
      blob for 300 iterations of 25,000 sphere points (one Adam launch per
      iteration; chamfer and cycle fall; its npz loads into the port's
      factory); configs/synthetic/neutex_blob.yaml with the repo's mapping
      through the Trainer at full width (k=170: a 1,023-wide encoding,
      793,482 parameters) for 2 epochs, counters set to 0 just before and
      read just after: one eager step and one fused_adam launch per step
      and no other kernel, loss falls; one eager step on the card against
      the CPU from the trained state (gates at NEUTEX_*_TOL); the standalone
      Adam at 793,482 parameters against its twin and torch's fused Adam;
      the eval CLI on the test split through the module forward (no kernel
      launch), a finite PSNR; in (j), a profile of 20 eager steps;
  (z) dp: data-parallel training over the device list ["cuda:0",
      "cuda:0"] (two replicas on the card): the HQ recipe through the
      Trainer swapped by parallelize_trainer, 2 epochs, counters set to 0
      just before and read just after (fwd_bwd, the grads-only wgrad and
      the standalone Adam once per replica per step, wgrad with Adam never,
      no epoch graph), loss falls, the replicas' params and moments equal
      to the bit; one DP step against the one-device fused_adam: false step
      on the same 4096 rows (gates DP_*); the train kernels against their
      twins at a replica's 2048 rows (as (g)), the all-reduce timed; the HQ
      recipe with batchnorm: true, fused_mlp: false through the one-device
      Trainer for 2 epochs (one eager step and one Adam launch per step,
      loss falls) and one sync-BN DP step against the one-device BatchNorm
      step taken along the DP forward's ReLU branches (the entries whose
      branch differs counted); the DP-trained field's test and val views rendered D-way
      (image, hit set and metrics equal to the one-device render, the
      forward kernel's launches counted); -m train and -m eval with
      --num_devices 2 raise the device-count error on a one-card machine;
      in (j), a profile of one DP epoch;
  (w) spectral: the native local-triangulation and iDT cores loaded from
      the port's build; CheFSI (method="chefsi", device="cuda", the
      all-f64 polish) at the HQ solve, k+1 = 513 on the blob's cotan
      operator, against hq_prep's shift-invert files (eigenvalues within
      1e-4 of the largest, M-orthonormal 1e-10, relative residual 1e-6,
      principal angles on the gap-separated leading span within 1 degree),
      its device loop and host polish timed apart, its peak device memory;
      its padded-ELL gather product against cuSPARSE's CSR product at the
      loop's [n, m]; dense inside its device window on a 5,000-point cloud
      of the blob through pc_vert_robust, k=65 (f32 eigh within 16 eps32
      ||C|| of shift_invert, its time and peak memory); LOBPCG at k=10 on
      icosphere(2), tests/test_spectral.py's gate;
  (x) cloud: make_transfer_targets --targets cloud (the blob's vertices as
      a faceless PLY, locally triangulated, pc_vert_robust, a 512-function
      basis), the triangulation and the iDT timed alone (faces, flips),
      texture_transfer onto cloud.ply with --laplacian_type pc_vert_robust
      (the forward's launches counted) and its renders through the kernel
      and the plain twin (equal masks, >= 50 dB), its eval PSNR beside the
      coarse target's; compute_shot on the blob and shot_blob.yaml for 2
      epochs through the eager step (one standalone Adam launch per step,
      loss falls), the eval CLI through the forward kernel; then the
      forward kernel against its twin on SHOT rows (k_in 352);
  (j) profile: torch.profiler over 4 pipelined render frames, one
      epoch of each train leg (HQ, train throughput, view-dependent, xyz,
      tf_rff), whose port kernels, counted by name in the trace, must be
      exactly one fwd_bwd and one wgrad with Adam per step (before it an
      unprofiled epoch, CUDA events around its graph replay, against its
      wall time), 20 eager steps each of NeuTex and the BatchNorm field
      (exactly one fused_adam each), and one data-parallel epoch (per
      replica per step one fwd_bwd, one grads-only wgrad and one
      fused_adam);
  (k) the kernels summary line, the nvidia-smi line, and the result line.
      The train kernels' bound_ms counts the activations and deltas their
      two-launch split writes; their fused_step_bound_ms is the bound of
      the whole step as the TPU kernel computes it, intermediates on chip.

Imports nothing of JAX, flax, optax or msgpack. Needs one CUDA card;
exits non-zero without one.
"""
import contextlib
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TOL = 2e-3            # kernel vs plain twin, max abs error
# [H100 at 700 W: 1.1e-3 (B=8192) / 1.4e-3 (B=1000) on the bench render
# leg's unrescaled N(0,1) k=1023 basis, 2.4e-4 on the rescaled basis it ran
# before; 1.45e-3 tf_rff k=515, 1.26e-3 xyz k=3, 4.1e-4 hq_eval k=512;
# 1.46e-3 on the JAX fixture's N(0,1) k=512 rows, and as much against the
# JAX forward there]
# The view-dependent forward on trained weights: a one-bf16-step flip of a
# directional hidden value (the kernel and its twin sum the same bf16
# operands in another order) moves a logit by |W2| * 2^-8 * |h1| and an
# output by a quarter of that: measured 1.9e-3 at k=512 after 5 epochs (H100
# at 700 W), against 2.4e-4 for the plain forward; the mean stays at
# rounding noise.
TOL_VD, MEAN_TOL_VD = 5e-3, 1e-4
# the jax_random phase's HQ epoch (183 steps) on the card against the plain
# twins on the CPU: the fused paths' loss bound (tests/test_torch_port_train.py)
LOSS_RTOL_TWIN = 2e-3
PSNR_MIN = 50.0       # kernel render vs plain-twin render, dB
H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12
H100_BYTES_PER_S = 3.35e12
HQ = {"num_layers": 6, "mlp_hidden_dim": 128, "skip_layer_idx": 3}
# Train kernels vs plain twins on the same inputs; in brackets what was
# measured on an H100 at 700 W (HQ leg k=512 / bench leg k=1023, B=4096):
#   fwd_bwd: activations ||d||/||x|| <= ACT_TOL [2.8e-4 / 3.7e-4]; with a
#     continuous (cotangent) seed the deltas <= DELTA_TOL [3.1e-3 / 1.9e-2]
#     and the bias sums <= BIAS_TOL [1.6e-3 / 4.5e-3];
#   wgrad on fwd_bwd's outputs: per tensor max|d|/max|g| <= WGRAD_TOL
#     [6.1e-7] (f32 sums over the batch in another order only);
#   both vs the whole twin (the forward's VJP): per tensor max|d|/max|g|
#     <= GRAD_MAX_REL [1.9e-2 / 3.1e-2], ||d||/||g|| <= E2E_NORM_TOL
#     [3.3e-3 / 1.0e-2].
# Why so loose: the tensor cores' f32 accumulation and the twin's sums round
# differently, so the kernel puts ~0.2% of the bf16 activations on the
# neighbouring value, ~4x as many as the same twin run on the CPU and on
# the card differ by (the "self" baseline, reported); a flipped relu mask or
# bf16 delta moves its row's deltas, more where features are unrescaled.
ACT_TOL, DELTA_TOL, BIAS_TOL, WGRAD_TOL = 1e-3, 5e-2, 2e-2, 1e-4
GRAD_MAX_REL, E2E_NORM_TOL = 1e-1, 5e-2
# L1 loss and squared-error sums of fwd_bwd vs its twin, |d| / (B*3): the
# predictions differ by rounding noise (about 1e-6), which on trained
# weights (|p - gt| ~ 2e-3) is ~1e-4 of the sums, not 1e-5.
LOSS_ELEM_TOL = 1e-5
# Autograd of the plain forward keeps the deltas in f32 where the kernels
# (and the reference Pallas backward) round them to bf16 before each
# matmul: ||d||/||g|| <= VJP_NORM_TOL [HQ leg 4.9e-3 and 6.3e-3].
VJP_NORM_TOL = 5e-2
# The JAX Trainer's scalar tags on a config without vis views
# (intrinsic_neural_fields_tpu/train/trainer.py: evaluate, test, train).
JAX_TRAINER_TAGS = sorted(["Train Rays-per-sec", "Train_Loss", "Train Epoch-PSNR",
                           "Val_Loss", "Val Epoch-PSNR", "Test Loss"])
# Random key counts for the sort kernel: tiny, one tile, ragged, the
# tracer's 2^18 and one past it (2^19 padded), and 2^20.
SORT_SIZES = (1, 255, 1000, 5000, 1 << 18, (1 << 18) + 1, 1 << 20)
# Share of the HQ train split's rays (union of both caches) on which the
# device cache (f32 raster tracer) and the --intersector host cache (f64
# BVH) agree on hit and face id. The same tracer on the CPU gave 0.99974
# (753,508 of 753,701 rays; every ray hit in both); the rest hit an edge
# shared by two faces, where f32 and f64 round to different sides. A
# gate at 0.999 allows four times that many.
AGREE_MIN = 0.999
# Not measured here: the redesigned kernels' times before their redesign
# (wgrad_adam: wgrad's and the Adam kernel's, the two launches it replaces),
# the train legs' best rays/s and the HQ step's best wall ms before the
# latest redesign, as PERF.md sections 5 and 6 record them (H100 80GB HBM3
# at 700 W). The phase rows print them under
# "cited_" keys beside this run's numbers; the kernels line carries none of
# them.
CITED_BEFORE_REDESIGN = {"fused_mlp_fwd_bwd": 0.1348, "fused_mlp_fwd_bwd_viewdep": 0.1744,
                         "bitonic_argsort": 0.1505, "fused_mlp_fwd": 0.0650,
                         "fused_mlp_fwd_viewdep": 0.0769, "fused_mlp_wgrad": 0.0517,
                         "fused_mlp_wgrad_viewdep": 0.0608, "hq_train": 40.80e6,
                         "viewdep_train": 34.29e6, "fused_adam": 0.00356,
                         # wgrad, then the Adam kernel (two launches before the epilogue)
                         "fused_mlp_wgrad_adam": 0.0229 + 0.00356,
                         "fused_mlp_wgrad_adam_viewdep": 0.0264 + 0.00406,
                         "hq_step_wall_ms": 0.1004}
REDESIGNED = ("fused_mlp_fwd_bwd", "fused_mlp_fwd_bwd_viewdep", "bitonic_argsort",
              "fused_mlp_fwd", "fused_mlp_fwd_viewdep", "fused_mlp_wgrad",
              "fused_mlp_wgrad_viewdep", "fused_adam", "fused_mlp_wgrad_adam",
              "fused_mlp_wgrad_adam_viewdep")
# The designed launch shapes of the forward and wgrad. The forward: 2-CTA
# clusters of 128-row CTAs (two warpgroups) while the CTA's resident bf16
# feature tile fits in shared memory (k_w <= 512 here), else 64-row CTAs.
# wgrad: one cluster of min(8, B/64) CTAs per 128-row gradient tile, 256
# threads, a 3-stage ring of 32 KB chunks.
FWD_ROWS = {512: 128, 1023: 64, 3: 128, 515: 128, 63: 128, 352: 128}
WGRAD_SMEM = 3 * 32768
# configs/synthetic/viewdep_intrinsic_blob.yaml's view_dependence section
VIEWDEP = {"bottleneck_vec_dim": 128, "include_view_dir": True, "embed_size": 4,
           "directional_hidden_dim": 128, "in_dim_view_dir": 1, "strategy": "intrinsic"}


def render_leg_of(renderer, cams, K):
    """A phase's renderer and views under bench.RenderLeg's names, so the
    later phases read every render leg alike."""
    return SimpleNamespace(renderer=renderer, cams=cams, K=K)


def train_leg_of(trainer, steps_per_epoch, batch):
    """A Trainer's state, train split and epoch function under
    bench.TrainLeg's names, so the train kernels' checks and the profile
    read every train leg alike."""
    return SimpleNamespace(state=trainer.state, data=trainer.train_data,
                           train_epoch=trainer.train_epoch_fn, steps_per_epoch=steps_per_epoch,
                           batch=batch)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() in ms, CUDA events around `iters` calls.
    The calls queue behind a device-side sleep, so a kernel shorter than
    its host launch cost is timed back to back, not at the launch rate."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)  # ~10 ms of GPU clock cycles: the host gets ahead
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _macs(layout):
    """Per row, real widths: (forward MACs, delta-walk MACs). The forward
    counts every layer's h and table rows (k_in features, venc_in view
    lanes) and the 3 RGB columns; the delta walk the RGB head's transpose
    and every layer's h-matrix but the first's."""
    H = layout.spec.hidden
    fwd = bwd = 0
    for lay in layout.layers:
        if lay.h is not None:
            fwd += lay.h[2] * H
            bwd += lay.h[2] * H
        if lay.ext is not None:
            fwd += lay.ext[2] * H
    return fwd + 3 * H, bwd + 3 * H


def cuda_ms_cold(fn, iters=20, warmup=3):
    """Mean device time of fn() in ms with the 50 MB L2 flushed before each
    call (a 128 MB write), CUDA events around each call alone: the time a
    caller whose buffers left the L2 sees."""
    import torch

    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    pairs = []
    for i in range(warmup + iters):
        flush.zero_()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        if i >= warmup:
            pairs.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def _bound(flops, nbytes, flops_rate=H100_BF16_FLOPS, f32_flops=0.0):
    """(least ms, "operations" or "bytes"): the larger of the operations at
    their peak rate (`flops` at flops_rate, plus f32_flops outside the
    tensor cores) and the bytes at the HBM rate."""
    t_ops = flops / flops_rate + f32_flops / H100_F32_FLOPS
    t_bytes = nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def mlp_bound_ms(fw, B):
    """Least time for the fused forward on this card: max of the FLOPs at
    the bf16 tensor-core peak and the bytes (x and the view encoding, packed
    weights and biases read once, [B,3] written once) at the HBM rate."""
    layout = fw.layout
    venc_in = 0 if layout.tail is None else layout.tail.venc_in
    nbytes = (B * (layout.spec.k_in + venc_in) * 4 + fw.w.numel() * 2 + fw.b.numel() * 4
              + B * 3 * 4)
    return _bound(2.0 * B * _macs(layout)[0], nbytes)


def phase_device():
    import torch

    from intrinsic_neural_fields_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    # registers and spills per kernel; ptxas's notes that it inserted a
    # warpgroup.arrive before a wgmma reading registers (C7519) are counted
    ptxas = {n: [ln.strip() for ln in b["ptxas"].splitlines()
                 if ("Used" in ln and "registers" in ln) or "spill" in ln]
             + [f'{sum("C7519" in ln for ln in b["ptxas"].splitlines())} C7519 notes']
             for n, b in built.items()}
    emit("device", kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         build_s=build_s, built=sorted(built), ptxas=ptxas)
    return smi


def _feature_batches(renderer, cams, K, B_full, B_ragged):
    """The features the render path feeds the MLP: the hit rays'
    interpolated rows of the renderer's feature table, view after view,
    encoded by the model's encoder for an xyz / ff / rff field."""
    import torch

    from intrinsic_neural_fields_tpu_torch.ops.interpolate import interpolate_vertex_features

    encode = renderer.field.encode or (lambda x: x)
    xs, n = [], 0
    for cam in cams:
        vids, bary, valid = renderer.trace_view(cam, K)[:3]
        with torch.no_grad():
            xs.append(encode(interpolate_vertex_features(renderer.features, vids[valid],
                                                         bary[valid])))
        n += xs[-1].shape[0]
        if n >= B_full:
            break
    check(n >= B_full, f"only {n} hit rays, need {B_full}")
    x = torch.cat(xs)
    return [x[:B_full].contiguous(), x[:B_ragged].contiguous()]


def phase_kernels(legs):
    """fused_apply vs fused_apply_plain on each leg's own features and
    weights: B=8192 (the renderer's chunk) and a ragged B."""
    import torch

    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (fused_apply, fused_apply_plain,
                                                                 last_fwd_launch)

    rows = []
    for leg, views in legs.items():
        fw = views.renderer.weights
        for x in _feature_batches(views.renderer, views.cams, views.K, 8192, 1000):
            B, k = x.shape
            got = fused_apply(fw, x)
            torch.cuda.synchronize()
            want = fused_apply_plain(fw, x)
            diff = (got - want).abs()
            check(torch.isfinite(got).all().item(), f"non-finite kernel output k={k} B={B}")
            bound, bound_by = mlp_bound_ms(fw, B)
            row = {"leg": leg, "k": k, "B": B, "max_abs_err": diff.max().item(),
                   "mean_abs_err": diff.mean().item(),
                   "kernel_ms": cuda_ms(lambda: fused_apply(fw, x)),
                   "launch": last_fwd_launch(),
                   "plain_ms": cuda_ms(lambda: fused_apply_plain(fw, x)),
                   "bound_ms": bound, "bound_by": bound_by}
            if (leg, B) == ("hq_eval", 8192):
                row["cited_ms_before_redesign"] = CITED_BEFORE_REDESIGN["fused_mlp_fwd"]
            emit("kernel_check", name="fused_mlp_fwd", tol=TOL, **row,
                 library="none: no single PyTorch call computes the whole MLP")
            rows.append(row)
    for row in rows:
        check(row["max_abs_err"] <= TOL, "fused_mlp_fwd disagrees with its plain twin: "
              f"{row['max_abs_err']} > {TOL} (k={row['k']}, B={row['B']})")
        check_fwd_launch(row["launch"], row["k"], row["B"], "fused_mlp_fwd")
    return rows


def check_fwd_launch(launch, k, B, name):
    rows = FWD_ROWS[k]
    check(launch["cluster"] == 2 and launch["rows"] == rows and launch["threads"] == 2 * rows
          and launch["ctas"] == 2 * -(-B // rows) and launch["x_resident"] == 1,
          f"{name} (k={k}, B={B}) does not launch 2-CTA clusters of {rows}-row CTAs "
          f"with a resident feature tile: {launch}")


def wgrad_tiles(layout):
    """wgrad's 128-row gradient tiles: the head, one per h-matrix, and the
    table rows of the input and skip matrices (k_w) in 128-row tiles."""
    tiles = 1
    for lay in layout.layers:
        tiles += 0 if lay.h is None else 1
        if lay.ext is not None:
            tiles += -(-(layout.spec.k_w if lay.ext[3] == "x" else layout.tail.venc_w) // 128)
    return tiles


def check_wgrad_launch(launch, tiles, B, name):
    split = min(8, -(-B // 64))
    check(launch == {"ctas": tiles * split, "cluster": split, "threads": 256,
                     "smem_bytes": WGRAD_SMEM, "tiles": tiles},
          f"{name} does not launch {tiles} clusters of {split} CTAs: {launch}")


def phase_hq_prep():
    """The HQ recipe's dataset and eigenfunctions through the port's CLIs,
    as scripts/run_synthetic_end_to_end.sh makes them (main(argv) in
    process; the eigensolve runs once per run, every later leg reuses it)."""
    import shutil

    from intrinsic_neural_fields_tpu_torch import make_synthetic_dataset, preprocess_eigenfunctions
    from intrinsic_neural_fields_tpu_torch.data.datasets import read_split_list
    from intrinsic_neural_fields_tpu_torch.geometry.mesh import load_mesh
    from intrinsic_neural_fields_tpu_torch.ops._build import BUILD_DIR

    root = os.path.join(BUILD_DIR, "hq_pipeline")
    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(root, "data")
    mesh_path = os.path.join(data, "blob.obj")
    t0 = time.perf_counter()
    make_synthetic_dataset.main([data, "--H", "256", "--W", "256", "--n_train", "20",
                                 "--subdivisions", "5"])
    t1 = time.perf_counter()
    preprocess_eigenfunctions.main([os.path.join(data, "efuncs"), mesh_path, "512"])
    t2 = time.perf_counter()
    base = "cotan_kmax512_skip_first_efuncs"
    efuncs_path = os.path.join(data, "efuncs", f"eigenfunctions_{base}.npy")
    evals = np.load(os.path.join(data, "efuncs", f"eigenvalues_{base}.npy"))
    check(os.path.islink(os.path.join(data, "efuncs", "blob.obj")), "the mesh is not linked")
    mesh = load_mesh(mesh_path)
    raw = np.load(efuncs_path)
    check(mesh.num_vertices == 10242 and mesh.num_faces == 20480, "unexpected blob size")
    check(raw.shape == (10242, 512) and raw.dtype == np.float32 and evals.shape == (512,)
          and np.all(np.diff(evals) >= 0) and evals[0] > 0, "bad eigenfunction files")
    views = {s: len(read_split_list(data, s)) for s in ("train", "val", "test", "vis")}
    check(views == {"train": 20, "val": 2, "test": 2, "vis": 2}, f"split sizes {views}")
    emit("hq_prep", generate_s=t1 - t0, eigensolve_s=t2 - t1, views=views, faces=mesh.num_faces,
         k=512, first_eigenvalues=evals[:4].tolist())
    return {"root": root, "data": data, "mesh_path": mesh_path, "efuncs_path": efuncs_path,
            "mesh": mesh, "raw": raw}


def _gt_views(renderer, cams, K):
    """Ground-truth views: procedural_texture at the traced hit points."""
    import torch

    from intrinsic_neural_fields_tpu_torch.geometry.synthetic import procedural_texture
    from intrinsic_neural_fields_tpu_torch.ops.interpolate import interpolate_vertex_features

    H, W = renderer.H, renderer.W
    verts = torch.as_tensor(renderer.mesh.vertices, dtype=torch.float32, device="cuda")
    views = []
    for cam in cams:
        vids, bary, valid, pix = renderer.trace_view(cam, K)[:4]
        pts = interpolate_vertex_features(verts, vids[valid], bary[valid])
        pix = pix[valid].cpu().numpy()
        img = np.ones((H * W, 3), np.float32)
        mask = np.zeros(H * W, bool)
        img[pix] = procedural_texture(pts.cpu().numpy().astype(np.float64))
        mask[pix] = True
        views.append({"camCv2world": cam, "K": K, "img": img.reshape(H, W, 3),
                      "obj_mask_1d": mask})
    return views


def phase_hq_eval(prep):
    """The render path: evaluate_views through the kernel renderer."""
    import torch

    from intrinsic_neural_fields_tpu_torch.evaluation.eval_cli import evaluate_views
    from intrinsic_neural_fields_tpu_torch.evaluation.metrics import psnr
    from intrinsic_neural_fields_tpu_torch.geometry.synthetic import pinhole_K, ring_cameras
    from intrinsic_neural_fields_tpu_torch.models import make_model
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (kernel_launches,
                                                                 reset_kernel_launches)
    from intrinsic_neural_fields_tpu_torch.render.renderer import Renderer
    from intrinsic_neural_fields_tpu_torch.spectral.features import postprocess_eigenfunctions

    mesh = prep["mesh"]
    efuncs = postprocess_eigenfunctions(prep["raw"], rescale_strategy="standard")

    H = W = 256
    config = {"data": {"img_height": H, "img_width": W, "precompute_dtype": "bfloat16"},
              "model": {"k": 512, **HQ}}
    model = make_model(config["model"], seed=0)
    kw = dict(H=H, W=W, feature_dtype="bfloat16", device="cuda")
    r_kernel = Renderer(model, mesh, efuncs, infer="kernel", **kw)
    r_plain = Renderer(model, mesh, efuncs, infer="plain", **kw)
    K = pinhole_K(H, W)
    cams = ring_cameras(8)
    views = _gt_views(r_kernel, cams, K)
    torch.cuda.synchronize()

    reset_kernel_launches()
    t1 = time.perf_counter()
    means, per_view = evaluate_views(None, config, views, renderer=r_kernel)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t1
    launches = kernel_launches()["fused_mlp_fwd"]
    check(launches > 0, "the HQ eval leg launched the fused kernel 0 times")
    check(all(np.isfinite(v["psnr"]) and np.isfinite(v["dssim_rescaled"])
              for v in per_view.values()), "non-finite metrics")

    psnr_kp = []
    for cam in cams:
        img_k, hit_k = r_kernel.render(cam, K, eval_render=True)
        img_p, hit_p = r_plain.render(cam, K, eval_render=True)
        check(np.array_equal(hit_k, hit_p), "kernel and plain renders disagree on the valid mask")
        check(np.isfinite(img_k).all() and img_k.shape == (H, W, 3), "bad kernel render")
        mask = np.zeros(H * W, bool)
        mask[hit_k] = True
        psnr_kp.append(psnr(img_k, img_p, mask))
    check(min(psnr_kp) >= PSNR_MIN, f"kernel vs plain render PSNR {min(psnr_kp)} < {PSNR_MIN}")
    emit("hq_eval", faces=mesh.num_faces, k=512, H=H, W=W, views=len(cams), eval_s=eval_s,
         psnr_vs_gt=means["psnr"], dssim_rescaled=means["dssim_rescaled"],
         psnr_kernel_vs_plain_min=min(psnr_kp),
         launches=launches, launches_per_view=launches / len(cams))
    return launches, render_leg_of(r_kernel, cams, K)


def phase_throughput():
    """bench.py's render leg through the port's bench (bench.render_leg):
    512^2, 81,920 faces, k=1023, 10 pipelined frames, best of 3 passes;
    every frame must launch the forward kernel; a stage split of one frame."""
    import torch

    from intrinsic_neural_fields_tpu_torch import bench

    leg = bench.render_leg(device="cuda")
    s = leg.summary()
    emit("throughput", card=torch.cuda.get_device_name(0),
         **{n: s[n] for n in ("H", "W", "faces", "k", "frames", "rays_per_s_best",
                              "rays_per_s_median", "frame_ms_best", "trace_ms", "infer_ms",
                              "fetch_ms", "peak_mem_gb")},
         launches_per_frame=sum(leg.launches_per_frame) / s["frames"],
         launches_by_frame=leg.launches_per_frame)
    return leg


class Recorder:
    """In-memory stand-in for tensorboardX's SummaryWriter (the card has no
    tensorboardX)."""

    def __init__(self):
        self.scalars, self.images = [], []

    def add_scalar(self, tag, value, global_step=None):
        self.scalars.append((tag, float(value), global_step))

    def add_image(self, tag, img, global_step=None):
        self.images.append((tag, tuple(np.shape(img)), global_step))

    def values(self, tag):
        return [v for t, v, _ in self.scalars if t == tag]


def _capture_sort_keys(fn):
    """Run fn() with the tracer's binning sort wrapped; returns a copy of
    the keys and key width of every sort it made (per view: the entries,
    then the overflow faces)."""
    from intrinsic_neural_fields_tpu_torch.ops import raster

    seen, inner = [], raster.argsort_keys

    def record(keys, total_bits, method):
        seen.append((keys.clone(), total_bits))
        return inner(keys, total_bits, method)

    raster.argsort_keys = record
    try:
        fn()
    finally:
        raster.argsort_keys = inner
    return seen


def phase_sort_kernel(tp_leg, hq_leg):
    """bitonic_argsort_vmem against its plain twin and torch.sort(stable=
    True) on the tracer's own keys and on random keys: equal to the bit.
    Times: CUDA events; bound: the keys read once and the int32 order
    written once at the HBM rate."""
    import torch

    from intrinsic_neural_fields_tpu_torch.ops import sort as S

    inputs = []
    for leg, views in (("render512", tp_leg), ("hq256", hq_leg)):
        keys = _capture_sort_keys(lambda: views.renderer.trace_view(views.cams[0], views.K))
        check(len(keys) == 2, f"{leg}: expected 2 binning sorts per view, saw {len(keys)}")
        inputs += [(f"{leg}_entry", *keys[0]), (f"{leg}_overflow", *keys[1])]
    g = torch.Generator(device="cuda").manual_seed(0)
    for n in SORT_SIZES:  # dense duplicates: about 8 keys per value
        keys = torch.randint(0, max(2, n // 8), (n,), generator=g, device="cuda",
                             dtype=torch.int32)
        inputs.append((f"random_{n}", keys, 31))
    rows = {}
    for name, keys, bits in inputs:
        want = torch.sort(keys, stable=True).indices
        c0 = S.bitonic_argsort_vmem.cuda_launches
        got = S.bitonic_argsort_vmem(keys, bits)
        torch.cuda.synchronize()
        cuda_launches = S.bitonic_argsort_vmem.cuda_launches - c0
        twin = S.bitonic_argsort(keys, bits)
        E = keys.numel()
        plan = S.sort_plan(E, S.device_max_ctas())
        row = {"E": E, "padded": 1 << plan.n, "key_bits": bits,
               "cuda_launches_per_call": cuda_launches, "plan_launches": len(plan.launches),
               "ctas": plan.ctas, "cooperative": plan.cooperative,
               "max_abs_err": (got.long() - want).abs().max().item(),
               "equal_to_sort": torch.equal(got.long(), want),
               "equal_to_twin": torch.equal(got, twin)}
        check(row["equal_to_sort"] and row["equal_to_twin"],
              f"bitonic_argsort disagrees on {name}: {row}")
        check(cuda_launches == len(plan.launches) and (E > 1 << 18 or cuda_launches == 1),
              f"bitonic_argsort made {cuda_launches} CUDA launches on {name}, plan {plan}")
        row["ms"] = cuda_ms(lambda: S.bitonic_argsort_vmem(keys, bits))
        row["plain_ms"] = cuda_ms(lambda: S.bitonic_argsort(keys, bits), iters=5)
        row["library_ms"] = cuda_ms(lambda: torch.sort(keys, stable=True))
        row["bound_ms"], row["bound_by"] = _bound(0.0, 8.0 * E)
        if name == "render512_entry":
            row["cited_ms_before_redesign"] = CITED_BEFORE_REDESIGN["bitonic_argsort"]
        emit("kernel_check", name="bitonic_argsort", input=name, **row)
        rows[name] = row
    return rows


def phase_trace_methods(tp_leg):
    """The 512^2 trace over 81,920 faces through intersect_coords_pinhole
    with every sort_method: the same hits to the bit. The kernel's counts
    are set to 0 just before each timed trace and read just after."""
    import torch

    from intrinsic_neural_fields_tpu_torch.ops import sort as S
    from intrinsic_neural_fields_tpu_torch.ops.launches import (kernel_launches,
                                                                reset_kernel_launches)
    from intrinsic_neural_fields_tpu_torch.ops.morton import pixel_morton_order
    from intrinsic_neural_fields_tpu_torch.ops.ray_gen import pixel_grid_coords
    from intrinsic_neural_fields_tpu_torch.ops.raster import intersect_coords_pinhole

    r, cams, K = tp_leg.renderer, tp_leg.cams, tp_leg.K
    H, W = r.H, r.W
    coords = pixel_grid_coords(H, W)
    coords = coords[pixel_morton_order(coords)]
    verts, faces = np.asarray(r.mesh.vertices, np.float32), np.asarray(r.mesh.faces)

    def trace(method):
        return intersect_coords_pinhole(verts, faces, cams[1], K, coords, W=W, H=H,
                                        sort_method=method)

    out = {}
    for method in ("argsort", "radix", "bitonic", "bitonic_vmem"):
        trace(method)  # warm-up
        torch.cuda.synchronize()
        reset_kernel_launches()
        c0 = S.bitonic_argsort_vmem.cuda_launches
        t0 = time.perf_counter()
        hits = trace(method)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        out[method] = {"hits": hits, "trace_ms": ms,
                       "launches": kernel_launches()["bitonic_argsort"],
                       "cuda_launches": S.bitonic_argsort_vmem.cuda_launches - c0,
                       "traverse_launches": kernel_launches()["raster_traverse"],
                       "bin_launches": kernel_launches()["raster_bin"]}
    ref = out["argsort"]["hits"]
    for method, o in out.items():
        check(all(torch.equal(getattr(o["hits"], f), getattr(ref, f))
                  for f in ("t", "face_idx", "bary", "valid")),
              f"sort_method={method!r} traces differently from 'argsort'")
        check((o["launches"] > 0) == (method == "bitonic_vmem"),
              f"bitonic_argsort launched {o['launches']} times under sort_method={method!r}")
        check(o["traverse_launches"] == 1,
              f"raster_traverse launched {o['traverse_launches']} times in one trace")
        check(o["bin_launches"] == 3,
              f"raster_bin launched {o['bin_launches']} times in one trace")
        o["bit_identical"] = True
        del o["hits"]
    emit("trace_methods", H=H, W=W, faces=faces.shape[0], hit_rays=int(ref.valid.sum()),
         methods=out)
    out["raster_traverse"] = _traverse_kernel_check(verts, faces, cams, K, coords, W, H)
    out["raster_bin"] = _bin_kernel_check(verts, faces, cams, K, coords, W, H)
    out["render_wire"] = _wire_kernel_check(r, cams, K)
    return out


def _wire_kernel_check(r, cams, K):
    """csrc/render_wire.cu against its twin compose_wire_plain on the 512^2
    orbit views' own records (the throughput leg's Renderer: u8 wire, no
    mask), on the card: equal to the bit, one launch a render. Times: CUDA
    events; bound: the slot map, the hit flags, the hits' colours and the
    wire image read or written once at the HBM rate; library_ms: torch's
    index_put_ of the composited Morton-order rows into the raster image,
    the scatter the kernel replaces (the port never calls it), which must
    give the kernel's image."""
    import torch

    from intrinsic_neural_fields_tpu_torch.ops import wire as WI
    from intrinsic_neural_fields_tpu_torch.ops.launches import (kernel_launches,
                                                                reset_kernel_launches)
    from intrinsic_neural_fields_tpu_torch.render import renderer as RM

    inner, rows = RM.compose_wire, []
    for i, cam in enumerate(cams[:4]):
        seen = []

        def spy(*args):
            seen.append(args)
            return inner(*args)

        RM.compose_wire = spy
        try:
            torch.cuda.synchronize()
            reset_kernel_launches()
            r.render(cam, K)
            launched = kernel_launches()["render_wire"]
        finally:
            RM.compose_wire = inner
        (preds, valid, slot, bg, wire_u8, _), = seen

        def kernel():
            return WI.compose_wire(preds, valid, slot, bg, wire_u8, False)

        def plain():
            return WI.compose_wire_plain(preds, valid, slot, bg, wire_u8, False)

        got, want = kernel(), plain()
        L, P = preds.shape[0], slot.numel()
        inside = (slot >= 0).nonzero().squeeze(1)
        pix_of_row = torch.empty(L, dtype=torch.int64, device=slot.device)
        pix_of_row[slot[inside].long()] = inside
        morton_rows = WI.compose_wire_plain(
            preds, valid, torch.arange(L, dtype=torch.int32, device=slot.device), bg, wire_u8,
            False)[0]
        lib_out = torch.empty_like(got[0])

        def library():
            return lib_out.index_put_((pix_of_row,), morton_rows)

        row = {"view": i, "pixels": P, "rays": L, "hits": int(valid.sum()),
               "launches_per_render": launched, "equal_to_twin": torch.equal(got[0], want[0]),
               "library_equal": torch.equal(library(), got[0])}
        check(row["equal_to_twin"] and row["library_equal"] and launched == 1,
              f"render_wire disagrees with compose_wire_plain or index_put_ on view {i}: {row}")
        row["ms"] = cuda_ms(kernel)
        row["plain_ms"] = cuda_ms(plain, iters=5)
        row["library_ms"] = cuda_ms(library)
        nbytes = P * 4 + L + row["hits"] * 12 + P * got[0].element_size() * 3
        row["bound_ms"], row["bound_by"] = _bound(0.0, nbytes)
        emit("kernel_check", name="render_wire", input=f"orbit512_view{i}", **row)
        rows.append(row)
    return rows


def _traverse_kernel_check(verts, faces, cams, K, coords, W, H):
    """csrc/raster_traverse.cu against its twin traverse_plain on the
    512^2 orbit views' own tables: equal to the bit, the same chunk counts.
    Times: CUDA events; bound: the pair tests of the chunks the walks
    tested, ~25 f32 operations each, at 67 TFLOP/s, or the rays, tables and
    hits read and written once at the HBM rate."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from intrinsic_neural_fields_tpu_torch.ops import launches
    from intrinsic_neural_fields_tpu_torch.ops import raster as RA

    v = torch.as_tensor(verts, device="cuda")
    f = torch.as_tensor(np.asarray(faces, np.int64), device="cuda")
    c = torch.as_tensor(coords, device="cuda")
    Tx, Ty = -(-W // RA.TILE_PX), -(-H // RA.TILE_PX)

    def traced(fn):  # (hits, chunks reached, chunks tested)
        launches.reset_kernel_launches()
        with profile(activities=[ProfilerActivity.CPU]):
            with launches.span("traverse"):
                out = fn()
        (rec,) = [r for r in launches.spans(0, 2 ** 63 - 1)[0] if r["name"] == "traverse"]
        return out, rec["attrs"]["chunks"], rec["attrs"]["chunks_tested"]

    rows = []
    for i, cam in enumerate(cams[:4]):
        tables, o, d, _ = RA.bin_view(v, f, cam, K, c, W=W, H=H)

        def kernel():
            return RA.traverse(tables, o, d, c, Tx=Tx, Ty=Ty)

        def plain():
            return RA.traverse_plain(tables, o, d, c, Tx=Tx, Ty=Ty)

        (got, reached, tested), (want, p_reached, p_tested) = traced(kernel), traced(plain)
        row = {"view": i, "rays": c.shape[0], "chunks": reached, "chunks_tested": tested,
               "equal_to_twin": all(torch.equal(a, b) for a, b in zip(got, want)),
               "counts_equal": (reached, tested) == (p_reached, p_tested)}
        check(row["equal_to_twin"] and row["counts_equal"],
              f"raster_traverse disagrees with traverse_plain on view {i}: {row}")
        row["ms"] = cuda_ms(kernel)
        row["plain_ms"] = cuda_ms(plain, iters=5)
        e_tot = tables.ed_rows.shape[0]
        nbytes = c.shape[0] * (12 + 8 + 4 + 8) + e_tot * 48 + tables.offsets.numel() * 8
        row["bound_ms"], row["bound_by"] = _bound(
            0.0, nbytes, f32_flops=25.0 * tested * RA.RAY_TILE * RA.CHUNK)
        emit("kernel_check", name="raster_traverse", input=f"orbit512_view{i}", **row)
        rows.append(row)
    return rows


def _bin_kernel_check(verts, faces, cams, K, coords, W, H):
    """csrc/raster_bin.cu's three launches (with the two sort calls)
    against their twin bin_faces_plain on the 512^2 orbit views, on the card
    and on one face table: every BinTables field equal to the bit. Times:
    the three launches' device time from torch.profiler (`ms`), the sorts'
    beside it (`sort_ms`), the whole binning by CUDA events (`binning_ms`),
    the host's time to enqueue it (`host_ms`), the twin's synchronized wall
    time (`plain_ms`); bound: the bytes the three launches read and write
    once at the HBM rate."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from intrinsic_neural_fields_tpu_torch.ops import raster as RA

    v = torch.as_tensor(verts, device="cuda")
    f = torch.as_tensor(np.asarray(faces, np.int64), device="cuda")
    table = RA.face_table(v, f)
    hull = np.stack([coords.min(0), coords.max(0)]).astype(np.float32)
    F = f.shape[0]
    rows = []
    for i, cam in enumerate(cams[:4]):
        def kernel():
            return RA.bin_faces_kernel(table, cam, K, hull, W, H)

        def plain():
            return RA.bin_faces_plain(table, cam, K, hull, W, H)

        got, want = kernel(), plain()
        same = {name: torch.equal(g, w) if isinstance(g, torch.Tensor) else g == w
                for name, g, w in zip(got._fields, got, want)}
        row = {"view": i, "faces": F, "entries": got.e_pad,
               "lost_faces": int(got.lost_faces), "o_chunks": int(got.o_chunks),
               "equal_to_twin": all(same.values())}
        check(row["equal_to_twin"], f"raster_bin disagrees with bin_faces_plain on view {i}: "
                                    f"{same}")
        row["binning_ms"] = cuda_ms(kernel)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            kernel()
        row["host_ms"] = 1e3 * (time.perf_counter() - t0) / 20
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            plain()
        torch.cuda.synchronize()
        row["plain_ms"] = 1e3 * (time.perf_counter() - t0) / 5
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                kernel()
            torch.cuda.synchronize()
        by_kernel = _device_us_by_kernel(prof)
        row["ms"] = sum(us for k, us in by_kernel.items() if "raster_bin" in k) / 20e3
        row["sort_ms"] = sum(us for k, us in by_kernel.items() if "raster_bin" not in k) / 20e3
        # project: the table (n, a, b, c, a0, b0, ok, tri) in, the view's
        # values, z, tiles and flags out; keys: those in, zq's keys, the
        # compacted slots, the overflow keys and zfloor out; tables: the
        # sorted keys and orders, two gathered face rows and the view's
        # values in, the rows, face ids, offsets and minima out
        ecap, etot = got.e_pad, got.ed_rows.shape[0]
        nbytes = (F * (85 + 36) + F * (24 + 12) + ecap * 8
                  + ecap * (4 + 8 + 4) + F * 8 + etot * (36 + 12 + 4)
                  + etot * (48 + 8) + got.offsets.numel() * 8)
        row["bound_ms"], row["bound_by"] = _bound(0.0, nbytes)
        emit("kernel_check", name="raster_bin", input=f"orbit512_view{i}", **row)
        rows.append(row)
    return rows


def _cache_agreement(dev_dir, host_dir):
    """Rays of two caches of one split matched by their unit ray direction
    (the same host arithmetic on the same pixels gives the same bytes; no
    two pixels share one): the share of the union whose face id agrees."""
    def load(d):
        dirs = np.load(os.path.join(d, "unit_ray_dirs.npy"))
        return {row.tobytes(): i for i, row in enumerate(dirs)}, np.load(
            os.path.join(d, "face_idxs.npy"))

    (kd, fd), (kh, fh) = load(dev_dir), load(host_dir)
    both = kd.keys() & kh.keys()
    union = len(kd.keys() | kh.keys())
    same = sum(int(fd[kd[k]] == fh[kh[k]]) for k in both)
    return {"device_rays": len(kd), "host_rays": len(kh), "hit_by_both": len(both),
            "same_face": same, "share": same / max(union, 1)}


def phase_hq_preprocess(prep):
    """preprocess_dataset on the card (raster tracer) for the three splits:
    train and test through main(argv) in process, val through the module
    entry point in a subprocess; the train split again on the host (f64
    BVH) and the two caches compared."""
    import torch

    from intrinsic_neural_fields_tpu_torch import preprocess_dataset
    from intrinsic_neural_fields_tpu_torch.data.datasets import read_split_list
    from intrinsic_neural_fields_tpu_torch.data.preprocess import MeshViewPreProcessor
    from intrinsic_neural_fields_tpu_torch.ops.ray_gen import pixel_grid_coords
    from intrinsic_neural_fields_tpu_torch.utils.io import load_cameras, load_obj_mask_as_numpy

    data, mesh_path = prep["data"], prep["mesh_path"]
    pre = os.path.join(prep["root"], "preprocessed")
    host = os.path.join(prep["root"], "preprocessed_host")
    views = {s: read_split_list(data, s) for s in ("train", "val", "test")}
    split_s = {}
    for split in ("train", "test"):
        t0 = time.perf_counter()
        preprocess_dataset.main([pre, mesh_path, data, split])
        split_s[split] = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "intrinsic_neural_fields_tpu_torch.preprocess_dataset", pre,
         mesh_path, data, "val"], cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True)
    split_s["val"] = time.perf_counter() - t0
    check(proc.returncode == 0, f"python -m ...preprocess_dataset failed:\n{proc.stderr[-3000:]}")
    t0 = time.perf_counter()
    preprocess_dataset.main([host, mesh_path, data, "train", "--intersector", "host"])
    host_s = time.perf_counter() - t0

    rays = {}
    for split in views:
        arrs = {n: np.load(os.path.join(pre, split, f"{n}.npy")) for n in
                ("face_idxs", "vids_of_hit_faces", "barycentric_coords", "expected_rgbs",
                 "unit_ray_dirs")}
        n = arrs["face_idxs"].shape[0]
        check(n > 0 and all(a.shape[0] == n for a in arrs.values())
              and np.all((arrs["face_idxs"] >= 0) & (arrs["face_idxs"] < prep["mesh"].num_faces))
              and np.allclose(arrs["barycentric_coords"].sum(1), 1.0, atol=1e-5)
              and np.all(np.isfinite(arrs["expected_rgbs"])),
              f"bad {split} cache")
        rays[split] = n

    # the device trace alone per train view (synchronous: trace + hit fetch)
    pp = MeshViewPreProcessor(mesh_path, None)
    trace_ms = []
    for v in views["train"]:
        vp = os.path.join(data, v)
        cam, K = load_cameras(vp)
        mask = load_obj_mask_as_numpy(vp)
        coords = pixel_grid_coords(*mask.shape)[mask.reshape(-1)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pp._intersect_coords(cam, K, coords, *mask.shape)
        trace_ms.append(1e3 * (time.perf_counter() - t0))
    agree = _cache_agreement(os.path.join(pre, "train"), os.path.join(host, "train"))
    check(agree["share"] >= AGREE_MIN, f"device and host caches agree on {agree} < {AGREE_MIN}")
    emit("hq_pipeline", rays=rays, views={s: len(v) for s, v in views.items()},
         split_s=split_s, s_per_view={s: split_s[s] / len(views[s]) for s in views},
         val_via_subprocess=True, host_train_s=host_s,
         trace_ms_per_view_median=float(np.median(trace_ms)), trace_ms_per_view=trace_ms,
         agreement=agree, agreement_min=AGREE_MIN)
    return dict(prep, pre=pre, rays=rays)


def _graph_stats(trainer, launches, steps, epochs, names):
    """What the Trainer's blocks + fused_adam epochs did on the card: kernel
    launches per step (of the kernels `names`), host dispatches (graph
    replays) per epoch, captures and the last capture's seconds."""
    g = trainer.train_epoch_fn.graph
    return {"kernels_per_step": sum(launches[n] for n in names) / steps,
            "host_dispatches_per_epoch": g.replays / epochs, "graph_captures": g.captures,
            "graph_capture_s": g.capture_s}


def _yardstick_equal(p, trainer, rec, config_fn, out_name, mesh, renderer, data, tail):
    """The same run with training.fused_adam false (per step from the host:
    fwd_bwd, the grads-only wgrad, the Adam kernel, the accumulators in
    torch), counters set to 0 just before and read just after: its params,
    moments, epoch losses and PSNRs must equal the graph-replayed run's to
    the bit, and the run's bf16 weight copy its params rounded to bf16.
    Returns (its launches, the comparison)."""
    import torch

    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (kernel_launches,
                                                                 reset_kernel_launches)
    from intrinsic_neural_fields_tpu_torch.train import Trainer, get_model_and_optim

    cfg = config_fn(p, out_name, 5)
    cfg["training"]["fused_adam"] = False
    model, opt = get_model_and_optim(cfg, mesh)
    rec_y = Recorder()
    yard = Trainer(model, opt, "L1", renderer, data, mesh, cfg, writer=rec_y)
    reset_kernel_launches()
    yard.train()
    torch.cuda.synchronize()
    launches = kernel_launches()
    nb = data["train"].n // 4096
    check(launches["fused_mlp_fwd_bwd" + tail] == launches["fused_mlp_wgrad" + tail]
          == launches["fused_adam"] == 5 * nb and launches["fused_mlp_wgrad_adam" + tail] == 0,
          f"fused_adam=False did not run fwd_bwd, wgrad and Adam once per step: {launches}")
    wb = trainer.train_epoch_fn.graph.bufs.scratch.wb
    cmp = {name: torch.equal(getattr(yard.state, name), getattr(trainer.state, name))
           for name in ("params", "mu", "nu")}
    cmp["wb"] = torch.equal(wb, yard.state.params.to(torch.bfloat16))
    for tag in ("Train_Loss", "Train Epoch-PSNR"):
        cmp[tag] = rec_y.values(tag) == rec.values(tag)
    check(all(cmp.values()), f"the graph epoch and the fused_adam=False loop differ: {cmp}")
    return launches, cmp


def _hq_train_config(p, out_name, epochs):
    """configs/synthetic/intrinsic_blob_hq.yaml on the hq_pipeline's files,
    cut to `epochs` epochs, checkpoints every 3 epochs, no vis views (the
    card has no tensorboardX to show them)."""
    return {
        "seed": 0,
        "data": {
            "precompute_dtype": "bfloat16",
            "preproc_data_path_train": os.path.join(p["pre"], "train"),
            "preproc_data_path_eval": os.path.join(p["pre"], "val"),
            "preproc_data_path_test": os.path.join(p["pre"], "test"),
            "eigenfunctions_path": p["efuncs_path"],
            "mesh_path": p["mesh_path"],
            "img_height": 256, "img_width": 256,
            "eval_render_input_paths": [], "eval_render_img_names": [],
        },
        "model": {"k": 512, **HQ},
        "training": {
            "out_dir": os.path.join(p["root"], out_name), "batch_size": 4096, "lr": 0.0001,
            "loss_type": "L1", "render_every": 100, "print_every": 1, "epochs": epochs,
            "checkpoint_every": 3, "shuffle": "blocks", "fused_mlp": True,
        },
    }


def _dataset_views(p, split):
    from intrinsic_neural_fields_tpu_torch.data.datasets import MeshViewsDataset

    return list(MeshViewsDataset(p["data"], split, H=256, W=256))


def phase_hq_train(p):
    """The training path: the port's Trainer on the HQ recipe over the
    hq_pipeline's caches, through the kernels; then resume, the eval of the
    val views before/after, and the port's eval CLI on the test split."""
    import pickle
    import shutil

    import torch
    import yaml

    from intrinsic_neural_fields_tpu_torch import eval as eval_cli
    from intrinsic_neural_fields_tpu_torch.evaluation.eval_cli import evaluate_views
    from intrinsic_neural_fields_tpu_torch.geometry.mesh import load_mesh
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (kernel_launches,
                                                                 reset_kernel_launches)
    from intrinsic_neural_fields_tpu_torch.train import (Trainer, get_data, get_model_and_optim,
                                                         get_renderer)
    from intrinsic_neural_fields_tpu_torch.train.steps import eager_step

    root = p["root"]
    config = _hq_train_config(p, "out", 5)
    mesh = load_mesh(config["data"]["mesh_path"])
    model, optimizer = get_model_and_optim(config, mesh)
    renderer = get_renderer(config, model, mesh)
    t0 = time.perf_counter()
    n_rays = p["rays"]
    data = get_data(config, mesh)
    val_views = _dataset_views(p, "val")
    setup_s = time.perf_counter() - t0
    check(data["train"].hit_features.dtype == torch.bfloat16, "the HQ table is not bf16")
    before, _ = evaluate_views(None, config, val_views, renderer=renderer)

    # the training path: counters to 0 just before, read just after
    rec = Recorder()
    trainer = Trainer(model, optimizer, "L1", renderer, data, mesh, config, writer=rec)
    reset_kernel_launches()
    eager_step.launches = 0
    t1 = time.perf_counter()
    trainer.train()
    renderer.update_variables(trainer.state.state_dict())
    after, _ = evaluate_views(None, config, val_views, renderer=renderer)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t1
    launches, eager = kernel_launches(), eager_step.launches

    plain_kernels = ("fused_mlp_fwd", "fused_mlp_fwd_bwd", "fused_mlp_wgrad_adam")
    check(all(launches[k] > 0 for k in plain_kernels)  # the evals' traces: raster_traverse
          and not any(launches[k] for k in launches if k not in plain_kernels + (
              "raster_traverse", "raster_bin", "render_wire")),
          f"the HQ path's kernels did not launch, or others did: {launches}")
    check(eager == 0, f"the eager step ran {eager} times on the HQ recipe")
    losses = rec.values("Train_Loss")
    check(len(losses) == 5 and losses[-1] < losses[0], f"train loss did not fall: {losses}")
    check(sorted({t for t, _, _ in rec.scalars}) == JAX_TRAINER_TAGS and not rec.images,
          f"tags differ from the JAX Trainer's: {sorted({t for t, _, _ in rec.scalars})}")
    check(all(torch.isfinite(t).all().item() for t in (trainer.state.params, trainer.state.mu,
                                                       trainer.state.nu)), "non-finite state")
    nb = data["train"].n // 4096
    check(launches["fused_mlp_fwd_bwd"] == launches["fused_mlp_wgrad_adam"] == 5 * nb,
          f"not one fwd_bwd and one wgrad_adam per step: {launches}")
    graph = _graph_stats(trainer, launches, 5 * nb, 5, ("fused_mlp_fwd_bwd",
                                                          "fused_mlp_wgrad_adam"))
    check(graph["kernels_per_step"] == 2 and graph["host_dispatches_per_epoch"] == 1
          and graph["graph_captures"] == 1, f"not one graph replay per epoch: {graph}")

    # resume from checkpoint.pt (epoch 3) for the last epoch: bit-equal
    shutil.copytree(config["training"]["out_dir"], os.path.join(root, "resumed"))
    cfg_r = _hq_train_config(p, "resumed", 5)
    model_r, opt_r = get_model_and_optim(cfg_r, mesh)
    resumed = Trainer(model_r, opt_r, "L1", renderer, data, mesh, cfg_r, writer=Recorder())
    resumed.train()
    for name in ("params", "mu", "nu"):
        check(torch.equal(getattr(resumed.state, name), getattr(trainer.state, name)),
              f"resumed {name} differs from the uninterrupted run")
    check(resumed.state.count == trainer.state.count == 5 * nb, "Adam counts differ")
    check(resumed.train_epoch_fn.graph.captures == 1, "the resumed run did not capture its graph")
    yard_launches, yard_cmp = _yardstick_equal(p, trainer, rec, _hq_train_config, "yardstick",
                                               mesh, renderer, data, "")

    # the port's eval CLI on the test split, with the trained model.pt
    cfg_path = os.path.join(root, "hq_config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(config, f)
    test_dir = os.path.join(root, "test_eval")
    eval_cli.main([test_dir, cfg_path, p["data"], "test"])
    with open(os.path.join(test_dir, "evaluation_metrics.pkl"), "rb") as f:
        test_metrics = pickle.load(f)
    test_psnr = float(np.mean([m["psnr"] for m in test_metrics.values()]))
    check(len(test_metrics) == 2 and np.isfinite(test_psnr), f"bad test eval {test_metrics}")

    rays = rec.values("Train Rays-per-sec")
    p["hq_train_rays_per_s"] = (max(rays), float(np.median(rays)))
    emit("hq_train", n_train=n_rays["train"], n_val=n_rays["val"], n_test=n_rays["test"],
         test_psnr_eval_cli=test_psnr, steps_per_epoch=nb, setup_s=setup_s, path_s=path_s,
         epochs=5,
         epochs_per_s=5 / path_s, train_rays_per_s_best=max(rays),
         train_rays_per_s_median=float(np.median(rays)),
         cited_train_rays_per_s_best_before_redesign=CITED_BEFORE_REDESIGN["hq_train"],
         train_loss=losses,
         val_psnr=rec.values("Val Epoch-PSNR"), test_loss=rec.values("Test Loss"),
         psnr_before=before["psnr"], dssim_before=before["dssim_rescaled"],
         psnr_after=after["psnr"], dssim_after=after["dssim_rescaled"],
         launches=launches, eager_steps=eager, resumed_bit_equal=True, **graph,
         cited_step_wall_ms_best_before=CITED_BEFORE_REDESIGN["hq_step_wall_ms"],
         step_wall_ms_best=4096e3 / max(rays),
         fused_adam_false_launches=yard_launches, fused_adam_false_bit_equal=yard_cmp)
    return launches, yard_launches, train_leg_of(trainer, nb, 4096)


# The JAX package's own files for the HQ recipe's model (k=512, 6 x 128, skip
# 3), written by tools/make_jax_checkpoint_fixture.py: model.ckpt,
# checkpoint.ckpt (epoch 2, Adam count 6) and expected.npz, the JAX fused
# forward (Pallas in interpret mode: bf16 operands, f32 sums) on 8,192 rows
# drawn from default_rng(seed).
JAX_FIXTURE = os.path.join(REPO, "tests", "data", "jax_checkpoint_hq")


def phase_jax_checkpoint(p, hq_leg, hq_eval_launches):
    """A TPU-trained out_dir on the card: the fixture's model.ckpt decoded
    by the port (no flax, no msgpack) into the forward kernel on the
    fixture's rows (within TOL of the JAX forward and of the plain twin,
    one launch); the eval CLI on an out_dir holding only model.ckpt, equal
    to the bit to the eval of a model.pt the port saved from the same
    weights, with as many forward launches per view as each other and as
    the HQ eval leg (both 256^2 views); the HQ Trainer on an
    out_dir holding only checkpoint.ckpt: it starts at epoch + 1 with the
    decoded params, moments, count and lr to the bit, trains 2 epochs as
    graph replays of fwd_bwd + wgrad_adam, and writes checkpoint.pt, from
    which a second Trainer resumes (not from the .ckpt) to the first run's
    state, to the bit. Counters set to 0 just before each path, read just
    after."""
    import pickle
    import shutil

    import torch

    from intrinsic_neural_fields_tpu_torch import eval as eval_cli
    from intrinsic_neural_fields_tpu_torch.geometry.mesh import load_mesh
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (FusedMLPSpec, fused_apply,
                                                                 fused_apply_plain,
                                                                 kernel_launches, pack_weights,
                                                                 reset_kernel_launches)
    from intrinsic_neural_fields_tpu_torch.train import Trainer, get_data, get_model_and_optim
    from intrinsic_neural_fields_tpu_torch.train.steps import eager_step
    from intrinsic_neural_fields_tpu_torch.utils.checkpoint import (load_jax_train_checkpoint,
                                                                    load_trained_weights,
                                                                    save_model)

    t_phase = time.perf_counter()
    root = p["root"]
    expected = np.load(os.path.join(JAX_FIXTURE, "expected.npz"))
    model_cfg = {"k": 512, **HQ}
    decode_s = {}
    t0 = time.perf_counter()
    sd = load_trained_weights(os.path.join(JAX_FIXTURE, "model.ckpt"), model_cfg)
    decode_s["model.ckpt"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ck = load_jax_train_checkpoint(os.path.join(JAX_FIXTURE, "checkpoint.ckpt"), model_cfg)
    decode_s["checkpoint.ckpt"] = time.perf_counter() - t0

    # the forward kernel on the fixture's rows
    rows = np.random.default_rng(int(expected["seed"])).normal(size=(8192, 512)).astype(np.float32)
    check(rows.astype(np.float64).sum() == expected["rows_sum"],
          "numpy drew other rows than the fixture tool")
    fw = pack_weights(FusedMLPSpec(6, 512, 128, 3), sd, device="cuda")
    x = torch.from_numpy(rows).cuda()
    torch.cuda.synchronize()
    reset_kernel_launches()
    got = fused_apply(fw, x)
    torch.cuda.synchronize()
    fwd_launches = {k: v for k, v in kernel_launches().items() if v}
    check(fwd_launches == {"fused_mlp_fwd": 1},
          f"the fixture forward was not one fused_mlp_fwd launch: {fwd_launches}")
    err_jax = (got.cpu() - torch.from_numpy(expected["rgb"])).abs().max().item()
    err_plain = (got - fused_apply_plain(fw, x)).abs().max().item()
    check(torch.isfinite(got).all().item() and got.shape == (8192, 3), "bad fixture forward")
    check(err_jax <= TOL and err_plain <= TOL,
          f"fixture forward vs JAX {err_jax}, vs plain twin {err_plain} (tolerance {TOL})")

    # the eval CLI on a JAX out_dir, and on the port's model.pt of the same weights
    evals = {}
    for kind in ("ckpt", "pt"):
        cfg = _hq_train_config(p, f"jax_out_{kind}", 5)
        out = cfg["training"]["out_dir"]
        os.makedirs(out)
        if kind == "ckpt":
            shutil.copy(os.path.join(JAX_FIXTURE, "model.ckpt"), out)
        else:
            save_model(os.path.join(out, "model.pt"), sd)
        cfg_path = _write_config(root, f"jax_out_{kind}.yaml", cfg)
        eval_dir = os.path.join(root, f"jax_eval_{kind}")
        reset_kernel_launches()
        eval_cli.main([eval_dir, cfg_path, p["data"], "test"])
        torch.cuda.synchronize()
        launched = {k: v for k, v in kernel_launches().items() if v}
        with open(os.path.join(eval_dir, "evaluation_metrics.pkl"), "rb") as f:
            metrics = pickle.load(f)
        images = {}
        for name in sorted(os.listdir(eval_dir)):
            if name.endswith(".png"):
                with open(os.path.join(eval_dir, name), "rb") as f:
                    images[name] = f.read()
        evals[kind] = {"launches": launched, "views": len(metrics), "images": images,
                       "scores": {v: (m["psnr"], m["dssim_rescaled"]) for v, m in metrics.items()}}
    a, b = evals["ckpt"], evals["pt"]
    check(a["images"] and a["images"] == b["images"] and a["scores"] == b["scores"],
          f"the JAX out_dir's eval differs from the model.pt's: {a['scores']} {b['scores']}")
    check(set(a["launches"]) == {"fused_mlp_fwd", "raster_traverse", "raster_bin", "render_wire"}
          and a["launches"]["raster_traverse"] == a["launches"]["render_wire"] == a["views"]
          and a["launches"]["raster_bin"] == 3 * a["views"] and a["launches"] == b["launches"],
          f"eval launches: JAX out_dir {a['launches']}, model.pt {b['launches']} "
          f"(one trace and one wire image per view: {a['views']})")
    eval_launches = a["launches"].get("fused_mlp_fwd", 0)
    hq_per_view = hq_eval_launches / len(hq_leg.cams)
    check(eval_launches / a["views"] == hq_per_view,
          f"{eval_launches} forward launches over {a['views']} views, the HQ eval {hq_per_view}")

    # resume the HQ recipe from the JAX checkpoint.ckpt: epoch + 1 .. 4
    cfg = _hq_train_config(p, "jax_resume", 5)
    mesh = load_mesh(cfg["data"]["mesh_path"])
    data = get_data(cfg, mesh)
    os.makedirs(cfg["training"]["out_dir"])
    shutil.copy(os.path.join(JAX_FIXTURE, "checkpoint.ckpt"), cfg["training"]["out_dir"])
    model, optimizer = get_model_and_optim(cfg, mesh)
    rec = Recorder()
    trainer = Trainer(model, optimizer, "L1", hq_leg.renderer, data, mesh, cfg, writer=rec)
    restored = {}
    load = trainer._init_or_load_checkpoint

    def spy():
        start = load()
        st = trainer.state
        restored.update(start=start, count=st.count, lr=st.hyper.learning_rate,
                        **{n: getattr(st, n).clone() for n in ("params", "mu", "nu")})
        return start

    trainer._init_or_load_checkpoint = spy
    nb = data["train"].n // 4096
    reset_kernel_launches()
    eager_step.launches = 0
    t1 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t1
    counted = kernel_launches()
    launches = {k: v for k, v in counted.items() if v}
    layout = trainer.state.layout
    epoch, count = int(expected["epoch"]), int(expected["count"])
    want = {"params": layout.flat_from_state_dict(ck["model_state_dict"], "cuda"),
            "mu": layout.flat_from_state_dict(ck["adam"]["mu"], "cuda"),
            "nu": layout.flat_from_state_dict(ck["adam"]["nu"], "cuda")}
    same = {n: torch.equal(restored[n], want[n]) for n in want}
    same["count"] = restored["count"] == ck["adam"]["count"] == count
    same["lr"] = np.float32(restored["lr"]) == expected["lr"]
    check(ck["epoch"] == epoch and restored["start"] == epoch + 1 and all(same.values()),
          f"the resumed state is not the decoded one: start {restored['start']}, {same}")
    steps = [s for tag, _, s in rec.scalars if tag == "Train_Loss"]
    check(steps == [epoch + 1, epoch + 2], f"trained epochs {steps}, want {epoch + 1}, {epoch + 2}")
    check(launches.get("fused_mlp_fwd_bwd") == launches.get("fused_mlp_wgrad_adam") == 2 * nb
          and set(launches) == {"fused_mlp_fwd_bwd", "fused_mlp_wgrad_adam"}
          and eager_step.launches == 0,
          f"the resumed epochs were not fwd_bwd + wgrad_adam once per step: {launches}")
    graph = _graph_stats(trainer, counted, 2 * nb, 2, ("fused_mlp_fwd_bwd",
                                                         "fused_mlp_wgrad_adam"))
    check(graph["kernels_per_step"] == 2 and graph["host_dispatches_per_epoch"] == 1
          and graph["graph_captures"] == 1, f"not one graph replay per epoch: {graph}")
    check(trainer.state.count == count + 2 * nb, "Adam count after the resumed epochs")
    check(os.path.exists(os.path.join(cfg["training"]["out_dir"], "checkpoint.pt")),
          "the resumed run wrote no checkpoint.pt")

    # a second Trainer takes the checkpoint.pt (epoch 3), not the .ckpt
    shutil.copytree(cfg["training"]["out_dir"], os.path.join(root, "jax_resume2"))
    cfg2 = _hq_train_config(p, "jax_resume2", 5)
    model2, opt2 = get_model_and_optim(cfg2, mesh)
    rec2 = Recorder()
    second = Trainer(model2, opt2, "L1", hq_leg.renderer, data, mesh, cfg2, writer=rec2)
    second.train()
    steps2 = [s for tag, _, s in rec2.scalars if tag == "Train_Loss"]
    check(steps2 == [epoch + 2], f"the second resume trained epochs {steps2}, want {epoch + 2}")
    for name in ("params", "mu", "nu"):
        check(torch.equal(getattr(second.state, name), getattr(trainer.state, name)),
              f"the run resumed from checkpoint.pt differs in {name}")
    losses = rec.values("Train_Loss")
    check(all(np.isfinite(losses)), f"non-finite resumed losses {losses}")
    phase_s = time.perf_counter() - t_phase
    emit("jax_checkpoint", fixture=os.path.relpath(JAX_FIXTURE, REPO), decode_s=decode_s,
         forward_max_abs_err_vs_jax=err_jax, forward_max_abs_err_vs_plain=err_plain,
         forward_launches=fwd_launches, eval_views=a["views"], eval_launches=eval_launches,
         eval_launches_per_view=eval_launches / a["views"],
         hq_eval_launches_per_view=hq_per_view, eval_scores=a["scores"],
         eval_bit_equal_to_model_pt=True, resumed_from_epoch=epoch, adam_count=count,
         resume_launches=launches, resume_s=resume_s, train_loss=losses,
         second_resume_epochs=steps2, second_resume_bit_equal=True, **graph)
    print(json.dumps({"jax_checkpoint_seconds": {"decode_s": decode_s, "phase_s": phase_s}}),
          flush=True)
    return {"forward": fwd_launches.get("fused_mlp_fwd", 0), "eval": eval_launches,
            "resume": {k: launches.get(k, 0) for k in ("fused_mlp_fwd_bwd",
                                                        "fused_mlp_wgrad_adam")},
            "max_abs_err": err_plain}


# The JAX package's draws for the HQ recipe, written by
# tools/make_jax_random_fixture.py: init_model's weights at seed 0, the
# load-time permutation of n = 750,000 records (its ends and SHA-256) and
# the JAX Trainer's block orders of epochs 0-2 at batch 4096.
JAX_RANDOM_FIXTURE = os.path.join(REPO, "tests", "data", "jax_random", "expected.npz")
JAX_RANDOM_VAL = 8192  # the phase's val split, records


def _flat_tree(tree, prefix):
    """{'/'-joined path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        out.update(_flat_tree(v, path) if isinstance(v, dict) else {path: v})
    return out


def _write_ray_cache(path, faces, n, rng):
    """A 3-npy ray cache of n seeded records over the mesh's faces."""
    os.makedirs(path)
    np.save(os.path.join(path, "vids_of_hit_faces.npy"),
            faces[rng.integers(0, len(faces), n)].astype(np.int32))
    np.save(os.path.join(path, "barycentric_coords.npy"),
            rng.dirichlet(np.ones(3), n).astype(np.float32))
    np.save(os.path.join(path, "expected_rgbs.npy"), rng.uniform(size=(n, 3)).astype(np.float32))


def phase_jax_random(p):
    """What a seed means, on the card, where there is no JAX: the port's
    draws (utils/jax_random.py) held to the JAX package's fixture to the
    bit, on the host and through the torch path on the card (the HQ
    model's initial weights, the load-time permutation of n records, the
    first block orders), each draw timed beside torch.randperm; then the
    HQ recipe's first epoch from them through the Trainer: the load-time
    shuffle of n seeded records, JAX's epoch-0 block order, one graph
    replay of fwd_bwd + wgrad_adam per step, its counters set to 0 just
    before and read just after. That epoch is held to its fused_adam:
    false loop to the bit and, as hq_train's, its kernels to their twins
    on its inputs (the returned leg goes to phase_train_kernels); the
    same epoch through the plain twins on the CPU gives its loss within
    LOSS_RTOL_TWIN. The update's distance to the CPU epoch's is recorded,
    not gated: over 183 Adam steps on random targets, gradients near zero
    whose sign flips under rounding move a weight by up to lr either way
    (tests/test_torch_port_bench.py's note)."""
    import hashlib

    import torch

    from intrinsic_neural_fields_tpu_torch.geometry.mesh import load_mesh
    from intrinsic_neural_fields_tpu_torch.models.factory import init_params
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (kernel_launches,
                                                                 reset_kernel_launches)
    from intrinsic_neural_fields_tpu_torch.train import (Trainer, get_data, get_model_and_optim,
                                                         get_renderer)
    from intrinsic_neural_fields_tpu_torch.train.steps import eager_step, epoch_order
    from intrinsic_neural_fields_tpu_torch.utils.jax_random import PRNGKey, fold_in, permutation
    from intrinsic_neural_fields_tpu_torch.utils.weights import state_dict_from_flax

    fx = np.load(JAX_RANDOM_FIXTURE)
    seed, n, batch = int(fx["seed"]), int(fx["n"]), int(fx["batch"])
    nb = n // batch
    key = PRNGKey(seed)

    def host_ms(fn, reps=3):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            if isinstance(out, torch.Tensor) and out.is_cuda:
                torch.cuda.synchronize()
            best = min(best, 1e3 * (time.perf_counter() - t0))
        return best, out

    def digest(perm):
        return hashlib.sha256(np.asarray(perm, dtype="<i4").tobytes()).hexdigest()

    # the draws, to the bit
    draw_ms = {}
    draw_ms["init_params"], tree = host_ms(lambda: init_params({"k": 512, **HQ}, seed))
    flat = _flat_tree(tree["params"], "init")
    want_init = {k: fx[k] for k in fx.files if k.startswith("init/")}
    check(set(flat) == set(want_init) and all(np.array_equal(flat[k], want_init[k])
                                              for k in flat),
          "the HQ initial weights differ from the JAX package's init_model")
    draw_ms["permutation_host"], perm_host = host_ms(lambda: permutation(key, n))
    draw_ms["permutation_card"], perm_card = host_ms(lambda: permutation(key, n, device="cuda"))
    draw_ms["randperm_host"], _ = host_ms(lambda: torch.randperm(n))
    draw_ms["randperm_card"], _ = host_ms(lambda: torch.randperm(n, device="cuda"))
    head = len(fx["perm_head"])
    for where, perm in (("host", perm_host), ("card", perm_card.cpu().numpy())):
        check(digest(perm) == str(fx["perm_sha256"])
              and np.array_equal(perm[:head], fx["perm_head"])
              and np.array_equal(perm[-head:], fx["perm_tail"]),
              f"the load-time permutation on the {where} is not jax.random.permutation's")
    draw_ms["block_order_host"], _ = host_ms(lambda: epoch_order(fold_in(key, 0), nb))
    for e, order in enumerate(fx["block_orders"]):
        check(np.array_equal(epoch_order(fold_in(key, e), nb).numpy(), order),
              f"epoch {e}'s block order is not the JAX Trainer's")

    # the HQ recipe's first epoch from those draws, through the Trainer
    root = os.path.join(p["root"], "jax_random")
    mesh = load_mesh(p["mesh_path"])
    rng = np.random.default_rng(seed)
    faces = np.asarray(mesh.faces)
    _write_ray_cache(os.path.join(root, "train"), faces, n, rng)
    _write_ray_cache(os.path.join(root, "val"), faces, JAX_RANDOM_VAL, rng)

    def config(out_name, **training):
        cfg = _hq_train_config(p, out_name, 1)
        cfg["data"]["preproc_data_path_train"] = os.path.join(root, "train")
        cfg["data"]["preproc_data_path_eval"] = os.path.join(root, "val")
        del cfg["data"]["preproc_data_path_test"]
        cfg["training"].update(out_dir=os.path.join(root, out_name), **training)
        return cfg

    def run(cfg, device="cuda"):
        model, optimizer = get_model_and_optim(cfg, mesh, device=device)
        data = get_data(cfg, mesh, device=device)
        rec = Recorder()
        trainer = Trainer(model, optimizer, "L1", get_renderer(cfg, model, mesh, device=device),
                          data, mesh, cfg, writer=rec, device=device)
        keys, fn = [], trainer.train_epoch_fn

        def spy(state, k, *args):
            keys.append(k)
            return fn(state, k, *args)

        trainer.train_epoch_fn = spy
        init = trainer.state.params.clone()
        if device == "cuda":
            torch.cuda.synchronize()
        reset_kernel_launches()
        eager_step.launches = 0
        t0 = time.perf_counter()
        trainer.train()
        if device == "cuda":
            torch.cuda.synchronize()
        trainer.train_epoch_fn = fn
        return SimpleNamespace(trainer=trainer, rec=rec, keys=keys, init=init, data=data,
                               seconds=time.perf_counter() - t0,
                               launches={k: v for k, v in kernel_launches().items() if v},
                               eager=eager_step.launches)

    main = run(config("jax_random_out"))
    fx_sd = state_dict_from_flax({"params": tree["params"]}, {"k": 512, **HQ})
    layout = main.trainer.state.layout
    check(torch.equal(main.init, layout.flat_from_state_dict(fx_sd, "cuda")),
          "the Trainer's initial params are not the JAX package's")
    check(torch.equal(main.data["train"].expected_rgbs.cpu(),
                      torch.from_numpy(np.load(os.path.join(root, "train", "expected_rgbs.npy"))
                                       [perm_host])),
          "the train split is not shuffled by the JAX load-time permutation")
    check(len(main.keys) == 1 and main.keys[0] == fold_in(key, 0),
          f"the Trainer's epoch keys {main.keys}, want fold_in(PRNGKey({seed}), 0)")
    launches = main.launches
    check(launches == {"fused_mlp_fwd_bwd": nb, "fused_mlp_wgrad_adam": nb}
          and main.eager == 0,
          f"the epoch was not one fwd_bwd and one wgrad_adam per step: {launches}, "
          f"{main.eager} eager steps")
    graph = _graph_stats(main.trainer, kernel_launches(), nb, 1,
                         ("fused_mlp_fwd_bwd", "fused_mlp_wgrad_adam"))
    check(graph["host_dispatches_per_epoch"] == 1 and graph["graph_captures"] == 1,
          f"not one graph replay for the epoch: {graph}")
    losses = main.rec.values("Train_Loss")

    yard = run(config("jax_random_loop", fused_adam=False))
    check(yard.launches == {"fused_mlp_fwd_bwd": nb, "fused_mlp_wgrad": nb, "fused_adam": nb},
          f"the fused_adam: false loop's launches {yard.launches}")
    for name in ("params", "mu", "nu"):
        check(torch.equal(getattr(yard.trainer.state, name), getattr(main.trainer.state, name)),
              f"the fused_adam: false loop's {name} differ from the graph epoch's")
    check(yard.rec.values("Train_Loss") == losses, "the loop's epoch loss differs")

    twin = run(config("jax_random_twin"), device="cpu")
    check(twin.keys == main.keys and torch.equal(twin.init, main.init.cpu()),
          "the CPU run drew other keys or weights")
    twin_losses = twin.rec.values("Train_Loss")
    loss_err = abs(losses[0] - twin_losses[0]) / abs(twin_losses[0])
    upd, upd_twin = main.trainer.state.params.cpu() - main.init.cpu(), \
        twin.trainer.state.params - twin.init
    update_err = float((upd - upd_twin).norm() / upd_twin.norm())
    check(np.isfinite(losses).all() and loss_err <= LOSS_RTOL_TWIN,
          f"the card's epoch loss {losses} against the plain twins' {twin_losses}")
    rays = main.rec.values("Train Rays-per-sec")
    emit("jax_random", fixture=os.path.relpath(JAX_RANDOM_FIXTURE, REPO), seed=seed, n=n,
         batch=batch, steps_per_epoch=nb, draws_bit_equal=True, draw_ms=draw_ms,
         run_s=main.seconds, epoch_rays_per_s=rays,
         train_loss=losses, twin_train_loss=twin_losses, loss_rel_err=loss_err,
         update_rel_err_vs_twin=update_err, twin_s=twin.seconds, launches=launches,
         fused_adam_false_launches=yard.launches, fused_adam_false_bit_equal=True, **graph)
    return {"train": launches, "loop": yard.launches}, train_leg_of(main.trainer, nb, batch)


def phase_train_throughput():
    """bench.py's train leg through the port's bench (bench.train_leg) on
    bench.make_arrays' numpy arrays: blocks epochs of 512 steps, one warm
    epoch (which captures the epoch's graph), then 3 timed groups of 16;
    one graph replay of two launches per step."""
    import torch

    from intrinsic_neural_fields_tpu_torch import bench

    arrays = bench.make_arrays()
    leg = bench.train_leg(arrays, device="cuda")
    s = leg.summary()
    graph = {"kernels_per_step": sum(leg.launches_per_step.values()),
             "host_dispatches_per_epoch": leg.graph_replays_per_epoch,
             "graph_captures": leg.graph_captures, "graph_capture_s": leg.graph_capture_s}
    check(leg.launches_per_step == {"fused_mlp_fwd_bwd": 1.0, "fused_mlp_wgrad_adam": 1.0}
          and graph["host_dispatches_per_epoch"] == 1,
          f"the bench epoch is not one replay of two launches per step: {s}")
    nb, B = leg.steps_per_epoch, leg.batch
    emit("train_throughput", card=torch.cuda.get_device_name(0), V=arrays[0].shape[0],
         k=s["k"], N=s["N"], batch=B, steps_per_epoch=nb, precompute_s=leg.precompute_s,
         rays_per_s_best=leg.rays_per_s_best, rays_per_s_median=leg.rays_per_s_median,
         epoch_s=leg.epoch_s, step_ms_best=1e3 * min(leg.epoch_s) / nb, losses=leg.losses,
         launches_per_step=leg.launches_per_step, **graph, peak_mem_gb=leg.peak_mem_gb)
    return arrays, leg


def phase_bench(arrays, render, train, smi):
    """bench.py's JSON line from the two legs' rates in this run and the
    reference's torch-CPU hot loop (bench.bench_torch_cpu) on the host's
    CPU over the train leg's arrays."""
    from intrinsic_neural_fields_tpu_torch import bench

    baseline = bench.bench_torch_cpu(*arrays)
    line = bench.bench_line(baseline, train.rays_per_s_best, train.rays_per_s_median,
                            render.rays_per_s_best)
    check(all(np.isfinite(v) and v > 0 for n, v in line.items() if n not in ("metric", "unit")),
          f"bench line {line}")
    emit("bench", bench=line, torch_cpu_rays_per_s=baseline,
         ref_render_rays_per_s=bench.REF_RENDER_RAYS_PER_S, card=smi)
    return line


def _train_bounds(layout, B, x_bytes):
    """Least times of the three train kernels on this card at batch B:
    max(FLOPs at the bf16 peak, bytes at the HBM rate), each input read once
    and each output written once; real widths (k_in, venc_in, 3 outputs).
    Keys: the plain layout's kernel names (a tail's kernels add _viewdep),
    and "fused_step": the whole step the TPU kernel computes in one call
    (forward, loss, deltas, weight gradients, Adam), whose activations and
    deltas stay on chip; fwd_bwd's and wgrad's own bounds count those
    intermediates, which only the port's two-launch split writes."""
    s = layout.spec
    H, nh = s.hidden, len(layout.layers)
    in_bytes = B * (s.k_in + (0 if layout.tail is None else layout.tail.venc_in)) * x_bytes
    fwd_macs, dgrad_macs = _macs(layout)
    nblk = -(-B // 64)
    act_bytes = nh * B * H * 2
    delta_bytes = act_bytes + B * 16 * 2
    part_bytes = nblk * (H * nh + 16 + 2) * 4
    return {
        "fused_mlp_fwd_bwd": _bound(2.0 * B * (fwd_macs + dgrad_macs),
                                    in_bytes + layout.n * 4 + B * 3 * 4
                                    + act_bytes + delta_bytes + part_bytes),
        "fused_mlp_wgrad": _bound(2.0 * B * fwd_macs,
                                  in_bytes + act_bytes + delta_bytes + part_bytes
                                  + layout.n * 4 + 8),
        # wgrad's reads, then params, m, v read and written, the bf16 copy
        # written, the hyper row read, the sums and accumulators
        "fused_mlp_wgrad_adam": _bound(2.0 * B * fwd_macs,
                                       in_bytes + act_bytes + delta_bytes + part_bytes
                                       + layout.n * (6 * 4 + 2) + 7 * 4 + 8 + 2 * 8,
                                       f32_flops=12.0 * layout.n),
        # 4 f32 reads, 3 writes, ~12 f32 operations per parameter (no tensor cores)
        "fused_adam": _bound(0.0, 7 * layout.n * 4 + 7 * 4, f32_flops=12.0 * layout.n),
        # x (and venc) and the targets read once; params, m, v read and written
        "fused_step": _bound(2.0 * B * (2 * fwd_macs + dgrad_macs),
                             in_bytes + B * 3 * 4 + 6 * layout.n * 4),
    }


def _per_tensor(layout, got, want):
    """(max over tensors of max|d|/max|g|, of ||d||/||g||, max |d|)."""
    mx, nr, ab = 0.0, 0.0, 0.0
    for a, b in zip(layout.mats(got) + layout.biases(got), layout.mats(want) + layout.biases(want)):
        d = (a - b).abs()
        mx = max(mx, (d.max() / b.abs().max().clamp_min(1e-30)).item())
        nr = max(nr, ((a - b).norm() / b.norm().clamp_min(1e-30)).item())
        ab = max(ab, d.max().item())
    return mx, nr, ab


def _wgrad_again_bit_equal(F, layout, table, B, sc, grads, sums, vtable=None):
    """Launch wgrad again on the same scratch: the same bits as grads, sums."""
    import torch

    g2, s2 = torch.empty_like(grads), torch.empty_like(sums)
    F._launch_wgrad(layout, table, 0, B, sc, g2, s2, vtable)
    torch.cuda.synchronize()
    return torch.equal(g2, grads) and torch.equal(s2, sums)


def _wgrad_adam_check(F, layout, table, x, B, sc, grads, sums, bsum, params, vtable=None,
                      v=None):
    """wgrad with its Adam epilogue on fwd_bwd's outputs in sc: to the bit
    against the Adam twin (new params, moments, bf16 copy, accumulators) on
    the grads-only wgrad's gradients and sums (grads, sums, from the same
    scratch), with moments random over the whole flat buffer, pads
    included; its largest difference to wgrad_adam_plain on the same
    fwd_bwd outputs; its time, the twin's."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(5)
    m = torch.randn(layout.n, generator=g, device="cuda") * 1e-4
    vv = torch.rand(layout.n, generator=g, device="cuda") * 1e-6
    hyper_all = F.adam_hyper_rows(torch.tensor([1000, 1001]), 1e-4, device="cuda")
    acc0 = torch.tensor([0.25, 0.5], device="cuda")
    want = F.adam_apply_plain(params, m, vv, hyper_all[1], grads)
    want_acc = acc0.clone()
    F.accumulate_loss(want_acc, sums[0], sums[1])
    wb_keep = sc.wb.clone()
    p2, m2, v2, acc, s2 = params.clone(), m.clone(), vv.clone(), acc0.clone(), torch.empty_like(sums)
    F._launch_wgrad_adam(layout, table, 0, B, sc, p2, m2, v2, hyper_all, s2, acc, vtable, step=1)
    torch.cuda.synchronize()
    r = {"bit_equal": all(torch.equal(a, b) for a, b in zip((p2, m2, v2), want))
         and torch.equal(sc.wb, want[0].to(torch.bfloat16)) and torch.equal(acc, want_acc)
         and torch.equal(s2, sums), "launch": F.last_wgrad_launch()}
    # the whole twin (wgrad_plain, then Adam) on the same fwd_bwd outputs
    tw = [t.clone() for t in (params, m, vv)]
    wb_t = torch.empty_like(sc.wb)
    acc_t = acc0.clone()
    F.wgrad_adam_plain(layout, x, sc.acts, sc.deltas, bsum, (sums[0], sums[1]), *tw,
                       hyper_all[1], wb_t, acc_t, v)
    r["max_abs_err"] = max((a - b).abs().max().item() for a, b in zip((p2, m2, v2), tw))
    r["ms"] = cuda_ms(lambda: F._launch_wgrad_adam(layout, table, 0, B, sc, p2, m2, v2, hyper_all,
                                                   s2, acc, vtable, step=1))
    r["plain_ms"] = cuda_ms(lambda: F.wgrad_adam_plain(layout, x, sc.acts, sc.deltas, bsum,
                                                       (sums[0], sums[1]), *tw, hyper_all[1],
                                                       wb_t, acc_t, v))
    r["library_ms"] = None  # no single PyTorch call computes the gradients and the update
    sc.wb.copy_(wb_keep)
    return r


def phase_train_kernels(legs, B=4096):
    """Each train kernel against its plain twin on the batch each train leg
    feeds it (block 0 of its table, B rows: 4096, or a data-parallel
    replica's B/D), and timed."""
    import torch

    from intrinsic_neural_fields_tpu_torch.ops import fused_mlp as F

    rows = {}
    for leg, run in legs.items():
        layout, table, gt_table = run.state.layout, run.data.hit_features, run.data.expected_rgbs
        params, mu, nu = (t.clone() for t in (run.state.params, run.state.mu, run.state.nu))
        x, gt = table[:B], gt_table[:B].contiguous()
        spec = layout.spec
        nblk, nbp = -(-B // F.BLOCK_ROWS), spec.hidden * (spec.num_layers - 1) + F.OUT_PAD
        sc = F.make_train_scratch(layout, B, params)
        mode, inv_n = F.LOSS_MODES["L1"], 1.0 / (B * 3)
        L, H = spec.num_layers, spec.hidden

        nl, HB = L - 1, B * H

        def norm_rel(a, b):
            a, b = a.float().view(a.shape[0], -1), b.float().view(b.shape[0], -1)
            return ((a - b).norm(dim=1) / b.norm(dim=1).clamp_min(1e-30)).max().item()

        def compare(acts, deltas, bsum, acts_p, deltas_p, bsum_p):
            return {"act_norm_rel": norm_rel(acts.view(nl, HB), acts_p.view(nl, HB)),
                    "act_mismatch_share": (acts != acts_p).float().mean().item(),
                    "delta_norm_rel": max(
                        norm_rel(deltas[:nl * HB].view(nl, HB), deltas_p[:nl * HB].view(nl, HB)),
                        norm_rel(deltas[nl * HB:].view(1, -1), deltas_p[nl * HB:].view(1, -1))),
                    "bias_sum_norm_rel": ((bsum - bsum_p).norm() / bsum_p.norm()).item(),
                    "max_abs_err": max((acts.float() - acts_p.float()).abs().max().item(),
                                       (deltas.float() - deltas_p.float()).abs().max().item(),
                                       (bsum - bsum_p).abs().max().item())}

        def run_fwd_bwd(mode, target, loss_type):
            """fwd_bwd kernel and plain twin on the same inputs: (kernel loss
            sums, bias sums, {differences}, plain twin's outputs)."""
            F._launch_fwd_bwd(layout, params, table, 0, B, target, mode, inv_n, sc)
            plain = F.fwd_bwd_plain(layout, params, x, target, loss_type)
            torch.cuda.synchronize()
            lsum = sc.loss_part.view(nblk, 2).sum(0)
            bsum = sc.bias_part.view(nblk, nbp).sum(0)
            r = compare(sc.acts, sc.deltas, bsum, *plain[:3])
            if loss_type is not None:
                r["loss_diff_per_elem"] = abs(lsum[0].item() - plain[3].item()) / (B * 3)
                r["sq_diff_per_elem"] = abs(lsum[1].item() - plain[4].item()) / (B * 3)
                r["loss_rel"] = abs(lsum[0].item() / plain[3].item() - 1)
            return lsum, bsum, r, plain

        # The path's mode (L1) on the leg's trained weights: the loss sums may
        # differ per element by the prediction noise (LOSS_ELEM_TOL), the
        # activations as the forward kernel's. Deltas are reported only: the
        # L1 seed sign(p - gt) flips for rows whose prediction is within
        # rounding noise of the target, so near convergence whole rows differ.
        _, _, fb, _ = run_fwd_bwd(mode, gt, "L1")
        check(fb["loss_diff_per_elem"] <= LOSS_ELEM_TOL and fb["sq_diff_per_elem"] <= LOSS_ELEM_TOL
              and fb["act_norm_rel"] <= ACT_TOL, f"{leg}: fwd_bwd (L1) disagrees {fb}")
        # The delta walk on a continuous seed (cotangent mode: the same
        # kernel code past the seed), against the plain twin; the baseline
        # ("self", reported) is the same twin run on the CPU against itself
        # on the card: the same arithmetic summed in another order.
        cot = torch.randn(B, 3, generator=torch.Generator(device="cuda").manual_seed(1),
                          device="cuda")
        lsum, bsum, fbc, plain = run_fwd_bwd(F.COTANGENT_MODE, cot, None)
        on_cpu = F.fwd_bwd_plain(layout, params.cpu(), x.cpu(), cot.cpu(), None)
        fbc["self"] = compare(*(t.to(params.device) for t in on_cpu[:3]), *plain[:3])
        check(fbc["act_norm_rel"] <= ACT_TOL and fbc["delta_norm_rel"] <= DELTA_TOL
              and fbc["bias_sum_norm_rel"] <= BIAS_TOL,
              f"{leg}: fwd_bwd (cotangent) disagrees with its plain twin {fbc}")
        fb["cotangent"] = fbc
        fb["max_abs_err"] = max(fb["max_abs_err"], fbc["max_abs_err"])

        # wgrad vs wgrad_plain, both on the kernel's fwd_bwd outputs
        grads, sums = torch.empty(layout.n, device="cuda"), torch.empty(2, device="cuda")
        F._launch_wgrad(layout, table, 0, B, sc, grads, sums)
        want = F.wgrad_plain(layout, x, sc.acts, sc.deltas, bsum)
        torch.cuda.synchronize()
        mx, nr, ab = _per_tensor(layout, grads, want)
        wg = {"max_rel": mx, "norm_rel": nr, "max_abs_err": ab,
              "sums_equal": torch.equal(sums, lsum), "launch": F.last_wgrad_launch(),
              "bit_equal_across_launches": _wgrad_again_bit_equal(F, layout, table, B, sc, grads,
                                                                  sums)}
        check(mx <= WGRAD_TOL, f"{leg}: wgrad disagrees with its plain twin {wg}")
        check(wg["bit_equal_across_launches"], f"{leg}: two wgrad launches differ")
        check_wgrad_launch(wg["launch"], wgrad_tiles(layout), B, f"{leg}: wgrad")
        wa = _wgrad_adam_check(F, layout, table, x, B, sc, grads, sums, bsum, params)
        check(wa["bit_equal"], f"{leg}: wgrad_adam differs from the Adam twin on its gradients")
        check_wgrad_launch(wa["launch"], wgrad_tiles(layout), B, f"{leg}: wgrad_adam")

        # the two together vs the whole plain twin: L1 (reported) and the
        # forward's VJP (gated), the backward of fused_apply_trainable
        g_k, l_k, s_k = F.fused_train_grads(layout, params, table, gt, 0, B, "L1")
        g_p, l_p, s_p = F.train_grads_plain(layout, params, x, gt, "L1")
        mx, nr, ab = _per_tensor(layout, g_k, g_p)
        e2e = {"l1_max_rel": mx, "l1_norm_rel": nr}
        xf = x.float().contiguous()
        pk = params.clone().requires_grad_()
        (F.fused_apply_trainable(layout, pk, xf) * cot).sum().backward()
        vjp_plain = F.apply_vjp_plain(layout, params, xf, cot)
        mx, nr, ab = _per_tensor(layout, pk.grad, vjp_plain)
        smx, snr, _ = _per_tensor(layout, F.apply_vjp_plain(layout, params.cpu(), xf.cpu(),
                                                            cot.cpu()).to(params.device),
                                  vjp_plain)
        e2e.update({"vjp_max_rel": mx, "vjp_norm_rel": nr, "vjp_max_abs_err": ab,
                    "self_vjp_max_rel": smx, "self_vjp_norm_rel": snr})
        check(mx <= GRAD_MAX_REL and nr <= E2E_NORM_TOL,
              f"{leg}: train grads disagree with the plain twin {e2e}")

        # Adam: bit-equal to its twin (-fmad=false)
        hyper = F.adam_hyper_rows(torch.tensor([1000]), 1e-4, device="cuda")[0]
        want_p, want_m, want_v = F.adam_apply_plain(params, mu, nu, hyper, g_k)
        p2, m2, v2 = params.clone(), mu.clone(), nu.clone()
        F.fused_adam_apply(p2, m2, v2, hyper, g_k)
        torch.cuda.synchronize()
        ad = {"max_abs_err": max((p2 - want_p).abs().max().item(), (m2 - want_m).abs().max().item(),
                                 (v2 - want_v).abs().max().item()),
              "bit_equal": all(torch.equal(a, b) for a, b in
                               ((p2, want_p), (m2, want_m), (v2, want_v)))}
        ulp = max(((a.view(torch.int32) - b.view(torch.int32)).abs().max().item())
                  for a, b in ((p2, want_p), (m2, want_m), (v2, want_v)))
        check(ulp <= 1, f"{leg}: Adam differs from its twin by {ulp} ulp")
        # with the bf16 weight copy (what the train step runs): the same f32
        # results, and the copy equals the twin's new params rounded to bf16
        wb = torch.empty_like(params, dtype=torch.bfloat16)
        p3, m3, v3 = params.clone(), mu.clone(), nu.clone()
        F.fused_adam_apply(p3, m3, v3, hyper, g_k, wb)
        torch.cuda.synchronize()
        ad["bf16_copy_bit_equal"] = (torch.equal(wb, want_p.to(torch.bfloat16)) and all(
            torch.equal(a, b) for a, b in ((p3, p2), (m3, m2), (v3, v2))))
        check(ad["bf16_copy_bit_equal"], f"{leg}: Adam's bf16 copy differs from its twin's")

        # autograd backward of fused_apply vs torch.autograd of the plain forward
        pp = params.clone().requires_grad_()
        fw_diff = F.FusedWeights(spec, None, None, [F._bf16(m) for m in layout.mats(pp)],
                                 layout.biases(pp), layout)
        (F.fused_apply_plain(fw_diff, xf) * cot).sum().backward()
        mx, nr, ab = _per_tensor(layout, pk.grad, pp.grad)
        vjp = {"max_rel": mx, "norm_rel": nr, "max_abs_err": ab}
        check(nr <= VJP_NORM_TOL, f"{leg}: fused_apply backward vs autograd {vjp}")
        # its time: the train kernels on the f32 batch from the cotangent, as
        # the autograd backward runs them (scratch and bf16 weight copy made
        # per call)
        g_v = torch.empty(layout.n, device="cuda")
        vjp["ms"] = cuda_ms(lambda: F._train_kernels(layout, params, xf, 0, B, cot,
                                                     F.COTANGENT_MODE, None, g_v))

        # times: CUDA events; plain twins on the same tensors; library calls
        x_bytes = table.element_size()
        bounds = _train_bounds(layout, B, x_bytes)
        fb["ms"] = cuda_ms(lambda: F._launch_fwd_bwd(layout, params, table, 0, B, gt, mode,
                                                     inv_n, sc))
        fb["launch"] = F.last_fwd_bwd_launch()  # the shape the timed launches ran with
        if leg == "hq_train":  # the cited time is the HQ recipe's shape (k=512)
            fb["cited_ms_before_redesign"] = CITED_BEFORE_REDESIGN["fused_mlp_fwd_bwd"]
        fb["plain_ms"] = cuda_ms(lambda: F.fwd_bwd_plain(layout, params, x, gt, "L1"))
        fb["library_ms"] = None  # no single PyTorch call computes forward+loss+deltas
        check(fb["launch"]["ctas"] == 2 * nblk and fb["launch"]["cluster"] == 2,
              f"{leg}: fwd_bwd does not launch 2-CTA clusters per 64 rows: {fb['launch']}")
        wg["ms"] = cuda_ms(lambda: F._launch_wgrad(layout, table, 0, B, sc, grads, sums))
        if leg == "hq_train":
            wg["cited_ms_before_redesign"] = CITED_BEFORE_REDESIGN["fused_mlp_wgrad"]
        wg["plain_ms"] = cuda_ms(lambda: F.wgrad_plain(layout, x, sc.acts, sc.deltas, bsum))
        A = sc.acts.view(L - 1, B, H)
        D = sc.deltas[:(L - 1) * B * H].view(L - 1, B, H)
        Dout = sc.deltas[(L - 1) * B * H:].view(B, F.OUT_PAD)
        xl = x.to(torch.bfloat16)  # an f32 table's rows as the kernel rounds them
        pairs = [(xl if i == 0 else A[i - 1], D[i]) for i in range(L - 1)]
        pairs += [(xl, D[spec.skip_idx]), (A[L - 2], Dout)]

        def wgrad_library():  # torch.matmul per weight matrix, bf16 in, f32 accumulate
            for a, d in pairs:
                torch.matmul(a.t(), d)
        wg["library_ms"] = cuda_ms(wgrad_library)
        ad["ms"] = cuda_ms(lambda: F.fused_adam_apply(p3, m3, v3, hyper, g_k, wb))
        ad["ms_without_copy"] = cuda_ms(lambda: F.fused_adam_apply(p2, m2, v2, hyper, g_k))
        ad["plain_ms"] = cuda_ms(lambda: F.adam_apply_plain(p2, m2, v2, hyper, g_k))
        p_lib = torch.nn.Parameter(params.clone())
        p_lib.grad = g_k.clone()
        opt = torch.optim.Adam([p_lib], lr=1e-4, fused=True)
        ad["library_ms"] = cuda_ms(opt.step)
        if leg == "hq_train":
            ad["cited_ms_before_redesign"] = CITED_BEFORE_REDESIGN["fused_adam"]
            wa["cited_ms_before_redesign"] = CITED_BEFORE_REDESIGN["fused_mlp_wgrad_adam"]
        for name, r in (("fused_mlp_fwd_bwd", fb), ("fused_mlp_wgrad", wg), ("fused_adam", ad),
                        ("fused_mlp_wgrad_adam", wa)):
            r["bound_ms"], r["bound_by"] = bounds[name]
            if name != "fused_adam":
                r["fused_step_bound_ms"] = bounds["fused_step"][0]
            emit("kernel_check", name=name, leg=leg, k=spec.k_in, B=B, **r)
        emit("train_grads_check", leg=leg, k=spec.k_in, B=B, **e2e)
        emit("apply_vjp_check", leg=leg, k=spec.k_in, B=B, tol_norm=VJP_NORM_TOL, **vjp)
        rows[leg] = {"fused_mlp_fwd_bwd": fb, "fused_mlp_wgrad": wg, "fused_adam": ad,
                     "fused_mlp_wgrad_adam": wa}
    return rows


def _vd_train_config(p, out_name, epochs):
    """configs/synthetic/viewdep_intrinsic_blob.yaml on the HQ leg's ray
    caches: its model and training sections (the HQ recipe's, plus the
    view_dependence section) with fused_mlp: true and a bf16 table, cut to
    `epochs` epochs, checkpoints every 3 epochs, no vis views."""
    config = _hq_train_config(p, out_name, epochs)
    config["model"]["view_dependence"] = dict(VIEWDEP)
    return config


def _render_vs_plain(r_kernel, r_plain, views):
    """Min over views of the kernel-vs-plain render PSNR on the hit pixels;
    the hit masks must be equal. A view with distortion_params renders
    through its undistorted coordinates."""
    from intrinsic_neural_fields_tpu_torch.evaluation.metrics import psnr

    H, W = r_kernel.H, r_kernel.W
    out = []
    for v in views:
        kw = {"eval_render": True, "distortion_coeffs": v.get("distortion_params"),
              "distortion_type": v.get("distortion_type")}
        img_k, hit_k = r_kernel.render(v["camCv2world"], v["K"], **kw)
        img_p, hit_p = r_plain.render(v["camCv2world"], v["K"], **kw)
        check(np.array_equal(hit_k, hit_p), "kernel and plain renders disagree on the valid mask")
        check(np.isfinite(img_k).all() and img_k.shape == (H, W, 3), "bad kernel render")
        mask = np.zeros(H * W, bool)
        mask[hit_k] = True
        out.append(psnr(img_k, img_p, mask))
    return min(out)


def phase_viewdep_train(p):
    """The view-dependent field through the port's
    Trainer on the tail kernels, resume, and its eval through the
    view-dependent forward kernel before and after, held to the plain twin."""
    import shutil

    import torch

    from intrinsic_neural_fields_tpu_torch.evaluation.eval_cli import evaluate_views
    from intrinsic_neural_fields_tpu_torch.geometry.mesh import load_mesh
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (kernel_launches,
                                                                 reset_kernel_launches)
    from intrinsic_neural_fields_tpu_torch.render.renderer import Renderer
    from intrinsic_neural_fields_tpu_torch.spectral.features import load_first_k_eigenfunctions
    from intrinsic_neural_fields_tpu_torch.train import (Trainer, get_data, get_model_and_optim,
                                                         get_renderer)
    from intrinsic_neural_fields_tpu_torch.train.steps import eager_step

    root = p["root"]
    config = _vd_train_config(p, "vd_out", 5)
    mesh = load_mesh(config["data"]["mesh_path"])
    model, optimizer = get_model_and_optim(config, mesh)
    renderer = get_renderer(config, model, mesh)
    efuncs = load_first_k_eigenfunctions(config["data"]["eigenfunctions_path"], 512)
    r_plain = Renderer(model, mesh, efuncs, H=renderer.H, W=renderer.W,
                       feature_dtype="bfloat16", infer="plain")
    check(renderer.viewdep and renderer.infer_mode == "kernel", "not a view-dependent kernel renderer")
    t0 = time.perf_counter()
    data = get_data(config, mesh)
    val_views = _dataset_views(p, "val")
    setup_s = time.perf_counter() - t0
    check(data["train"].unit_ray_dirs is not None, "the ray caches carry no ray directions")
    before, _ = evaluate_views(None, config, val_views, renderer=renderer)
    psnr_kp_before = _render_vs_plain(renderer, r_plain, val_views)

    # the path: counters to 0 just before, read just after
    rec = Recorder()
    trainer = Trainer(model, optimizer, "L1", renderer, data, mesh, config, writer=rec)
    check(trainer.train_data.hit_vencs is not None
          and trainer.train_data.hit_vencs.dtype == torch.bfloat16, "no bf16 hit_vencs table")
    reset_kernel_launches()
    eager_step.launches = 0
    t1 = time.perf_counter()
    trainer.train()
    renderer.update_variables(trainer.state.state_dict())
    after, _ = evaluate_views(None, config, val_views, renderer=renderer)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t1
    launches, eager = kernel_launches(), eager_step.launches

    nb = data["train"].n // 4096
    check(launches["fused_mlp_fwd_bwd_viewdep"] == launches["fused_mlp_wgrad_adam_viewdep"]
          == 5 * nb, f"not one of each tail kernel per step: {launches}")
    check(launches["fused_mlp_fwd_viewdep"] > 0, f"the eval did not launch the forward: {launches}")
    check(not any(launches[k] for k in launches if k not in (
        "fused_mlp_fwd_bwd_viewdep", "fused_mlp_wgrad_adam_viewdep", "fused_mlp_fwd_viewdep",
        "raster_traverse", "raster_bin", "render_wire")),
          f"other kernels ran on this path: {launches}")
    graph = _graph_stats(trainer, launches, 5 * nb, 5, ("fused_mlp_fwd_bwd_viewdep",
                                                          "fused_mlp_wgrad_adam_viewdep"))
    check(graph["kernels_per_step"] == 2 and graph["host_dispatches_per_epoch"] == 1
          and graph["graph_captures"] == 1, f"not one graph replay per epoch: {graph}")
    check(eager == 0, f"the eager step ran {eager} times on the view-dependent recipe")
    losses = rec.values("Train_Loss")
    check(len(losses) == 5 and losses[-1] < losses[0], f"train loss did not fall: {losses}")
    check(sorted({t for t, _, _ in rec.scalars}) == JAX_TRAINER_TAGS and not rec.images,
          f"tags differ from the JAX Trainer's: {sorted({t for t, _, _ in rec.scalars})}")
    check(all(torch.isfinite(t).all().item() for t in (trainer.state.params, trainer.state.mu,
                                                       trainer.state.nu)), "non-finite state")
    r_plain.update_variables(trainer.state.state_dict())
    psnr_kp_after = _render_vs_plain(renderer, r_plain, val_views)
    check(min(psnr_kp_before, psnr_kp_after) >= PSNR_MIN,
          f"kernel vs plain render PSNR {psnr_kp_before}, {psnr_kp_after} < {PSNR_MIN}")

    # resume from checkpoint.pt (epoch 3) for the last epoch: bit-equal
    shutil.copytree(config["training"]["out_dir"], os.path.join(root, "vd_resumed"))
    cfg_r = _vd_train_config(p, "vd_resumed", 5)
    model_r, opt_r = get_model_and_optim(cfg_r, mesh)
    resumed = Trainer(model_r, opt_r, "L1", renderer, data, mesh, cfg_r, writer=Recorder())
    resumed.train()
    for name in ("params", "mu", "nu"):
        check(torch.equal(getattr(resumed.state, name), getattr(trainer.state, name)),
              f"resumed {name} differs from the uninterrupted run")
    check(resumed.state.count == trainer.state.count == 5 * nb, "Adam counts differ")
    check(resumed.train_epoch_fn.graph.captures == 1, "the resumed run did not capture its graph")
    yard_launches, yard_cmp = _yardstick_equal(p, trainer, rec, _vd_train_config, "vd_yardstick",
                                               mesh, renderer, data, "_viewdep")

    rays = rec.values("Train Rays-per-sec")
    emit("viewdep_train", n_train=data["train"].n, steps_per_epoch=nb, setup_s=setup_s,
         path_s=path_s, epochs=5, venc_in=trainer.state.layout.tail.venc_in,
         venc_w=trainer.state.layout.tail.venc_w, n_params=trainer.state.layout.n,
         train_rays_per_s_best=max(rays), train_rays_per_s_median=float(np.median(rays)),
         cited_train_rays_per_s_best_before_redesign=CITED_BEFORE_REDESIGN["viewdep_train"],
         train_loss=losses, val_psnr=rec.values("Val Epoch-PSNR"),
         test_loss=rec.values("Test Loss"), psnr_before=before["psnr"],
         dssim_before=before["dssim_rescaled"], psnr_after=after["psnr"],
         dssim_after=after["dssim_rescaled"], psnr_kernel_vs_plain_before=psnr_kp_before,
         psnr_kernel_vs_plain_after=psnr_kp_after, launches=launches, eager_steps=eager,
         resumed_bit_equal=True, **graph, step_wall_ms_best=4096e3 / max(rays),
         fused_adam_false_launches=yard_launches, fused_adam_false_bit_equal=yard_cmp)
    return launches, yard_launches, (renderer, val_views), train_leg_of(trainer, nb, 4096)


def _vd_check_train(F, layout, params, table, vtable, gt, B, leg):
    """fwd_bwd_viewdep and wgrad_viewdep against their plain twins on block
    0 of the leg's tables, in the path's mode (L1) and on a continuous
    cotangent seed; returns the rows and the scratch for the timings."""
    import torch

    spec = layout.spec
    nh, H = len(layout.layers), spec.hidden
    nblk, nbp = -(-B // F.BLOCK_ROWS), H * nh + F.OUT_PAD
    sc = F.make_train_scratch(layout, B, params)
    x, v = table[:B], vtable[:B]
    inv_n = 1.0 / (B * 3)

    def norm_rel(a, b):
        a, b = a.float().view(a.shape[0], -1), b.float().view(b.shape[0], -1)
        return ((a - b).norm(dim=1) / b.norm(dim=1).clamp_min(1e-30)).max().item()

    def run(mode, target, loss_type):
        F._launch_fwd_bwd(layout, params, table, 0, B, target, mode, inv_n, sc, vtable)
        acts_p, deltas_p, bsum_p, l_p, s_p = F.fwd_bwd_viewdep_plain(layout, params, x, v, target,
                                                                     loss_type)
        torch.cuda.synchronize()
        lsum = sc.loss_part.view(nblk, 2).sum(0)
        bsum = sc.bias_part.view(nblk, nbp).sum(0)
        HB = B * H
        r = {"act_norm_rel": norm_rel(sc.acts.view(nh, HB), acts_p.view(nh, HB)),
             "act_mismatch_share": (sc.acts != acts_p).float().mean().item(),
             "delta_norm_rel": max(norm_rel(sc.deltas[:nh * HB].view(nh, HB),
                                            deltas_p[:nh * HB].view(nh, HB)),
                                   norm_rel(sc.deltas[nh * HB:].view(1, -1),
                                            deltas_p[nh * HB:].view(1, -1))),
             "bias_sum_norm_rel": ((bsum - bsum_p).norm() / bsum_p.norm()).item(),
             "max_abs_err": max((sc.acts.float() - acts_p.float()).abs().max().item(),
                                (sc.deltas.float() - deltas_p.float()).abs().max().item(),
                                (bsum - bsum_p).abs().max().item())}
        if loss_type is not None:
            r["loss_diff_per_elem"] = abs(lsum[0].item() - l_p.item()) / (B * 3)
            r["sq_diff_per_elem"] = abs(lsum[1].item() - s_p.item()) / (B * 3)
        return lsum, bsum, r

    _, _, fb = run(F.LOSS_MODES["L1"], gt, "L1")
    check(fb["loss_diff_per_elem"] <= LOSS_ELEM_TOL and fb["sq_diff_per_elem"] <= LOSS_ELEM_TOL
          and fb["act_norm_rel"] <= ACT_TOL, f"{leg}: fwd_bwd_viewdep (L1) disagrees {fb}")
    cot = torch.randn(B, 3, generator=torch.Generator(device="cuda").manual_seed(1),
                      device="cuda")
    lsum, bsum, fbc = run(F.COTANGENT_MODE, cot, None)
    check(fbc["act_norm_rel"] <= ACT_TOL and fbc["delta_norm_rel"] <= DELTA_TOL
          and fbc["bias_sum_norm_rel"] <= BIAS_TOL,
          f"{leg}: fwd_bwd_viewdep (cotangent) disagrees with its plain twin {fbc}")
    fb["cotangent"] = fbc
    fb["max_abs_err"] = max(fb["max_abs_err"], fbc["max_abs_err"])

    grads, sums = torch.empty(layout.n, device="cuda"), torch.empty(2, device="cuda")
    F._launch_wgrad(layout, table, 0, B, sc, grads, sums, vtable)
    want = F.wgrad_viewdep_plain(layout, x, v, sc.acts, sc.deltas, bsum)
    torch.cuda.synchronize()
    mx, nr, ab = _per_tensor(layout, grads, want)
    wg = {"max_rel": mx, "norm_rel": nr, "max_abs_err": ab, "sums_equal": torch.equal(sums, lsum),
          "launch": F.last_wgrad_launch(),
          "bit_equal_across_launches": _wgrad_again_bit_equal(F, layout, table, B, sc, grads, sums,
                                                              vtable)}
    check(mx <= WGRAD_TOL, f"{leg}: wgrad_viewdep disagrees with its plain twin {wg}")
    check(wg["bit_equal_across_launches"], f"{leg}: two wgrad_viewdep launches differ")
    check_wgrad_launch(wg["launch"], 16, B, f"{leg}: wgrad_viewdep")
    wa = _wgrad_adam_check(F, layout, table, x, B, sc, grads, sums, bsum, params, vtable, v)
    check(wa["bit_equal"], f"{leg}: wgrad_adam_viewdep differs from the Adam twin on its "
          "gradients")
    check_wgrad_launch(wa["launch"], 16, B, f"{leg}: wgrad_adam_viewdep")

    # the whole tail backward on the cotangent seed vs the whole twin
    g_k = torch.empty(layout.n, device="cuda")
    F._train_kernels(layout, params, table, 0, B, cot, F.COTANGENT_MODE, None, g_k, vtable)
    g_p = F.train_grads_plain(layout, params, x, cot, None, v)[0]
    torch.cuda.synchronize()
    mx, nr, ab = _per_tensor(layout, g_k, g_p)
    e2e = {"vjp_max_rel": mx, "vjp_norm_rel": nr, "vjp_max_abs_err": ab}
    check(mx <= GRAD_MAX_REL and nr <= E2E_NORM_TOL,
          f"{leg}: tail train grads disagree with the plain twin {e2e}")
    g_l1, _, _ = F.fused_train_grads(layout, params, table, gt, 0, B, "L1", vencs=vtable)
    return fb, wg, wa, e2e, sc, grads, sums, bsum, g_l1


def phase_viewdep_kernels(vd_leg, vd_render):
    """Each tail kernel against its plain twin on the batches the
    view-dependent leg feeds it, plus one extrinsic batch; Adam on the
    view-dependent buffer; CUDA-event times beside bounds."""
    import torch

    from intrinsic_neural_fields_tpu_torch.models import make_model, view_encoder_apply
    from intrinsic_neural_fields_tpu_torch.ops import fused_mlp as F
    from intrinsic_neural_fields_tpu_torch.ops.interpolate import interpolate_vertex_features

    layout, data = vd_leg.state.layout, vd_leg.data
    params, mu, nu = (t.clone() for t in (vd_leg.state.params, vd_leg.state.mu, vd_leg.state.nu))
    table, vtable = data.hit_features, data.hit_vencs
    gt_table, dirs = data.expected_rgbs, data.unit_ray_dirs
    renderer, views = vd_render
    B = 4096
    gt = gt_table[:B].contiguous()
    rows = {}

    # forward: the renderer's 8192-ray chunks of hit rays and a ragged B
    fw = renderer.weights
    xs, vs, n = [], [], 0
    for v in views:
        t = renderer.trace_view(v["camCv2world"], v["K"])
        xs.append(interpolate_vertex_features(renderer.features, t.vids[t.valid], t.bary[t.valid]))
        vs.append(renderer.field.view_fn(t.dirs[t.valid], t.face_idxs[t.valid]))
        n += xs[-1].shape[0]
    check(n >= 8192, f"only {n} hit rays in the val views")
    X, V = torch.cat(xs), torch.cat(vs)
    fwd_rows = []
    for Bf in (8192, 1000):
        x, v = X[:Bf].contiguous(), V[:Bf].contiguous()
        got = F.fused_apply_viewdep(fw, x, v)
        torch.cuda.synchronize()
        want = F.fused_apply_viewdep_plain(fw, x, v)
        check(torch.isfinite(got).all().item(), "non-finite view-dependent forward")
        bound, bound_by = mlp_bound_ms(fw, Bf)
        r = {"B": Bf, "venc_in": layout.tail.venc_in,
             "max_abs_err": (got - want).abs().max().item(),
             "mean_abs_err": (got - want).abs().mean().item(),
             "ms": cuda_ms(lambda: F.fused_apply_viewdep(fw, x, v)),
             "launch": F.last_fwd_launch(),
             "plain_ms": cuda_ms(lambda: F.fused_apply_viewdep_plain(fw, x, v)),
             "bound_ms": bound, "bound_by": bound_by, "library_ms": None}
        emit("kernel_check", name="fused_mlp_fwd_viewdep", leg="viewdep_eval", k=512,
             tol=TOL_VD, mean_tol=MEAN_TOL_VD, **r)
        check(r["max_abs_err"] <= TOL_VD and r["mean_abs_err"] <= MEAN_TOL_VD,
              f"fused_mlp_fwd_viewdep disagrees: {r}")
        check_fwd_launch(r["launch"], 512, Bf, "fused_mlp_fwd_viewdep")
        if Bf == 8192:
            r["cited_ms_before_redesign"] = CITED_BEFORE_REDESIGN["fused_mlp_fwd_viewdep"]
        fwd_rows.append(r)
    rows["fused_mlp_fwd_viewdep"] = fwd_rows[0]
    rows["fused_mlp_fwd_viewdep"]["max_abs_err"] = max(r["max_abs_err"] for r in fwd_rows)

    # train kernels on the leg's tables (bf16, block 0, B=4096), trained weights
    fb, wg, wa, e2e, sc, grads, sums, bsum, g_l1 = _vd_check_train(
        F, layout, params, table, vtable, gt, B, "viewdep_train")
    emit("train_grads_check", leg="viewdep_train", k=512, B=B, **e2e)

    # one extrinsic batch (27 view lanes): a seeded extrinsic field, the
    # same feature rows, the rows' own ray directions encoded extrinsically
    cfg_x = {"k": 512, **HQ, "view_dependence": dict(VIEWDEP, in_dim_view_dir=3,
                                                     strategy="extrinsic")}
    model_x = make_model(cfg_x, seed=3)
    lay_x = F.layout_for_model(model_x)
    p_x = lay_x.flat_from_state_dict(model_x.state_dict())
    venc_x = view_encoder_apply(model_x)(dirs[:2 * B], None)
    vt_x = torch.zeros(2 * B, lay_x.tail.venc_w, device="cuda", dtype=table.dtype)
    vt_x[:, :lay_x.tail.venc_in] = venc_x.to(table.dtype)
    fbx, wgx, wax, e2ex, _, _, _, _, _ = _vd_check_train(
        F, lay_x, p_x, table[:2 * B].contiguous(), vt_x, gt, B, "extrinsic")
    fw_x = lay_x.pack(p_x)
    xf = table[:B].float().contiguous()
    vx = venc_x[:B].contiguous()
    got = F.fused_apply_viewdep(fw_x, xf, vx)
    torch.cuda.synchronize()
    err_x = (got - F.fused_apply_viewdep_plain(fw_x, xf, vx)).abs().max().item()
    check(err_x <= TOL_VD, f"extrinsic fused_mlp_fwd_viewdep disagrees: {err_x}")
    emit("extrinsic_check", venc_in=lay_x.tail.venc_in, fwd_max_abs_err=err_x,
         fwd_bwd=fbx, wgrad=wgx, wgrad_adam=wax, grads=e2ex)

    # Adam on the view-dependent buffer: bit-equal to its twin (-fmad=false)
    hyper = F.adam_hyper_rows(torch.tensor([1000]), 1e-4, device="cuda")[0]
    want_p, want_m, want_v = F.adam_apply_plain(params, mu, nu, hyper, g_l1)
    p2, m2, v2 = params.clone(), mu.clone(), nu.clone()
    F.fused_adam_apply(p2, m2, v2, hyper, g_l1)
    torch.cuda.synchronize()
    ad = {"n": layout.n,
          "max_abs_err": max((p2 - want_p).abs().max().item(), (m2 - want_m).abs().max().item(),
                             (v2 - want_v).abs().max().item()),
          "bit_equal": all(torch.equal(a, b) for a, b in
                           ((p2, want_p), (m2, want_m), (v2, want_v)))}
    check(ad["bit_equal"], f"Adam on the view-dependent buffer differs from its twin: {ad}")

    # times: CUDA events; plain twins on the same tensors; library calls
    x, v = table[:B], vtable[:B]
    bounds = _train_bounds(layout, B, table.element_size())
    mode, inv_n = F.LOSS_MODES["L1"], 1.0 / (B * 3)
    fb["ms"] = cuda_ms(lambda: F._launch_fwd_bwd(layout, params, table, 0, B, gt, mode, inv_n, sc,
                                                 vtable))
    fb["launch"] = F.last_fwd_bwd_launch()  # the shape the timed launches ran with
    fb["cited_ms_before_redesign"] = CITED_BEFORE_REDESIGN["fused_mlp_fwd_bwd_viewdep"]
    fb["plain_ms"] = cuda_ms(lambda: F.fwd_bwd_viewdep_plain(layout, params, x, v, gt, "L1"))
    fb["library_ms"] = None  # no single PyTorch call computes forward+loss+deltas
    check(fb["launch"]["ctas"] == 128 and fb["launch"]["cluster"] == 2,
          f"fwd_bwd_viewdep does not launch 2-CTA clusters per 64 rows: {fb['launch']}")
    wg["ms"] = cuda_ms(lambda: F._launch_wgrad(layout, table, 0, B, sc, grads, sums, vtable))
    wg["cited_ms_before_redesign"] = CITED_BEFORE_REDESIGN["fused_mlp_wgrad_viewdep"]
    wg["plain_ms"] = cuda_ms(lambda: F.wgrad_viewdep_plain(layout, x, v, sc.acts, sc.deltas, bsum))
    nh, H = len(layout.layers), layout.spec.hidden
    A = sc.acts.view(nh, B, H)
    D = sc.deltas[:nh * B * H].view(nh, B, H)
    Dout = sc.deltas[nh * B * H:].view(B, F.OUT_PAD)
    pairs = []
    for i, lay in enumerate(layout.layers):
        if lay.h is not None:
            pairs.append((A[i - 1], D[i]))
        if lay.ext is not None:
            pairs.append((x if lay.ext[3] == "x" else v, D[i]))
    pairs.append((A[nh - 1], Dout))

    def wgrad_library():  # torch.matmul per weight matrix, bf16 in, f32 accumulate
        for a, d in pairs:
            torch.matmul(a.t(), d)
    wg["library_ms"] = cuda_ms(wgrad_library)
    ad["ms"] = cuda_ms(lambda: F.fused_adam_apply(p2, m2, v2, hyper, g_l1))
    ad["plain_ms"] = cuda_ms(lambda: F.adam_apply_plain(p2, m2, v2, hyper, g_l1))
    p_lib = torch.nn.Parameter(params.clone())
    p_lib.grad = g_l1.clone()
    opt = torch.optim.Adam([p_lib], lr=1e-4, fused=True)
    ad["library_ms"] = cuda_ms(opt.step)
    wa["cited_ms_before_redesign"] = CITED_BEFORE_REDESIGN["fused_mlp_wgrad_adam_viewdep"]
    for name, r in (("fused_mlp_fwd_bwd", fb), ("fused_mlp_wgrad", wg), ("fused_adam", ad),
                    ("fused_mlp_wgrad_adam", wa)):
        r["bound_ms"], r["bound_by"] = bounds[name]
        if name != "fused_adam":
            r["fused_step_bound_ms"] = bounds["fused_step"][0]
    for name, r in (("fused_mlp_fwd_bwd_viewdep", fb), ("fused_mlp_wgrad_viewdep", wg),
                    ("fused_adam", ad), ("fused_mlp_wgrad_adam_viewdep", wa)):
        emit("kernel_check", name=name, leg="viewdep_train", k=512, B=B, **r)
    rows.update({"fused_mlp_fwd_bwd_viewdep": fb, "fused_mlp_wgrad_viewdep": wg,
                 "fused_adam": ad, "fused_mlp_wgrad_adam_viewdep": wa})
    rows["extrinsic"] = {"fused_mlp_fwd_viewdep": err_x, "fused_mlp_fwd_bwd_viewdep":
                         fbx["max_abs_err"], "fused_mlp_wgrad_viewdep": wgx["max_abs_err"],
                         "fused_mlp_wgrad_adam_viewdep": wax["max_abs_err"]}
    return rows


# ----------------------------------------------------------------------------
# What users do with a trained field (the HQ leg's 5-epoch model.pt, k=512,
# 6x128 skip 3): Meshroom renders and training, LPIPS, texture transfer,
# baking, the turntable video and single views, each through the port's
# `-m` entry points (main(argv) in process), the forward kernel's launches
# counted per path.

MESHROOM_COEFFS = [0.05, -0.02, 0.01]
# The smoke's transfer target basis: 512 non-constant functions, cut from
# the experiment's 1024 (scripts/run_transfer.sh) to keep the coarse
# target's shift-invert solve to seconds; the full-length experiment
# (tools/port_transfer_experiment.py) solves 1024.
SMOKE_K_BASIS = 512
BAKE_SIZE = 1024
FWD_CHUNK = 8192   # rays / texels per forward launch (renderer and bake)


def _write_meshroom_split(p, out_dir, split, src_split, coeffs):
    """A Meshroom-layout copy of the HQ dataset's `src_split` views as
    `split`: <split>_data.json (the shared K, the radial-k3 coefficients,
    4x4 cam2world per view), the PNGs and .npy object masks. The images are
    the pinhole ground truth, so a distorted split's PSNR measures the
    pipeline, not the field's quality."""
    import shutil

    from intrinsic_neural_fields_tpu_torch.data.datasets import read_split_list
    from intrinsic_neural_fields_tpu_torch.utils.io import imread, load_cameras

    os.makedirs(out_dir, exist_ok=True)
    views = []
    for i, v in enumerate(read_split_list(p["data"], src_split)):
        vp = os.path.join(p["data"], v)
        cam, K = load_cameras(vp)
        shutil.copy(os.path.join(vp, "image", "000.png"), os.path.join(out_dir, f"{split}{i}.png"))
        np.save(os.path.join(out_dir, f"{split}{i}_mask.npy"),
                imread(os.path.join(vp, "depth", "mask.png")) != 0)
        cam44 = np.eye(4)
        cam44[:3] = np.asarray(cam)[:3, :4]
        views.append({"view_file": f"{split}{i}.png", "obj_mask_file": f"{split}{i}_mask.npy",
                      "cam2world": cam44.tolist()})
    with open(os.path.join(out_dir, f"{split}_data.json"), "w") as f:
        json.dump({"K": np.asarray(K)[:3, :3].tolist(), "distortion_params": coeffs,
                   "views": views}, f)


def _write_config(root, name, config):
    import yaml

    path = os.path.join(root, name)
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


def phase_meshroom(p):
    """The Meshroom (radial-k3) path: renders of a distorted split through
    the kernel and the plain twin, a zero-coefficient split against the
    pinhole renders, preprocessing, 2 epochs of training with the Meshroom
    vis renders, and the eval CLI on the split."""
    import torch

    from intrinsic_neural_fields_tpu_torch import eval as eval_cli
    from intrinsic_neural_fields_tpu_torch import preprocess_dataset
    from intrinsic_neural_fields_tpu_torch.data.datasets import MeshroomRadialK3Dataset
    from intrinsic_neural_fields_tpu_torch.evaluation.metrics import psnr
    from intrinsic_neural_fields_tpu_torch.geometry.mesh import load_mesh
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (kernel_launches,
                                                                 reset_kernel_launches)
    from intrinsic_neural_fields_tpu_torch.render.renderer import make_renderer_from_config
    from intrinsic_neural_fields_tpu_torch.train import (Trainer, get_data, get_model_and_optim,
                                                         get_renderer)

    root = p["root"]
    mdir = os.path.join(root, "meshroom")
    for split, src in (("train", "train"), ("val", "val"), ("test", "test")):
        _write_meshroom_split(p, mdir, split, src, MESHROOM_COEFFS)
    _write_meshroom_split(p, mdir, "zero", "test", [0.0, 0.0, 0.0])
    config = _hq_train_config(p, "out", 5)  # the HQ leg's trained model.pt
    H, W = 256, 256
    views = list(MeshroomRadialK3Dataset(mdir, "test", H=H, W=W))
    r_kernel = make_renderer_from_config(config)
    r_plain = make_renderer_from_config(config, infer="plain")
    psnr_kp = _render_vs_plain(r_kernel, r_plain, views)
    check(psnr_kp >= PSNR_MIN, f"Meshroom kernel vs plain render PSNR {psnr_kp} < {PSNR_MIN}")
    # zero coefficients: the undistorted grid is the pixel grid up to the
    # bisection's 1e-8, so the render is the pinhole render's
    zero_psnr = []
    for v in MeshroomRadialK3Dataset(mdir, "zero", H=H, W=W):
        img_z, hit_z = r_kernel.render(v["camCv2world"], v["K"], eval_render=True,
                                       distortion_coeffs=v["distortion_params"],
                                       distortion_type=v["distortion_type"])
        img_p, hit_p = r_kernel.render(v["camCv2world"], v["K"], eval_render=True)
        check(np.array_equal(hit_z, hit_p), "zero-coefficient and pinhole masks differ")
        mask = np.zeros(H * W, bool)
        mask[hit_p] = True
        zero_psnr.append(psnr(img_z, img_p, mask))
    check(min(zero_psnr) >= PSNR_MIN, f"zero-coefficient vs pinhole PSNR {min(zero_psnr)}")

    pre = os.path.join(root, "meshroom_pre")
    t0 = time.perf_counter()
    for split in ("train", "val"):
        preprocess_dataset.main([pre, p["mesh_path"], mdir, split, "--dataset_type",
                                 "meshroom_radial_k3"])
    prep_s = time.perf_counter() - t0
    cfg = _hq_train_config(p, "meshroom_out", 2)
    cfg["data"].update(type="meshroom_radial_k3", vis_dataset_path=mdir, vis_split="test",
                       preproc_data_path_train=os.path.join(pre, "train"),
                       preproc_data_path_eval=os.path.join(pre, "val"))
    del cfg["data"]["preproc_data_path_test"]
    cfg["training"]["render_every"] = 1
    mesh = load_mesh(p["mesh_path"])
    model, opt = get_model_and_optim(cfg, mesh)
    data = get_data(cfg, mesh)
    rec = Recorder()
    trainer = Trainer(model, opt, "L1", get_renderer(cfg, model, mesh), data, mesh, cfg,
                      writer=rec)
    reset_kernel_launches()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = kernel_launches()
    losses = rec.values("Train_Loss")
    check(len(losses) == 2 and losses[1] < losses[0], f"Meshroom train loss did not fall: {losses}")
    vis_tags = {f"meshroom_radial_k3_view_{i}_{s}" for i in range(len(views))
                for s in ("psnr", "dist")}
    tags = {t for t, _, _ in rec.scalars}
    check(vis_tags <= tags and all(np.isfinite(v) for t, v, _ in rec.scalars if t in vis_tags),
          f"the Meshroom vis scalars are missing or not finite: {sorted(tags)}")
    check(train_launches["fused_mlp_fwd"] > 0 and train_launches["fused_mlp_fwd_bwd"] > 0,
          f"the Meshroom run did not launch the kernels: {train_launches}")

    cfg_path = _write_config(root, "meshroom_config.yaml", dict(config, data=dict(
        config["data"], type="meshroom_radial_k3")))
    out = os.path.join(root, "meshroom_eval")
    reset_kernel_launches()
    t0 = time.perf_counter()
    eval_cli.main([out, cfg_path, mdir, "test"])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = kernel_launches()["fused_mlp_fwd"]
    check(eval_launches > 0, "the Meshroom eval did not launch the forward kernel")
    import pickle

    with open(os.path.join(out, "evaluation_metrics.pkl"), "rb") as f:
        metrics = pickle.load(f)
    check(len(metrics) == len(views) and all(np.isfinite(m["psnr"]) for m in metrics.values()),
          f"bad Meshroom eval {metrics}")
    emit("meshroom", coeffs=MESHROOM_COEFFS, H=H, W=W, views=len(views),
         psnr_kernel_vs_plain_min=psnr_kp, zero_coeffs_vs_pinhole_psnr_min=min(zero_psnr),
         preprocess_s=prep_s, train_s=train_s, train_loss=losses,
         vis_psnr=[v for t, v, _ in rec.scalars if t.endswith("_psnr") and "meshroom" in t],
         eval_psnr=float(np.mean([m["psnr"] for m in metrics.values()])),
         eval_dssim_rescaled=float(np.mean([m["dssim_rescaled"] for m in metrics.values()])),
         eval_s=eval_s, eval_s_per_view=eval_s / len(views),
         train_launches=train_launches, eval_launches=eval_launches)
    return {"meshroom_train": train_launches["fused_mlp_fwd"], "meshroom_eval": eval_launches}


def _random_alexnet_npz(path, seed=0):
    """LPIPS weights of AlexNet's shapes, seeded random (no trained LPIPS
    weights exist in the repo)."""
    from intrinsic_neural_fields_tpu_torch.evaluation.lpips import ALEX_CFG

    rng = np.random.default_rng(seed)
    arrays, in_ch = {}, 3
    for i, (out_ch, k, _, _, _) in enumerate(ALEX_CFG):
        arrays[f"conv{i}_w"] = rng.normal(scale=0.05, size=(out_ch, in_ch, k, k)).astype(np.float32)
        arrays[f"conv{i}_b"] = rng.normal(scale=0.02, size=out_ch).astype(np.float32)
        arrays[f"lin{i}_w"] = np.abs(rng.normal(size=(1, out_ch, 1, 1))).astype(np.float32)
        in_ch = out_ch
    np.savez(path, **arrays)


def phase_lpips(p, hq_leg):
    """LPIPS on the HQ eval leg's (render, ground truth) pairs on the card
    and on the CPU, then the eval CLI's LPIPS column."""
    import pickle
    import tempfile

    import torch

    from intrinsic_neural_fields_tpu_torch import eval as eval_cli
    from intrinsic_neural_fields_tpu_torch.evaluation.lpips import LPIPS
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (kernel_launches,
                                                                 reset_kernel_launches)

    r, cams, K = hq_leg.renderer, hq_leg.cams, hq_leg.K
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lpips_alex.npz")
        _random_alexnet_npz(path)
        gpu, cpu = LPIPS(path), LPIPS(path, device="cpu")
        rel, gpu_ms = [], []
        for v in _gt_views(r, cams, K):
            fake = r.render(v["camCv2world"], v["K"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a = gpu(fake, v["img"])
            gpu_ms.append(1e3 * (time.perf_counter() - t0))
            b = cpu(fake, v["img"])
            check(np.isfinite(a) and b > 0, f"bad LPIPS {a}, {b}")
            rel.append(abs(a / b - 1))
        check(max(rel) <= 1e-4, f"LPIPS on the card vs the CPU: relative {max(rel)} > 1e-4")
        out = os.path.join(p["root"], "lpips_eval")
        reset_kernel_launches()
        eval_cli.main([out, os.path.join(p["root"], "hq_config.yaml"), p["data"], "test",
                       "--lpips_weights", path])
        torch.cuda.synchronize()
        launches = kernel_launches()["fused_mlp_fwd"]
    with open(os.path.join(out, "evaluation_metrics.pkl"), "rb") as f:
        metrics = pickle.load(f)
    col = [m["lpips_rescaled"] for m in metrics.values()]
    check(len(col) == 2 and all(np.isfinite(c) for c in col), f"LPIPS column not finite: {col}")
    emit("lpips", pairs=len(rel), size=[r.H, r.W], rel_card_vs_cpu_max=max(rel),
         card_ms_per_pair_median=float(np.median(gpu_ms)), eval_lpips_rescaled=col,
         eval_launches=launches)
    return {"lpips_eval": launches}


def phase_transfer(p):
    """make_transfer_targets (coarse) from the HQ leg's basis, identity
    self-transfer, and texture_transfer --eval_dataset onto the coarse
    target through the kernel and the plain twin."""
    import pickle

    import torch

    from intrinsic_neural_fields_tpu_torch import make_transfer_targets, texture_transfer
    from intrinsic_neural_fields_tpu_torch.evaluation.eval_cli import evaluate_views
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (kernel_launches,
                                                                 reset_kernel_launches)
    from intrinsic_neural_fields_tpu_torch.render.renderer import make_renderer_from_config

    root = p["root"]
    config = _hq_train_config(p, "out", 5)
    cfg_path = os.path.join(root, "hq_config.yaml")
    tdir = os.path.join(root, "transfer")
    t0 = time.perf_counter()
    make_transfer_targets.main(["--out_dir", tdir, "--src_dataset", p["data"], "--src_efuncs",
                                p["efuncs_path"], "--src_subdivisions", "5", "--targets",
                                "coarse", "--k_basis", str(SMOKE_K_BASIS)])
    targets_s = time.perf_counter() - t0
    src_full = os.path.join(tdir, "source_efuncs_full.npy")

    # identity self-transfer: the source mesh, its spliced basis both ways
    identity = os.path.join(tdir, "corr_identity.npy")
    np.save(identity, np.arange(p["mesh"].num_vertices))
    r_id = texture_transfer.build_transferred_renderer(config, p["mesh_path"], src_full,
                                                       src_full, identity)
    r_src = make_renderer_from_config(config)
    test_views = _dataset_views(p, "test")
    psnr_id = _render_vs_plain(r_id, r_src, test_views)
    check(psnr_id >= PSNR_MIN, f"identity self-transfer PSNR {psnr_id} < {PSNR_MIN}")

    args = [os.path.join(tdir, "coarse.obj"), src_full,
            os.path.join(tdir, "efuncs_full_coarse.npy"), os.path.join(tdir, "corr_coarse.npy")]
    out = os.path.join(root, "transfer_coarse")
    reset_kernel_launches()
    t0 = time.perf_counter()
    texture_transfer.main(["--config_path", cfg_path, "--target_mesh", args[0],
                           "--source_efuncs_full", args[1], "--target_efuncs_full", args[2],
                           "--correspondence", args[3], "--eval_dataset", p["data"],
                           "--eval_split", "test", "--out_dir", out])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = kernel_launches()["fused_mlp_fwd"]
    check(launches > 0, "the transfer eval did not launch the forward kernel")
    with open(os.path.join(out, "evaluation_metrics.pkl"), "rb") as f:
        metrics = pickle.load(f)
    r_k = texture_transfer.build_transferred_renderer(config, *args)
    r_p = texture_transfer.build_transferred_renderer(config, *args, infer="plain")
    psnr_kp = _render_vs_plain(r_k, r_p, test_views)
    check(psnr_kp >= PSNR_MIN, f"transfer kernel vs plain PSNR {psnr_kp} < {PSNR_MIN}")
    means, _ = evaluate_views(None, config, test_views, renderer=r_p)
    p["coarse_eval_psnr"] = float(np.mean([m["psnr"] for m in metrics.values()]))
    emit("transfer", target="coarse", target_vertices=int(np.load(args[3]).shape[0]),
         k_basis=SMOKE_K_BASIS, targets_s=targets_s, identity_psnr_vs_source=psnr_id,
         psnr_kernel_vs_plain_min=psnr_kp,
         eval_psnr=float(np.mean([m["psnr"] for m in metrics.values()])),
         eval_dssim_rescaled=float(np.mean([m["dssim_rescaled"] for m in metrics.values()])),
         eval_psnr_plain=means["psnr"], cli_s=cli_s, launches=launches)
    return {"transfer_eval": launches}


def _write_atlas_uv_mesh(path, mesh):
    """A UV-unwrapped copy of `mesh` as a per-face atlas: face f takes the
    lower-left or upper-right half of grid cell f // 2 (inset by a tenth of
    a cell), its three UV vertices at the field mesh's positions (written
    exactly, so bake_texture's position match holds); <path>.mtl names the
    diffuse map."""
    F = mesh.num_faces
    n = int(np.ceil(np.sqrt(F / 2)))
    cell = np.arange(F) // 2
    x0, y0 = (cell % n) / n, (cell // n) / n
    e, d = 0.1 / n, 0.8 / n
    lower = (np.arange(F) % 2 == 0)[:, None]
    a = np.stack([x0 + e, y0 + e], -1)
    corners = np.where(lower[..., None],
                       np.stack([a, a + [d, 0], a + [0, d]], 1),
                       np.stack([a + [d, 0], a + [d, d], a + [0, d]], 1))
    with open(path, "w") as f:
        f.write(f"mtllib {os.path.basename(path)}.mtl\n")
        f.writelines(f"v {x!r} {y!r} {z!r}\n"
                     for x, y, z in mesh.vertices[mesh.faces].reshape(-1, 3).tolist())
        f.writelines(f"vt {u!r} {v!r}\n" for u, v in corners.reshape(-1, 2).tolist())
        f.writelines(f"f {3 * i + 1}/{3 * i + 1} {3 * i + 2}/{3 * i + 2} {3 * i + 3}/{3 * i + 3}\n"
                     for i in range(F))
    with open(path + ".mtl", "w") as f:
        f.write("newmtl material_0\nmap_Kd texture.png\n")


def phase_bake(p):
    """The HQ field baked into a per-face atlas of the HQ blob (20,480
    faces) at 1024^2 through bake_texture_field (the kernel) and through
    the plain twin; the kernel once per 8,192-texel chunk."""
    import torch

    from intrinsic_neural_fields_tpu_torch import bake_texture_field
    from intrinsic_neural_fields_tpu_torch.bake import bake as bake_mod
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (kernel_launches,
                                                                 reset_kernel_launches)
    from intrinsic_neural_fields_tpu_torch.utils.io import imread

    root = p["root"]
    uv = os.path.join(root, "blob_atlas.obj")
    _write_atlas_uv_mesh(uv, p["mesh"])
    cfg_path = os.path.join(root, "hq_config.yaml")
    field_calls = []
    field_rgbs = bake_mod._field_rgbs

    def timed_field_rgbs(mesh, config, vids, bary, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = field_rgbs(mesh, config, vids, bary, **kw)
        field_calls.append((len(vids), time.perf_counter() - t0))
        return out

    bake_mod._field_rgbs = timed_field_rgbs
    try:
        reset_kernel_launches()
        t0 = time.perf_counter()
        got_path = bake_texture_field.main(["--uv_mesh", uv, "--config_path", cfg_path,
                                            "--out_dir", os.path.join(root, "bake_kernel"),
                                            "--texture_size", str(BAKE_SIZE)])
        torch.cuda.synchronize()
        bake_s = time.perf_counter() - t0
        launches = kernel_launches()["fused_mlp_fwd"]
        want_path = bake_mod.bake_texture(os.path.join(root, "bake_plain"), uv, cfg_path,
                                          texture_size=BAKE_SIZE, infer="plain")
    finally:
        bake_mod._field_rgbs = field_rgbs
    (texels, field_s), (_, plain_field_s) = field_calls
    got, want = imread(got_path).astype(int), imread(want_path).astype(int)
    hit = want.any(-1) | got.any(-1)
    diff = int(np.abs(got - want)[hit].max())
    check(got.shape == (BAKE_SIZE, BAKE_SIZE, 3) and diff <= 2,
          f"kernel and plain bakes differ by {diff}/255 > 2/255")
    check(launches == -(-texels // FWD_CHUNK),
          f"{launches} forward launches for {texels} texels, not one per {FWD_CHUNK}")
    emit("bake", faces=p["mesh"].num_faces, texture_size=BAKE_SIZE, texels=texels,
         covered_share=float(hit.mean()), max_abs_diff_255=diff, bake_s=bake_s,
         field_s=field_s, texels_per_s_field=texels / field_s, texels_per_s_bake=texels / bake_s,
         plain_field_s=plain_field_s, launches=launches)
    return {"bake": launches}


def phase_video(p):
    """render_video at 720p (10 frames) and render_view on the HQ and the
    view-dependent leg's models, each view held to a direct render."""
    import torch

    from intrinsic_neural_fields_tpu_torch import render_video, render_view
    from intrinsic_neural_fields_tpu_torch.data.datasets import read_split_list
    from intrinsic_neural_fields_tpu_torch.geometry.cameras import cam_resize
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (kernel_launches,
                                                                 reset_kernel_launches)
    from intrinsic_neural_fields_tpu_torch.render.renderer import make_renderer_from_config
    from intrinsic_neural_fields_tpu_torch.utils.io import imread, load_cameras

    root = p["root"]
    cam, K = load_cameras(os.path.join(p["data"], read_split_list(p["data"], "test")[0]))
    cams = os.path.join(root, "video_camera.npz")
    np.savez(cams, world_mat_0=cam, camera_mat_0=K)
    cfg_dir = os.path.join(root, "hq_video")
    os.makedirs(cfg_dir, exist_ok=True)
    config = _hq_train_config(p, "out", 5)
    cfg_path = _write_config(cfg_dir, "config.yaml", config)
    out = os.path.join(root, "video")
    reset_kernel_launches()
    t0 = time.perf_counter()
    n = render_video.main(["--out_dir", out, "--config_path", cfg_path, "--cameras_path", cams,
                           "--resolution", "720p", "--fps", "10", "--duration", "1"])
    torch.cuda.synchronize()
    video_s = time.perf_counter() - t0
    video_launches = kernel_launches()["fused_mlp_fwd"]
    frames = sorted(os.listdir(os.path.join(out, "images", "hq_video_720p")))
    check(n == 10 and frames == [f"{i:04d}.jpg" for i in range(10)],
          f"render_video wrote {frames}")
    check(imread(os.path.join(out, "images", "hq_video_720p", frames[3])).shape == (720, 1280, 3),
          "the frames are not 1280x720")
    check(video_launches > 0, "render_video did not launch the forward kernel")
    # the render loop alone, as the CLI runs it (uint8 wire, depth 2)
    r = make_renderer_from_config(config, wire_u8=True)
    fit = render_video.fit_camera_to_resolution(
        {"K": K, "height": 256, "width": 256}, render_video.resolutions["720p"])
    r.set_height(fit["height"])
    r.set_width(fit["width"])
    render_video.render_turntable(r, cam, fit["K"], [0.0, 10.0], lambda i, img: None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render_video.render_turntable(r, cam, fit["K"], np.linspace(0, 720, 10),
                                  lambda i, img: None)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0

    views = {}
    vd_config = _vd_train_config(p, "vd_out", 5)
    for name, cfgd in (("hq", config), ("viewdep", vd_config)):
        path = _write_config(root, f"{name}_view_config.yaml", cfgd)
        png = os.path.join(root, f"view_{name}.png")
        reset_kernel_launches()
        render_view.main(["--output_path", png, "--config_path", path, "--cameras_path", cams,
                          "--height", "360", "--width", "640"])
        torch.cuda.synchronize()
        launches = kernel_launches()
        rr = make_renderer_from_config(cfgd)
        rr.set_height(360)
        rr.set_width(640)
        want = rr.render(cam, cam_resize({"K": K, "height": 256, "width": 256}, 360, 640)["K"])
        want = (want * 255.0 + 0.5).clip(0, 255).astype(int)
        got = imread(png).astype(int)
        diff = int(np.abs(got - want).max())
        check(got.shape == (360, 640, 3) and diff <= 1,
              f"render_view ({name}) differs from a direct render by {diff}/255")
        kernel = "fused_mlp_fwd_viewdep" if name == "viewdep" else "fused_mlp_fwd"
        check(launches[kernel] > 0, f"render_view ({name}) did not launch {kernel}")
        views[name] = {"max_abs_diff_255": diff, "launches": launches[kernel]}
    emit("video", resolution=[1280, 720], frames=n, cli_s=video_s,
         frames_per_s_cli=n / video_s, frames_per_s_render=10 / loop_s,
         rays_per_s_render=10 * 1280 * 720 / loop_s, launches=video_launches,
         launches_per_frame=video_launches / n, render_view=views)
    return {"video": video_launches, "render_view": views["hq"]["launches"]}, \
        {"render_view": views["viewdep"]["launches"]}


# ------------------------------------------------------------------ families

# The pre-embed recipes (configs/synthetic/<name>.yaml) and the FF field the
# smoke checks at its width (no shipped recipe: 10 log bands, 63 columns).
FAMILY_RECIPES = ("xyz_blob", "tf_rff_blob")
FF_FIELD = {"feature_strategy": "ff", "k": 10, "use_logspace": True, **HQ}


def _family_config(p, recipe, out_name, epochs):
    """configs/synthetic/<recipe>.yaml on the hq_pipeline's files: its model
    and training sections (no precompute_dtype, so f32 tables), cut to
    `epochs` epochs, checkpoints every 3 epochs, no vis views."""
    import yaml

    with open(os.path.join(REPO, "configs", "synthetic", f"{recipe}.yaml")) as f:
        cfg = yaml.safe_load(f)
    data = {
        "preproc_data_path_train": os.path.join(p["pre"], "train"),
        "preproc_data_path_eval": os.path.join(p["pre"], "val"),
        "preproc_data_path_test": os.path.join(p["pre"], "test"),
        "eigenfunctions_path": p["efuncs_path"], "mesh_path": p["mesh_path"],
        "img_height": 256, "img_width": 256,
        "eval_render_input_paths": [], "eval_render_img_names": [],
    }
    if "embed_strategy" in cfg["data"]:
        data["embed_strategy"] = cfg["data"]["embed_strategy"]
        data["eigenvalues_path"] = p["efuncs_path"].replace("eigenfunctions_", "eigenvalues_")
    cfg["data"] = data
    cfg["training"].update(out_dir=os.path.join(p["root"], out_name), epochs=epochs,
                           checkpoint_every=3, render_every=100, print_every=1)
    return cfg


def _embedding_vs_cpu(trainer, raw, n=1 << 16):
    """The card's embedded rows of the first n train hits against the same
    encoding on the CPU: (max |d|, gate). The interpolation and the phase
    sums are the same elementwise f32 operations on both; cos and sin may
    differ in the last bits, gated at two ulps of the largest phase (an
    RFF phase ulp; 2.4e-7 for xyz)."""
    import copy

    import torch

    from intrinsic_neural_fields_tpu_torch.models.texture_field import input_encoder_apply
    from intrinsic_neural_fields_tpu_torch.ops.interpolate import interpolate_vertex_features

    model = copy.deepcopy(trainer.model).cpu()
    sl = slice(0, n)
    with torch.no_grad():
        pos = interpolate_vertex_features(raw.features.cpu(), raw.vertex_idxs_of_hit_faces[sl].cpu(),
                                          raw.barycentric_coords[sl].cpu())
        phase = 1.0
        if model.input_feature_embed == "rff":
            B = model.embedding.B.double()
            phase = ((2 * np.pi * pos.double()) @ B).abs().max().item()
        want = input_encoder_apply(model)(pos)
    got = trainer.train_data.hit_features[sl].cpu()
    return (got - want).abs().max().item(), 2 * float(np.spacing(np.float32(phase)))


def _family_leg(p, recipe, mesh, test_views, hq_rays):
    """One pre-embed recipe through the port's Trainer on the card, counters
    set to 0 just before and read just after; resume; the embedding against
    the CPU; the eval CLI; kernel vs plain renders."""
    import pickle
    import shutil

    import torch

    from intrinsic_neural_fields_tpu_torch import eval as eval_cli
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (kernel_launches,
                                                                 reset_kernel_launches)
    from intrinsic_neural_fields_tpu_torch.render.renderer import make_renderer_from_config
    from intrinsic_neural_fields_tpu_torch.train import (Trainer, get_data, get_model_and_optim,
                                                         get_renderer)
    from intrinsic_neural_fields_tpu_torch.train.steps import eager_step

    config = _family_config(p, recipe, recipe, 5)
    model, opt = get_model_and_optim(config, mesh)
    renderer = get_renderer(config, model, mesh)
    t0 = time.perf_counter()
    data = get_data(config, mesh)
    rec = Recorder()
    trainer = Trainer(model, opt, "L1", renderer, data, mesh, config, writer=rec)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(trainer.fused_mlp and trainer.epoch_model is not model,
          f"{recipe}: the Trainer did not pre-embed the splits")
    for d in (trainer.train_data, trainer.val_data, trainer.test_data):
        check(d.hit_features.dtype == torch.float32 and d.hit_features.shape[1] == model.in_dim,
              f"{recipe}: an embedded table is not f32 at width {model.in_dim}")
    emb_err, emb_tol = _embedding_vs_cpu(trainer, data["train"])
    check(emb_err <= emb_tol, f"{recipe}: embedded rows differ from the CPU's by {emb_err}")

    reset_kernel_launches()
    eager_step.launches = 0
    t1 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t1
    launches, eager = kernel_launches(), eager_step.launches
    B = config["training"]["batch_size"]
    nb = trainer.train_data.n // B
    check(launches["fused_mlp_fwd_bwd"] == launches["fused_mlp_wgrad_adam"] == 5 * nb
          and sum(launches.values()) == 10 * nb and eager == 0,
          f"{recipe}: not one fwd_bwd and one wgrad_adam per step: {launches}, eager {eager}")
    graph = _graph_stats(trainer, launches, 5 * nb, 5, ("fused_mlp_fwd_bwd",
                                                          "fused_mlp_wgrad_adam"))
    check(graph["host_dispatches_per_epoch"] == 1, f"{recipe}: not one replay per epoch {graph}")
    losses = rec.values("Train_Loss")
    check(len(losses) == 5 and losses[-1] < losses[0], f"{recipe}: loss did not fall {losses}")
    check(all(torch.isfinite(t).all().item() for t in (trainer.state.params, trainer.state.mu,
                                                       trainer.state.nu)), "non-finite state")

    shutil.copytree(config["training"]["out_dir"], os.path.join(p["root"], recipe + "_resumed"))
    cfg_r = _family_config(p, recipe, recipe + "_resumed", 5)
    model_r, opt_r = get_model_and_optim(cfg_r, mesh)
    resumed = Trainer(model_r, opt_r, "L1", get_renderer(cfg_r, model_r, mesh), get_data(cfg_r, mesh),
                      mesh, cfg_r, writer=Recorder())
    resumed.train()
    for name in ("params", "mu", "nu"):
        check(torch.equal(getattr(resumed.state, name), getattr(trainer.state, name)),
              f"{recipe}: resumed {name} differs from the uninterrupted run")
    check(all(torch.equal(resumed.state.buffers[k], v) for k, v in trainer.state.buffers.items()),
          f"{recipe}: the resumed run's buffers differ")

    cfg_path = _write_config(p["root"], f"{recipe}_config.yaml", config)
    test_dir = os.path.join(p["root"], f"{recipe}_test_eval")
    reset_kernel_launches()
    eval_cli.main([test_dir, cfg_path, p["data"], "test"])
    torch.cuda.synchronize()
    eval_launches = kernel_launches()["fused_mlp_fwd"]
    check(eval_launches > 0, f"{recipe}: the eval CLI did not launch the forward kernel")
    with open(os.path.join(test_dir, "evaluation_metrics.pkl"), "rb") as f:
        test_metrics = pickle.load(f)
    test_psnr = float(np.mean([m["psnr"] for m in test_metrics.values()]))
    check(np.isfinite(test_psnr), f"{recipe}: bad test eval {test_metrics}")
    r_k = make_renderer_from_config(config)
    r_p = make_renderer_from_config(config, infer="plain")
    psnr_kp = _render_vs_plain(r_k, r_p, test_views)
    check(psnr_kp >= PSNR_MIN, f"{recipe}: kernel vs plain render {psnr_kp} < {PSNR_MIN} dB")
    rays = rec.values("Train Rays-per-sec")
    emit("family_train", recipe=recipe, k_in=model.in_dim, table_dtype="float32",
         steps_per_epoch=nb, epochs=5, setup_s=setup_s, path_s=path_s, train_loss=losses,
         val_psnr=rec.values("Val Epoch-PSNR"), test_psnr_eval_cli=test_psnr,
         train_rays_per_s_best=max(rays), train_rays_per_s_median=float(np.median(rays)),
         hq_train_rays_per_s_best=hq_rays[0], hq_train_rays_per_s_median=hq_rays[1],
         launches=launches, eager_steps=eager, resumed_bit_equal=True, **graph,
         embedding_max_abs_vs_cpu=emb_err, embedding_tol=emb_tol,
         psnr_kernel_vs_plain_min=psnr_kp, eval_launches=eval_launches)
    return ({"train": launches, "eval": eval_launches}, train_leg_of(trainer, nb, B),
            (r_k, cfg_path))


def _hks_leg(p, mesh):
    """hks_blob.yaml (HKS features, no fused_mlp) for 2 epochs: the eager
    step, whose Adam is the standalone kernel, counters set to 0 just
    before and read just after."""
    import torch

    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (kernel_launches,
                                                                 reset_kernel_launches)
    from intrinsic_neural_fields_tpu_torch.train import (Trainer, get_data, get_model_and_optim,
                                                         get_renderer)
    from intrinsic_neural_fields_tpu_torch.train.steps import eager_step

    config = _family_config(p, "hks_blob", "hks_blob", 2)
    model, opt = get_model_and_optim(config, mesh)
    data = get_data(config, mesh)
    rec = Recorder()
    trainer = Trainer(model, opt, "L1", get_renderer(config, model, mesh), data, mesh, config,
                      writer=rec)
    reset_kernel_launches()
    eager_step.launches = 0
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches, eager = kernel_launches(), eager_step.launches
    nb = data["train"].n // config["training"]["batch_size"]
    check(launches["fused_adam"] == eager == 2 * nb and sum(launches.values()) == 2 * nb,
          f"hks_blob: not one eager step and one Adam launch per step: {launches}, {eager}")
    losses = rec.values("Train_Loss")
    check(len(losses) == 2 and losses[1] < losses[0], f"hks_blob: loss did not fall {losses}")
    rays = rec.values("Train Rays-per-sec")
    emit("family_train", recipe="hks_blob", k_in=model.in_dim, epochs=2, steps_per_epoch=nb,
         path_s=path_s, train_loss=losses, val_psnr=rec.values("Val Epoch-PSNR"),
         train_rays_per_s_best=max(rays), launches=launches, eager_steps=eager)
    return launches


def phase_families(p, hq_rays):
    """The xyz and tf_rff recipes through the Trainer (pre-embedded, the
    kernels at k_in 3 and 515 on f32 tables), hks_blob through the eager
    step, eval_on_mesh of the xyz field on the transfer phase's coarse
    target; returns each path's launches and the legs the kernel checks
    take."""
    import torch

    from intrinsic_neural_fields_tpu_torch import eval_on_mesh
    from intrinsic_neural_fields_tpu_torch.models import make_model
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (kernel_launches,
                                                                 reset_kernel_launches)
    from intrinsic_neural_fields_tpu_torch.render.renderer import Renderer

    mesh = p["mesh"]
    test_views = _dataset_views(p, "test")
    paths, train_legs, fwd_legs = {}, {}, {}
    cams, K = [v["camCv2world"] for v in test_views], test_views[0]["K"]
    for recipe in FAMILY_RECIPES:
        launched, leg, (r_k, cfg_path) = _family_leg(p, recipe, mesh, test_views, hq_rays)
        paths[recipe] = launched
        train_legs[recipe] = leg
        fwd_legs[recipe] = render_leg_of(r_k, cams, K)
        if recipe == "xyz_blob":
            xyz_cfg = cfg_path
    paths["hks_blob"] = {"train": _hks_leg(p, mesh)}
    ff = make_model(FF_FIELD, seed=0)
    fwd_legs["ff_field"] = render_leg_of(Renderer(ff, mesh, None, H=256, W=256), cams, K)
    paths["viewdep_xyz"], vd_row = _viewdep_xyz_check(mesh, test_views, cams, K)

    coarse = os.path.join(p["root"], "transfer", "coarse.obj")
    check(os.path.exists(coarse), "the transfer phase's coarse target is missing")
    reset_kernel_launches()
    t0 = time.perf_counter()
    means = eval_on_mesh.main(["--config_path", xyz_cfg, "--target_mesh", coarse,
                               "--eval_dataset", p["data"], "--eval_split", "test", "--out_dir",
                               os.path.join(p["root"], "xyz_on_coarse")])
    torch.cuda.synchronize()
    eom_launches = kernel_launches()["fused_mlp_fwd"]
    check(eom_launches > 0 and np.isfinite(means["psnr"]),
          f"eval_on_mesh: {eom_launches} forward launches, PSNR {means['psnr']}")
    emit("eval_on_mesh", field="xyz_blob", target="coarse", psnr=means["psnr"],
         dssim_rescaled=means["dssim_rescaled"], s=time.perf_counter() - t0,
         launches=eom_launches)
    paths["eval_on_mesh"] = {"eval": eom_launches}
    return paths, train_legs, fwd_legs, vd_row


# ------------------------------------------------------------------ neutex

# The NeuTex eager step on the card against the same step on the CPU, from
# the state the 2 trained epochs leave and the first 4,096 train rows: f32
# autograd on both (TF32 off), then the Adam kernel on the card's flat
# gradient against adam_apply_plain on the CPU's. Gates (set before any card
# run): loss within NEUTEX_LOSS_TOL relative, RGB within NEUTEX_RGB_TOL
# absolute, the flat gradient within NEUTEX_GRAD_TOL (norm, relative: cuBLAS
# and the CPU's BLAS sum in other orders), the parameter update within
# NEUTEX_UPDATE_TOL (norm, relative) and no parameter further apart than two
# steps of lr (a coordinate whose gradient and moments sit at rounding level
# may take Adam's step either way: on the CPU, JAX's and the port's runs
# part so, tests/test_torch_port_neutex.py); the kernel within 1 ulp of its
# twin on the same gradient.
NEUTEX_LOSS_TOL, NEUTEX_RGB_TOL, NEUTEX_GRAD_TOL, NEUTEX_UPDATE_TOL = 1e-4, 1e-4, 1e-3, 1e-2
NEUTEX_PRETRAIN_ITERS = 300   # the mapping pretraining's iterations (25,000 points each)
NEUTEX_PROFILE_STEPS = 20


def _neutex_config(p, out_name, epochs):
    """configs/synthetic/neutex_blob.yaml on the hq_pipeline's files (see
    _family_config), its pretrained mapping the repo's npz."""
    cfg = _family_config(p, "neutex_blob", out_name, epochs)
    cfg["model"]["pretrained_path"] = os.path.join(REPO, cfg["model"]["pretrained_path"])
    return cfg


def _neutex_step_vs_cpu(trainer):
    """One eager NeuTex step on the card against the CPU from the trained
    state (gates above); returns the comparison and the card's gradient."""
    import copy

    import torch

    from intrinsic_neural_fields_tpu_torch.ops import fused_mlp as F
    from intrinsic_neural_fields_tpu_torch.train.steps import self_loss_fn

    st, model, B = trainer.state, trainer.model, trainer.batch_size
    layout = st.layout
    xyz = trainer.train_data.hit_features[:B].float()
    gt = trainer.train_data.expected_rgbs[:B]
    hyper = F.adam_hyper_rows(torch.tensor([st.count + 1]), st.hyper.learning_rate,
                              device="cuda")[0]

    def grad_step(mdl, params, x, g):
        p = params.detach().clone().requires_grad_()
        loss, pred = self_loss_fn(mdl, layout, x, g)(p)
        loss.backward()
        return loss.detach(), pred.detach(), p.grad

    loss_c, pred_c, grad_c = grad_step(model, st.params, xyz, gt)
    p_k, m_k, v_k = st.params.clone(), st.mu.clone(), st.nu.clone()
    F.fused_adam_apply(p_k, m_k, v_k, hyper, grad_c)
    want = F.adam_apply_plain(st.params, st.mu, st.nu, hyper, grad_c)
    torch.cuda.synchronize()
    ulp = max((a.view(torch.int32) - b.view(torch.int32)).abs().max().item()
              for a, b in zip((p_k, m_k, v_k), want))
    kernel_err = max((a - b).abs().max().item() for a, b in zip((p_k, m_k, v_k), want))
    cpu = copy.deepcopy(model).cpu()
    loss_h, pred_h, grad_h = grad_step(cpu, st.params.cpu(), xyz.cpu(), gt.cpu())
    p_h, _, _ = F.adam_apply_plain(st.params.cpu(), st.mu.cpu(), st.nu.cpu(), hyper.cpu(), grad_h)
    p0 = st.params.cpu()
    upd_c, upd_h = p_k.cpu() - p0, p_h - p0
    cmp = {"loss_rel": abs(loss_c.item() - loss_h.item()) / abs(loss_h.item()),
           "rgb_max_abs": (pred_c.cpu() - pred_h).abs().max().item(),
           "grad_norm_rel": ((grad_c.cpu() - grad_h).norm() / grad_h.norm()).item(),
           "update_norm_rel": ((upd_c - upd_h).norm() / upd_h.norm()).item(),
           "params_max_abs": (upd_c - upd_h).abs().max().item(),
           "kernel_vs_twin_ulp": ulp, "kernel_vs_twin_max_abs": kernel_err,
           "gates": {"loss_rel": NEUTEX_LOSS_TOL, "rgb_max_abs": NEUTEX_RGB_TOL,
                     "grad_norm_rel": NEUTEX_GRAD_TOL, "update_norm_rel": NEUTEX_UPDATE_TOL,
                     "params_max_abs": 2 * st.hyper.learning_rate, "kernel_vs_twin_ulp": 1}}
    check(all(cmp[k] <= g for k, g in cmp["gates"].items()),
          f"neutex: the card's step differs from the CPU's {cmp}")
    return cmp, grad_c, hyper


def phase_neutex(p):
    """NeuTex on the card: the mapping pretraining CLI on the pipeline's
    blob (chamfer and cycle fall; its npz loads in the port); then
    neutex_blob.yaml with the repo's mapping through the Trainer for 2
    epochs at full width, counters set to 0 just before and read just
    after (one eager step and one fused_adam launch per step, no other
    kernel; loss falls); one step against the CPU; the Adam kernel at the
    model's 793,482 parameters against its twin and torch's fused Adam;
    the eval CLI on the test split (module forward: no kernel launch)."""
    import pickle

    import torch

    from intrinsic_neural_fields_tpu_torch import eval as eval_cli
    from intrinsic_neural_fields_tpu_torch import pretrain_neutex_mapping
    from intrinsic_neural_fields_tpu_torch.models import make_model
    from intrinsic_neural_fields_tpu_torch.ops import fused_mlp as F
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (kernel_launches,
                                                                 reset_kernel_launches)
    from intrinsic_neural_fields_tpu_torch.train import (Trainer, get_data, get_model_and_optim,
                                                         get_renderer)
    from intrinsic_neural_fields_tpu_torch.train.steps import ModuleLayout, eager_step

    mesh = p["mesh"]
    npz = os.path.join(p["root"], "neutex", "mapping.npz")
    iters = NEUTEX_PRETRAIN_ITERS
    reset_kernel_launches()
    t0 = time.perf_counter()
    hist = pretrain_neutex_mapping.main([p["mesh_path"], npz, "--iterations", str(iters),
                                         "--steps_per_call", "50", "--print_every", "100"])
    torch.cuda.synchronize()
    pretrain_s = time.perf_counter() - t0
    pre_launches = kernel_launches()
    check(pre_launches["fused_adam"] == iters and sum(pre_launches.values()) == iters,
          f"neutex pretraining: not one Adam launch per iteration: {pre_launches}")
    first, last = hist[:20].mean(0), hist[-20:].mean(0)
    check(np.isfinite(hist).all() and last[1] < first[1] and last[2] < first[2],
          f"neutex pretraining: chamfer / cycle did not fall: {first} -> {last}")
    model_cfg = dict(_neutex_config(p, "neutex_unused", 1)["model"], pretrained_path=npz)
    pre_model = make_model(model_cfg)
    check(all(torch.isfinite(t).all().item() for t in pre_model.state_dict().values()),
          "neutex: the pretrained npz loads non-finite weights")
    emit("neutex_pretrain", iterations=iters, points=25_000, seconds=pretrain_s,
         it_per_s=iters / pretrain_s, loss_first20=first.tolist(), loss_last20=last.tolist(),
         launches=pre_launches)

    config = _neutex_config(p, "neutex_blob", 2)
    model, opt = get_model_and_optim(config, mesh)
    data = get_data(config, mesh)
    rec = Recorder()
    trainer = Trainer(model, opt, config["training"]["loss_type"],
                      get_renderer(config, model, mesh), data, mesh, config, writer=rec)
    check(isinstance(trainer.state.layout, ModuleLayout) and trainer.state.layout.n == 793_482,
          f"neutex: not the recipe's 793,482-parameter state ({trainer.state.layout.n})")
    reset_kernel_launches()
    eager_step.launches = 0
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches, eager = kernel_launches(), eager_step.launches
    B = config["training"]["batch_size"]
    nb = data["train"].n // B
    check(launches["fused_adam"] == eager == 2 * nb and sum(launches.values()) == 2 * nb,
          f"neutex_blob: not one eager step and one Adam launch per step: {launches}, {eager}")
    losses = rec.values("Train_Loss")
    check(len(losses) == 2 and losses[1] < losses[0], f"neutex_blob: loss did not fall {losses}")
    check(all(torch.isfinite(t).all().item() for t in (trainer.state.params, trainer.state.mu,
                                                       trainer.state.nu)), "non-finite state")
    cmp, grad, hyper = _neutex_step_vs_cpu(trainer)

    # the standalone Adam at the model's size: kernel, twin, torch's fused Adam
    st = trainer.state
    n = st.layout.n
    p2, m2, v2 = st.params.clone(), st.mu.clone(), st.nu.clone()
    # its 22.2 MB stay in the 50 MB L2 between back-to-back calls: timed
    # both so and with the L2 flushed before each call (the eager step's
    # own traffic evicts them between its Adam launches)
    adam = {"n": n, "ms": cuda_ms(lambda: F.fused_adam_apply(p2, m2, v2, hyper, grad)),
            "ms_l2_flushed": cuda_ms_cold(lambda: F.fused_adam_apply(p2, m2, v2, hyper, grad)),
            "plain_ms": cuda_ms(lambda: F.adam_apply_plain(p2, m2, v2, hyper, grad))}
    p_lib = torch.nn.Parameter(st.params.clone())
    p_lib.grad = grad.clone()
    adam["library_ms"] = cuda_ms(torch.optim.Adam([p_lib], lr=1e-4, fused=True).step)
    # params, m, v, the gradient read; params, m, v written; ~12 f32 operations each
    adam["bound_ms"], adam["bound_by"] = _bound(0.0, 7 * n * 4 + 7 * 4, f32_flops=12.0 * n)
    adam["max_abs_err"] = cmp["kernel_vs_twin_max_abs"]

    cfg_path = _write_config(p["root"], "neutex_blob_config.yaml", config)
    test_dir = os.path.join(p["root"], "neutex_blob_test_eval")
    reset_kernel_launches()
    t0 = time.perf_counter()
    eval_cli.main([test_dir, cfg_path, p["data"], "test"])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    # the trace's and the wire's kernels run for every view; the field is the
    # module's forward
    eval_launches = sum(n for k, n in kernel_launches().items()
                        if k not in ("raster_traverse", "raster_bin", "render_wire"))
    check(eval_launches == 0, f"neutex_blob: the eval CLI launched a kernel: {kernel_launches()}")
    with open(os.path.join(test_dir, "evaluation_metrics.pkl"), "rb") as f:
        test_psnr = float(np.mean([m["psnr"] for m in pickle.load(f).values()]))
    check(np.isfinite(test_psnr), f"neutex_blob: test PSNR {test_psnr}")
    rays = rec.values("Train Rays-per-sec")
    emit("family_train", recipe="neutex_blob", params=n, epochs=2, steps_per_epoch=nb,
         path_s=path_s, train_loss=losses, val_psnr=rec.values("Val Epoch-PSNR"),
         test_psnr_eval_cli=test_psnr, eval_s=eval_s, eval_launches=eval_launches,
         train_rays_per_s_best=max(rays), train_rays_per_s_median=float(np.median(rays)),
         step_ms_best=1e3 * B / max(rays), launches=launches, eager_steps=eager,
         step_vs_cpu=cmp)
    emit("kernel_check", name="fused_adam", leg="neutex_blob", **adam)
    run = (trainer.train_epoch_fn, trainer.state, trainer.train_data, B)
    return {"train": launches["fused_adam"], "pretrain": pre_launches["fused_adam"]}, adam, run


# The data-parallel phase runs its replicas on one card, the device
# repeated (a run across distinct cards needs a machine with more than one).
DP_DEVICES = ["cuda:0", "cuda:0"]
# One DP step against the one-device step on the same global batch (the
# union of the replicas' local blocks), from the same state. The gradients
# differ by f32 summation order only (two half-block sums, averaged, against
# one whole-block sum): Adam's first moment after one step (0.1 g) within
# DP_GRAD_REL of its largest entry, the loss within DP_LOSS_REL; the params
# within DP_PARAM_ATOL, as a gradient within rounding of 0 may flip the sign
# of Adam's first update (lr each way). Measured on an H100 at 700 W: the
# kernel step's loss equal, first moment 3.4e-8, params 2.2e-8. The
# BatchNorm step (sync-BN, f32 autograd) normalises with batch statistics
# summed in another order on each side, so a hidden pre-activation that
# lies within rounding of 0 may take the other ReLU branch in the DP
# forward than in the one-device one; behind a BatchNorm one such entry
# moves the gradient by ~1e-3 of its largest entry (relu_flips in
# tools/port_bn_step_precision.py: on the CPU every f32 step that lies
# ~1e-3 from the f64 step has such a flip, every one without lies ~1e-6
# from it, whatever the variance formula or the loss). So the BatchNorm
# step is held to the one-device step taken along the DP forward's own
# ReLU branches (relu_branches), at the same gates, its running statistics
# to DP_STATS_REL of their largest entry; the flips and the distance to the
# one-device step on its own branches are recorded.
DP_GRAD_REL, DP_LOSS_REL, DP_STATS_REL = 1e-4, 1e-5, 1e-5
DP_PARAM_ATOL = 2 * 1e-4 + 1e-6


@contextlib.contextmanager
def relu_branches(force=None):
    """While open, every nn.ReLU call appends its branch mask (input > 0)
    to the yielded list, in call order; given `force` (masks in call
    order), it returns input * mask instead, so that the forward and
    autograd take those branches (an entry on the other branch lies within
    rounding of 0, where both give ~0)."""
    import torch

    seen = []

    def hook(module, args, output):
        if not isinstance(module, torch.nn.ReLU):
            return None
        x = args[0]
        mask = x.detach() > 0 if force is None else force[len(seen)]
        seen.append(mask)
        return None if force is None else x * mask.to(x.dtype)

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        yield seen
    finally:
        handle.remove()


def _dp_step_vs_one_device(make, dp_kw, sd_kw, data, lr=1e-4):
    """One DP step (block 0 of each replica's shard) and one one-device
    step (block 0 of the table: the same 4096 rows) from the same fresh
    state, counters set to 0 just before the DP step and read just after;
    a BatchNorm model's one-device step again along the DP forward's ReLU
    branches, which the gates then read. Returns (the comparison, the DP
    step's launches)."""
    import torch

    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (kernel_launches,
                                                                 reset_kernel_launches)
    from intrinsic_neural_fields_tpu_torch.parallel import make_dp_epoch_fns
    from intrinsic_neural_fields_tpu_torch.train.steps import (AdamHyper, create_train_state,
                                                               make_epoch_fns)

    D = len(DP_DEVICES)
    model = make()
    st_dp, st_sd, st_br = (create_train_state(model, AdamHyper(lr)) for _ in range(3))
    dp_train, _ = make_dp_epoch_fns(model, "L1", DP_DEVICES, shuffle="blocks", **dp_kw)
    sd_train, _ = make_epoch_fns(model, "L1", shuffle="blocks", **sd_kw)
    one_block = np.zeros(1, np.int64)
    with relu_branches() as dp_masks:
        reset_kernel_launches()
        _, m_dp = dp_train(st_dp, np.zeros((D, 1), np.int64), data, 1, 4096)
        torch.cuda.synchronize()
        launches = kernel_launches()
    with relu_branches() as sd_masks:
        _, m_sd = sd_train(st_sd, one_block, data, 1, 4096)
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()  # noqa: E731
    cmp = {}
    if st_sd.batch_stats:
        # the replicas' forwards run in step: layer l of replica d is call l D + d
        L = len(sd_masks)
        check(len(dp_masks) == L * D, f"dp_bn: {len(dp_masks)} ReLU calls, not {L} x {D}")
        branches = [torch.cat([dp_masks[i * D + d].to(sd_masks[i].device) for d in range(D)])
                    for i in range(L)]
        with relu_branches(branches):
            _, m_br = sd_train(st_br, one_block, data, 1, 4096)
        cmp = {"relu_flips": int(sum((a != b).sum() for a, b in zip(branches, sd_masks))),
               "mu_rel_own_branches": rel(st_dp.mu, st_sd.mu)}
        st_sd, m_sd = st_br, m_br
    cmp.update({"loss_rel": abs(float(m_dp["loss"]) / float(m_sd["loss"]) - 1),
                "mu_rel": rel(st_dp.mu, st_sd.mu), "nu_rel": rel(st_dp.nu, st_sd.nu),
                "params_max_abs": (st_dp.params - st_sd.params).abs().max().item(),
                "replicas_bit_equal": _replicas_bit_equal(dp_train)})
    if st_sd.batch_stats:
        cmp["stats_rel"] = max(rel(st_dp.batch_stats[k].float(), v.float())
                               for k, v in st_sd.batch_stats.items() if v.is_floating_point())
    check(cmp["loss_rel"] <= DP_LOSS_REL and cmp["mu_rel"] <= DP_GRAD_REL
          and cmp["params_max_abs"] <= DP_PARAM_ATOL and cmp["replicas_bit_equal"]
          and cmp.get("stats_rel", 0.0) <= DP_STATS_REL,
          f"the DP step does not follow the one-device step: {cmp}")
    return cmp, launches


def _replicas_bit_equal(train_epoch):
    import torch

    states = train_epoch.replicas.states
    return all(torch.equal(getattr(r, n), getattr(states[0], n)) for r in states[1:]
               for n in ("params", "mu", "nu")) and all(
        torch.equal(r.batch_stats[k], states[0].batch_stats[k])
        for r in states[1:] for k in states[0].batch_stats)


def phase_dp(p):
    """Data-parallel training and the D-way render over DP_DEVICES (one
    card, two replicas): the HQ recipe through the Trainer swapped by
    parallelize_trainer for 2 epochs, counters set to 0 just before and
    read just after (fwd_bwd, the grads-only wgrad and the Adam kernel once
    per replica per step, wgrad with Adam never, no epoch graph), loss falls,
    the replicas' params and moments equal to the bit; one DP step against
    the one-device fused_adam: false step on the same global batch; the
    train kernels against their twins at a replica's 2048 rows, the
    all-reduce timed; the HQ recipe with batchnorm: true and fused_mlp:
    false through the one-device Trainer for 2 epochs (one eager step and
    one Adam launch per step), then one sync-BN DP step against the
    one-device BatchNorm step; the trained field's test and val views
    rendered D-way (image and hit set equal to the one-device render, the
    forward kernel's launches counted); --num_devices 2 raises on a
    one-card machine."""
    import torch

    from intrinsic_neural_fields_tpu_torch import eval as eval_cli
    from intrinsic_neural_fields_tpu_torch.evaluation.eval_cli import evaluate_views
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (kernel_launches,
                                                                 reset_kernel_launches)
    from intrinsic_neural_fields_tpu_torch.parallel import parallelize_trainer
    from intrinsic_neural_fields_tpu_torch.parallel.data_parallel import mean_all_reduce
    from intrinsic_neural_fields_tpu_torch.render.renderer import make_renderer_from_config
    from intrinsic_neural_fields_tpu_torch.train import (Trainer, get_data, get_model_and_optim,
                                                         get_renderer)
    from intrinsic_neural_fields_tpu_torch.train.__main__ import main as train_main
    from intrinsic_neural_fields_tpu_torch.train.steps import eager_step

    D = len(DP_DEVICES)
    mesh = p["mesh"]
    config = _hq_train_config(p, "dp_out", 2)
    data = get_data(config, mesh)
    nb = data["train"].n // 4096
    model, opt = get_model_and_optim(config, mesh)
    rec = Recorder()
    trainer = Trainer(model, opt, "L1", get_renderer(config, model, mesh), data, mesh, config,
                      writer=rec)
    parallelize_trainer(trainer, DP_DEVICES)
    reset_kernel_launches()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = kernel_launches()
    dp_kernels = ("fused_mlp_fwd_bwd", "fused_mlp_wgrad", "fused_adam")
    check(all(launches[k] == 2 * nb * D for k in dp_kernels)
          and not any(n for k, n in launches.items() if k not in dp_kernels),
          f"dp_train: not one fwd_bwd, wgrad and Adam per replica per step: {launches}")
    check(trainer.train_epoch_fn.graph is None and launches["fused_mlp_wgrad_adam"] == 0,
          "dp_train: an epoch graph ran")
    losses = rec.values("Train_Loss")
    check(len(losses) == 2 and losses[1] < losses[0], f"dp_train: loss did not fall {losses}")
    check(_replicas_bit_equal(trainer.train_epoch_fn), "dp_train: the replicas differ")
    rays = rec.values("Train Rays-per-sec")
    make = lambda: get_model_and_optim(config, mesh)[0]  # noqa: E731
    step_cmp, _ = _dp_step_vs_one_device(make, {"fused": True},
                                         {"fused": True, "fused_adam": False}, data["train"])

    # the path's kernels at a replica's rows, on the trained replica 0
    st = trainer.state
    krows = phase_train_kernels({"dp_train": train_leg_of(trainer, nb, 4096)},
                                B=4096 // D)["dp_train"]
    g = [torch.randn(st.layout.n, device="cuda") for _ in range(D)]
    allreduce = {"n": st.layout.n, "ms": cuda_ms(lambda: mean_all_reduce(g))}
    # D buffers read, the mean written (the sum stays in one pass's registers)
    allreduce["bound_ms"], allreduce["bound_by"] = _bound(
        0.0, (D + 1) * st.layout.n * 4, f32_flops=float(D * st.layout.n))
    emit("dp_train", devices=DP_DEVICES, steps_per_epoch=nb, epochs=2, path_s=path_s,
         train_loss=losses, val_psnr=rec.values("Val Epoch-PSNR"), launches=launches,
         train_rays_per_s=rays, step_wall_ms=[4096e3 / r for r in rays],
         cited_one_device_graph_step_wall_ms=[0.0853, 0.0873],
         replicas_bit_equal=True, step_vs_one_device=step_cmp, allreduce=allreduce,
         gates={"grad_rel": DP_GRAD_REL, "loss_rel": DP_LOSS_REL,
                "param_atol": DP_PARAM_ATOL})

    # BatchNorm: the one-device Trainer, then one sync-BN DP step
    bn_cfg = _hq_train_config(p, "bn_out", 2)
    bn_cfg["model"]["batchnorm"] = True
    bn_cfg["training"]["fused_mlp"] = False
    bn_model, bn_opt = get_model_and_optim(bn_cfg, mesh)
    bn_rec = Recorder()
    bn_trainer = Trainer(bn_model, bn_opt, "L1", get_renderer(bn_cfg, bn_model, mesh), data,
                         mesh, bn_cfg, writer=bn_rec)
    reset_kernel_launches()
    eager_step.launches = 0
    t0 = time.perf_counter()
    bn_trainer.train()
    torch.cuda.synchronize()
    bn_s = time.perf_counter() - t0
    bn_launches, bn_eager = kernel_launches(), eager_step.launches
    check(bn_launches["fused_adam"] == bn_eager == 2 * nb
          and sum(bn_launches.values()) == 2 * nb,
          f"bn_train: not one eager step and one Adam launch per step: {bn_launches}")
    bn_losses = bn_rec.values("Train_Loss")
    check(len(bn_losses) == 2 and bn_losses[1] < bn_losses[0],
          f"bn_train: loss did not fall {bn_losses}")
    bn_make = lambda: get_model_and_optim(bn_cfg, mesh)[0]  # noqa: E731
    bn_cmp, dp_bn_launches = _dp_step_vs_one_device(bn_make, {}, {}, data["train"])
    check(dp_bn_launches["fused_adam"] == D and sum(dp_bn_launches.values()) == D,
          f"dp_bn: not one Adam launch per replica: {dp_bn_launches}")
    bn_rays = bn_rec.values("Train Rays-per-sec")
    emit("dp_bn", epochs=2, steps_per_epoch=nb, path_s=bn_s, train_loss=bn_losses,
         train_rays_per_s=bn_rays, step_wall_ms=[4096e3 / r for r in bn_rays],
         val_psnr=bn_rec.values("Val Epoch-PSNR"), launches=bn_launches, eager_steps=bn_eager,
         dp_step_launches=dp_bn_launches, dp_step_vs_one_device=bn_cmp,
         stats_gate=DP_STATS_REL)

    # the D-way render of the DP-trained field (its model.pt), user path
    views = _dataset_views(p, "test") + _dataset_views(p, "val")
    one = make_renderer_from_config(config)
    dway = make_renderer_from_config(config, devices=DP_DEVICES)
    reset_kernel_launches()
    t0 = time.perf_counter()
    means_d, per_d = evaluate_views(None, config, views, renderer=dway)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    render_launches = kernel_launches()["fused_mlp_fwd"]
    reset_kernel_launches()
    means_1, per_1 = evaluate_views(None, config, views, renderer=one)
    torch.cuda.synchronize()
    one_launches = kernel_launches()["fused_mlp_fwd"]
    same = all(per_d[v][k] == per_1[v][k] for v in per_1 for k in ("psnr", "dssim_rescaled"))
    check(render_launches > 0 and set(per_d) == set(per_1) and same,
          f"dp_render: metrics differ or no launch: {per_d}, {per_1}, {render_launches}")
    equal = []
    for v in views:
        a, ha = one.render(v["camCv2world"], v["K"], obj_mask_1d=v["obj_mask_1d"],
                           eval_render=True)
        b, hb = dway.render(v["camCv2world"], v["K"], obj_mask_1d=v["obj_mask_1d"],
                            eval_render=True)
        equal.append(bool(np.array_equal(a, b) and np.array_equal(ha, hb)))
    check(all(equal), f"dp_render: the D-way render differs from the one-device render {equal}")
    shards = [len(dway._shards(int(v["obj_mask_1d"].sum()))) for v in views]

    # --num_devices 2 on a one-card machine: the device-count error
    refused = {}
    if torch.cuda.device_count() == 1:
        cfg_path = _write_config(p["root"], "dp_refused.yaml", _hq_train_config(p, "dp_no", 1))
        for name, call in (
                ("train", lambda: train_main([cfg_path, "--num_devices", "2"])),
                ("eval", lambda: eval_cli.main([os.path.join(p["root"], "dp_no_eval"), cfg_path,
                                                p["data"], "test", "--num_devices", "2"]))):
            try:
                call()
                refused[name] = None
            except RuntimeError as e:
                refused[name] = str(e)
        check(all(m and "only 1 CUDA device" in m for m in refused.values())
              and not os.path.exists(os.path.join(p["root"], "dp_no")),
              f"--num_devices 2 on one card did not raise the device-count error: {refused}")
    emit("dp_render", views=len(views), shards_per_view=shards, bit_equal=equal,
         psnr=means_d["psnr"], launches=render_launches, one_device_launches=one_launches,
         seconds=render_s,
         num_devices_2_refused=refused)
    paths = {"dp_train": {k: launches[k] for k in dp_kernels},
             "bn_train": bn_launches["fused_adam"], "dp_bn": dp_bn_launches["fused_adam"],
             "dp_render": render_launches}
    bn_run = (bn_trainer.train_epoch_fn, bn_trainer.state, bn_trainer.train_data, 4096)
    return paths, krows, train_leg_of(trainer, nb, 4096), bn_run


# The spectral phase's gates. CheFSI (f32 device loop, f64 host polish)
# against the hq_prep shift-invert solve: eigenvalues within EIG_REL of
# the largest, M-orthonormal within ORTH_TOL, relative residual
# ||L phi - lambda M phi||_{M^-1} / max|lambda| within RES_TOL; principal
# angles within ANGLE_DEG on the leading span that a spectral gap of
# SPAN_GAP (of the largest eigenvalue) separates from the rest. The solve
# polishes with refine_filter="host": with the default f32 device
# pre-filter the top of the 513-function window sits at f32's limit (one
# degree-60 pass spans ~e^30 across the window), measured on the CPU from
# the JAX start block at 6.1e-5 of the largest (the JAX package: 9.4e-5;
# tools/port_chefsi_start_block.py), a hair under EIG_REL; the all-f64
# polish reaches 3e-15 and 5e-9. The dense path's f32
# eigh is backward stable: |d lambda| <= DENSE_EPS_MULT * eps32 * ||C||
# (Gershgorin); measured on blob clouds through pc_vert_robust, k=65: the
# CPU's LAPACK 2.0-2.3 eps ||C|| at 5,000 points, the H100's cuSOLVER 4.9
# at 5,000, 7.9 at 6,000 and 3.7 at 20,000 (700 W; 1.2-15% of lambda_65).
# LOBPCG: tests/test_spectral.py's rtol 1e-3, atol 1e-4.
EIG_REL, ORTH_TOL, RES_TOL, ANGLE_DEG, SPAN_GAP = 1e-4, 1e-10, 1e-6, 1.0, 1e-3
DENSE_EPS_MULT = 16.0
DENSE_POINTS, DENSE_K = 5000, 65


def _blob_samples(mesh, n, seed):
    """n points uniform by area on the mesh's faces (seeded)."""
    rng = np.random.default_rng(seed)
    tri = mesh.vertices[mesh.faces]
    area = np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    fidx = rng.choice(len(mesh.faces), size=n, p=area / area.sum())
    r1, r2 = rng.random(n), rng.random(n)
    s = np.sqrt(r1)
    w = np.stack([1.0 - s, s * (1.0 - r2), s * r2], axis=-1)
    return np.einsum("nk,nkd->nd", w, tri[fidx])


def _eig_quality(L, M, ev, phi):
    """(max |phi^T M phi - I|, max_i ||L phi_i - ev_i M phi_i||_M^-1 / max|ev|)."""
    Md = M.diagonal()
    orth = np.abs((phi * Md[:, None]).T @ phi - np.eye(phi.shape[1])).max()
    R = (L @ phi - (M @ phi) * ev[None, :]) / np.sqrt(Md)[:, None]
    return float(orth), float(np.linalg.norm(R, axis=0).max() / np.abs(ev).max())


def _angles_deg(phi_ref, phi, Md):
    s = np.linalg.svd((phi_ref * Md[:, None]).T @ phi, compute_uv=False)
    return np.degrees(np.arccos(np.clip(s, 0.0, 1.0)))


def phase_spectral(p):
    """The device eigensolvers on the card: CheFSI at the HQ recipe's solve
    (k+1 = 513 on the blob's cotan operator) against hq_prep's shift-invert
    files (the all-f64 polish), its device loop and host polish timed
    apart, its ELL product
    against cuSPARSE's CSR product at the same shapes; dense inside its
    device window on a 5,000-point cloud through pc_vert_robust; LOBPCG
    at k=10 on icosphere(2); the native triangulation and iDT cores
    loaded from the port's build."""
    import scipy.sparse as sparse
    import torch

    from intrinsic_neural_fields_tpu_torch.geometry.laplacian import (build_laplacian,
                                                                      robust_laplacian)
    from intrinsic_neural_fields_tpu_torch.geometry.pointcloud import local_triangulation
    from intrinsic_neural_fields_tpu_torch.geometry.primitives import icosphere
    from intrinsic_neural_fields_tpu_torch.native import load_idt, load_localtri
    from intrinsic_neural_fields_tpu_torch.ops._build import BUILD_DIR
    from intrinsic_neural_fields_tpu_torch.spectral.eigensolver import (
        DENSE_DEVICE_WINDOW, _ell_arrays, ell_spmv, shift_invert_eigenpairs,
        solve_generalized_eigenproblem)

    libs = {name: load()._name for name, load in (("localtri", load_localtri), ("idt", load_idt))}
    check(all(os.path.dirname(v) == BUILD_DIR for v in libs.values()),
          f"the native cores did not load from the port's build: {libs}")

    # CheFSI at the HQ solve
    L, M = build_laplacian(p["mesh"], "cotan")
    Md = M.diagonal()
    ref_phi = np.load(p["efuncs_path"]).astype(np.float64)
    ref_ev = np.load(p["efuncs_path"].replace("eigenfunctions_", "eigenvalues_")).astype(
        np.float64)
    k = ref_ev.shape[0] + 1
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()  # the earlier phases' live tensors
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    ev, phi = solve_generalized_eigenproblem(L, M, k, method="chefsi", device="cuda",
                                             refine_filter="host", stats=stats)
    chefsi_s = time.perf_counter() - t0
    chefsi_peak = torch.cuda.max_memory_allocated() - base
    rel = float(np.abs(ev[1:] - ref_ev).max() / np.abs(ref_ev).max())
    orth, res = _eig_quality(L, M, ev, phi)
    angles = _angles_deg(ref_phi, phi[:, 1:], Md)
    gaps = np.diff(ref_ev) / ref_ev.max()
    span = int(np.nonzero(gaps > SPAN_GAP)[0].max()) + 1
    span_angle = float(_angles_deg(ref_phi[:, :span], phi[:, 1:span + 1], Md).max())
    check(rel <= EIG_REL, f"chefsi eigenvalues {rel} off shift_invert (> {EIG_REL})")
    check(orth <= ORTH_TOL, f"chefsi not M-orthonormal: {orth}")
    check(res <= RES_TOL, f"chefsi relative residual {res} > {RES_TOL}")
    check(span_angle <= ANGLE_DEG, f"chefsi's first {span} functions {span_angle} deg off")
    check(stats["device_spmv_calls"] > 0 and chefsi_peak > 0, f"chefsi ran no device loop {stats}")

    # the ELL product against cuSPARSE's CSR product, at the loop's [n, m]
    inv_sqrt = 1.0 / np.sqrt(Md)
    idx, w = _ell_arrays(L, inv_sqrt)
    n, m = L.shape[0], stats["m"]
    spmv, _ = ell_spmv(idx, w, m, 2 << 30, "cuda")
    C = (sparse.diags(inv_sqrt) @ L @ sparse.diags(inv_sqrt)).tocsr()
    C_t = torch.sparse_csr_tensor(torch.as_tensor(C.indptr, dtype=torch.int64),
                                  torch.as_tensor(C.indices, dtype=torch.int64),
                                  torch.as_tensor(C.data, dtype=torch.float32), C.shape,
                                  device="cuda", check_invariants=False)
    X = torch.randn(n, m, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    spmv_err = (spmv(X) - C_t @ X).abs().max().item()
    check(spmv_err <= 1e-5 * float(np.abs(C).max()) * X.abs().max().item() * idx.shape[1],
          f"the ELL product and cuSPARSE's differ by {spmv_err}")
    # least time of C @ X: CSR values and column ids, row pointers, X read
    # once, the product written once; 2 nnz m f32 operations
    spmv_bound, spmv_by = _bound(0.0, C.nnz * 8 + (n + 1) * 8 + 2 * n * m * 4,
                                 f32_flops=2.0 * C.nnz * m)
    spmv_row = {"n": n, "m": m, "dmax": int(idx.shape[1]), "nnz": int(C.nnz),
                "ell_ms": cuda_ms(lambda: spmv(X)), "cusparse_csr_ms": cuda_ms(lambda: C_t @ X),
                "bound_ms": spmv_bound, "bound_by": spmv_by, "max_abs_diff": spmv_err}

    # dense in its device window: a cloud on the blob through pc_vert_robust
    pts = _blob_samples(p["mesh"], DENSE_POINTS, seed=0)
    check(DENSE_DEVICE_WINDOW[0] < DENSE_POINTS <= DENSE_DEVICE_WINDOW[1], "not in the window")
    Ld, Mdn = robust_laplacian(pts, local_triangulation(pts))
    ev_h, _ = shift_invert_eigenpairs(Ld, Mdn, DENSE_K)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ev_d, phi_d = solve_generalized_eigenproblem(Ld, Mdn, DENSE_K, method="dense", device="cuda")
    dense_s = time.perf_counter() - t0
    dense_peak = torch.cuda.max_memory_allocated() - base
    inv_d = 1.0 / np.sqrt(Mdn.diagonal())
    c_norm = float(abs(sparse.diags(inv_d) @ Ld @ sparse.diags(inv_d)).sum(axis=1).max())
    dense_err = float(np.abs(ev_d - ev_h).max())
    dense_orth, _ = _eig_quality(Ld, Mdn, ev_d, phi_d)
    eps32 = float(np.finfo(np.float32).eps)
    check(dense_peak >= 4 * DENSE_POINTS ** 2, f"dense ran no device eigh (peak {dense_peak} B)")
    check(dense_err <= DENSE_EPS_MULT * eps32 * c_norm,
          f"dense eigenvalues {dense_err} off (> {DENSE_EPS_MULT} eps32 ||C|| = "
          f"{DENSE_EPS_MULT * eps32 * c_norm})")

    # LOBPCG at k=10, f32 on a sparse CUDA tensor
    Li, Mi = build_laplacian(icosphere(2), "cotan")
    t0 = time.perf_counter()
    ev_l, _ = solve_generalized_eigenproblem(Li, Mi, 10, method="lobpcg", tol=1e-7,
                                             device="cuda")
    lobpcg_s = time.perf_counter() - t0
    ev_li = shift_invert_eigenpairs(Li, Mi, 10)[0]
    lob_err = np.abs(ev_l - ev_li)
    check(np.all(lob_err <= 1e-3 * np.abs(ev_li) + 1e-4), f"lobpcg off shift_invert: {lob_err}")

    emit("spectral", native_libs=libs,
         chefsi={"n": n, "k": k, "s": chefsi_s, **stats,
                 "peak_device_bytes_beyond_base": chefsi_peak, "eig_rel_err": rel,
                 "eig_rel_tol": EIG_REL, "m_orth_err": orth, "rel_residual": res,
                 "max_principal_angle_deg": float(angles.max()), "separated_span": span,
                 "span_max_angle_deg": span_angle},
         spmv=spmv_row,
         dense={"n": DENSE_POINTS, "k": DENSE_K, "s": dense_s,
               "peak_device_bytes_beyond_base": dense_peak,
                "max_abs_err": dense_err, "rel_err_of_largest": dense_err / ev_h.max(),
                "bound": DENSE_EPS_MULT * eps32 * c_norm, "c_norm_gershgorin": c_norm,
                "m_orth_err": dense_orth},
         lobpcg={"n": Li.shape[0], "k": 10, "s": lobpcg_s, "max_abs_err": float(lob_err.max())})


def _shot_leg(p, mesh):
    """compute_shot on the HQ blob, then shot_blob.yaml (SHOT rows, k_in
    352, no fused_mlp) for 2 epochs through the eager step, counters set to
    0 just before and read just after, and the eval CLI on the test split
    through the forward kernel."""
    import pickle

    import torch

    from intrinsic_neural_fields_tpu_torch import compute_shot
    from intrinsic_neural_fields_tpu_torch import eval as eval_cli
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (kernel_launches,
                                                                 reset_kernel_launches)
    from intrinsic_neural_fields_tpu_torch.render.renderer import make_renderer_from_config
    from intrinsic_neural_fields_tpu_torch.train import (Trainer, get_data, get_model_and_optim,
                                                         get_renderer)
    from intrinsic_neural_fields_tpu_torch.train.steps import eager_step

    shot_path = os.path.join(p["root"], "shot", "blob_shot.npy")
    t0 = time.perf_counter()
    E = compute_shot.main([shot_path, p["mesh_path"]])
    shot_s = time.perf_counter() - t0
    check(E.shape == (mesh.num_vertices, 352) and np.isfinite(E).all(), f"SHOT {E.shape}")
    config = _family_config(p, "shot_blob", "shot_blob", 2)
    config["data"]["eigenfunctions_path"] = shot_path
    model, opt = get_model_and_optim(config, mesh)
    data = get_data(config, mesh)
    rec = Recorder()
    trainer = Trainer(model, opt, "L1", get_renderer(config, model, mesh), data, mesh, config,
                      writer=rec)
    check(model.in_dim == 352 and not trainer.fused_mlp, "shot_blob: not the eager k_in 352 leg")
    reset_kernel_launches()
    eager_step.launches = 0
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches, eager = kernel_launches(), eager_step.launches
    nb = data["train"].n // config["training"]["batch_size"]
    check(launches["fused_adam"] == eager == 2 * nb and sum(launches.values()) == 2 * nb,
          f"shot_blob: not one eager step and one Adam launch per step: {launches}, {eager}")
    losses = rec.values("Train_Loss")
    check(len(losses) == 2 and losses[1] < losses[0], f"shot_blob: loss did not fall {losses}")

    cfg_path = _write_config(p["root"], "shot_blob_config.yaml", config)
    test_dir = os.path.join(p["root"], "shot_blob_test_eval")
    reset_kernel_launches()
    eval_cli.main([test_dir, cfg_path, p["data"], "test"])
    torch.cuda.synchronize()
    eval_launches = kernel_launches()["fused_mlp_fwd"]
    check(eval_launches > 0, "shot_blob: the eval CLI did not launch the forward kernel")
    with open(os.path.join(test_dir, "evaluation_metrics.pkl"), "rb") as f:
        test_psnr = float(np.mean([m["psnr"] for m in pickle.load(f).values()]))
    test_views = _dataset_views(p, "test")
    r_k = make_renderer_from_config(config)
    psnr_kp = _render_vs_plain(r_k, make_renderer_from_config(config, infer="plain"), test_views)
    check(psnr_kp >= PSNR_MIN, f"shot_blob: kernel vs plain render {psnr_kp} < {PSNR_MIN} dB")
    rays = rec.values("Train Rays-per-sec")
    emit("family_train", recipe="shot_blob", k_in=model.in_dim, epochs=2, steps_per_epoch=nb,
         compute_shot_s=shot_s, path_s=path_s, train_loss=losses,
         val_psnr=rec.values("Val Epoch-PSNR"), test_psnr_eval_cli=test_psnr,
         train_rays_per_s_best=max(rays), launches=launches, eager_steps=eager,
         psnr_kernel_vs_plain_min=psnr_kp, eval_launches=eval_launches)
    leg = render_leg_of(r_k, [v["camCv2world"] for v in test_views], test_views[0]["K"])
    return launches["fused_adam"], eval_launches, leg


def phase_cloud(p):
    """The point-cloud path: make_transfer_targets --targets cloud (the
    HQ blob's 10,242 vertices as a faceless PLY, its local triangulation,
    the pc_vert_robust operator, a SMOKE_K_BASIS shift-invert basis), the
    triangulation and the iDT timed alone on the native cores, then
    texture_transfer onto cloud.ply with --laplacian_type pc_vert_robust
    through the kernel (launches counted) and the plain twin; then the SHOT
    leg. Returns each path's forward launches, shot_blob's Adam launches
    and the SHOT forward leg."""
    import pickle

    import torch

    from intrinsic_neural_fields_tpu_torch import make_transfer_targets, texture_transfer
    from intrinsic_neural_fields_tpu_torch.geometry.intrinsic_delaunay import (
        build_double_cover, intrinsic_delaunay)
    from intrinsic_neural_fields_tpu_torch.geometry.laplacian import (_edge_lengths,
                                                                      _mollify_lengths)
    from intrinsic_neural_fields_tpu_torch.geometry.mesh import load_mesh
    from intrinsic_neural_fields_tpu_torch.geometry.pointcloud import local_triangulation
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (kernel_launches,
                                                                 reset_kernel_launches)

    root = p["root"]
    tdir = os.path.join(root, "transfer")
    t0 = time.perf_counter()
    make_transfer_targets.main(["--out_dir", tdir, "--src_dataset", p["data"], "--src_efuncs",
                                p["efuncs_path"], "--src_subdivisions", "5", "--targets",
                                "cloud", "--k_basis", str(SMOKE_K_BASIS)])
    targets_s = time.perf_counter() - t0
    cloud = os.path.join(tdir, "cloud.ply")
    pts = load_mesh(cloud).vertices
    t0 = time.perf_counter()
    faces = local_triangulation(pts)
    localtri_s = time.perf_counter() - t0
    fc, lc = build_double_cover(faces.astype(np.int64),
                                _mollify_lengths(_edge_lengths(pts, faces.astype(np.int64))))
    t0 = time.perf_counter()
    _, _, flips = intrinsic_delaunay(fc, lc)
    idt_s = time.perf_counter() - t0

    config = _hq_train_config(p, "out", 5)
    cfg_path = os.path.join(root, "hq_config.yaml")
    args = [cloud, os.path.join(tdir, "source_efuncs_full.npy"),
            os.path.join(tdir, "efuncs_full_cloud.npy"), os.path.join(tdir, "corr_cloud.npy")]
    out = os.path.join(root, "transfer_cloud")
    reset_kernel_launches()
    t0 = time.perf_counter()
    texture_transfer.main(["--config_path", cfg_path, "--target_mesh", args[0],
                           "--laplacian_type", "pc_vert_robust", "--source_efuncs_full", args[1],
                           "--target_efuncs_full", args[2], "--correspondence", args[3],
                           "--eval_dataset", p["data"], "--eval_split", "test", "--out_dir", out])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = kernel_launches()["fused_mlp_fwd"]
    check(launches > 0, "the cloud transfer eval did not launch the forward kernel")
    with open(os.path.join(out, "evaluation_metrics.pkl"), "rb") as f:
        metrics = pickle.load(f)
    eval_psnr = float(np.mean([m["psnr"] for m in metrics.values()]))
    check(np.isfinite(eval_psnr), f"cloud transfer eval {metrics}")
    r_k = texture_transfer.build_transferred_renderer(config, *args, "pc_vert_robust")
    r_p = texture_transfer.build_transferred_renderer(config, *args, "pc_vert_robust",
                                                      infer="plain")
    psnr_kp = _render_vs_plain(r_k, r_p, _dataset_views(p, "test"))
    check(psnr_kp >= PSNR_MIN, f"cloud transfer kernel vs plain PSNR {psnr_kp} < {PSNR_MIN}")
    emit("cloud", target="cloud", points=int(pts.shape[0]), k_basis=SMOKE_K_BASIS,
         targets_s=targets_s, localtri_s=localtri_s, localtri_faces=int(faces.shape[0]),
         idt_s=idt_s, idt_cover_faces=int(fc.shape[0]), idt_flips=int(flips),
         eval_psnr=eval_psnr, coarse_eval_psnr=p["coarse_eval_psnr"],
         eval_dssim_rescaled=float(np.mean([m["dssim_rescaled"] for m in metrics.values()])),
         psnr_kernel_vs_plain_min=psnr_kp, cli_s=cli_s, launches=launches)
    shot_adam, shot_eval, shot_leg = _shot_leg(p, p["mesh"])
    return {"cloud_transfer_eval": launches, "shot_eval": shot_eval}, shot_adam, shot_leg


def _viewdep_xyz_check(mesh, test_views, cams, K):
    """A seeded view-dependent field over xyz (viewdep_intrinsic_blob.yaml's
    view_dependence section): its renders through fused_mlp_fwd_viewdep
    at k_in 3 against the plain twin's (equal masks, >= 50 dB), the
    kernel's launches counted just around the kernel renders; then the
    kernel against its twin on 8,192 of its encoded hit rows, timed."""
    import torch

    from intrinsic_neural_fields_tpu_torch.models import make_model
    from intrinsic_neural_fields_tpu_torch.ops.fused_mlp import (fused_apply_viewdep,
                                                                 fused_apply_viewdep_plain,
                                                                 kernel_launches,
                                                                 reset_kernel_launches)
    from intrinsic_neural_fields_tpu_torch.ops.interpolate import interpolate_vertex_features
    from intrinsic_neural_fields_tpu_torch.render.renderer import Renderer

    model = make_model({"feature_strategy": "xyz", **HQ, "view_dependence": VIEWDEP}, seed=0,
                       mesh=mesh)
    r_k = Renderer(model, mesh, None, H=256, W=256)
    r_p = Renderer(model, mesh, None, H=256, W=256, infer="plain")
    reset_kernel_launches()
    for v in test_views:
        r_k.render(v["camCv2world"], v["K"], eval_render=True)
    torch.cuda.synchronize()
    launches = kernel_launches()["fused_mlp_fwd_viewdep"]
    check(launches > 0, "the view-dependent xyz field did not launch fused_mlp_fwd_viewdep")
    psnr_kp = _render_vs_plain(r_k, r_p, test_views)
    check(psnr_kp >= PSNR_MIN, f"view-dependent xyz kernel vs plain {psnr_kp} < {PSNR_MIN} dB")
    vids, bary, valid, _, dirs, faces = r_k.trace_view(cams[0], K)
    with torch.no_grad():
        x = r_k.field.encode(interpolate_vertex_features(
            r_k.features, vids[valid], bary[valid]))[:8192].contiguous()
        venc = r_k.field.view_fn(dirs[valid], faces[valid])[:8192].contiguous()
    fw, B = r_k.weights, x.shape[0]
    check(B == 8192, f"only {B} hit rays in the view")
    diff = (fused_apply_viewdep(fw, x, venc) - fused_apply_viewdep_plain(fw, x, venc)).abs()
    check(diff.max().item() <= TOL, f"fused_mlp_fwd_viewdep at k_in 3: {diff.max().item()}")
    bound, bound_by = mlp_bound_ms(fw, B)
    row = {"k": 3, "B": B, "max_abs_err": diff.max().item(),
           "ms": cuda_ms(lambda: fused_apply_viewdep(fw, x, venc)),
           "plain_ms": cuda_ms(lambda: fused_apply_viewdep_plain(fw, x, venc)),
           "bound_ms": bound, "bound_by": bound_by}
    emit("viewdep_xyz", render_launches=launches, psnr_kernel_vs_plain_min=psnr_kp, **row)
    return {"render": launches}, row


def profile_train_epoch(train_leg, leg):
    """Device time by kernel and busy share over one profiled epoch of a
    train leg; the port's kernels the profiler saw, by name, must be exactly
    num_batches fwd_bwd and num_batches wgrad with Adam. The profiler's own
    hooks lengthen the host's part of the epoch, so an epoch before it runs
    without the profiler, a pair of CUDA events around its train_epoch
    call: their device time over that epoch's wall time
    (`replay_share_of_wall`; the epoch's few order and hyper copies fall
    inside the pair, beside its graph replay)."""
    import torch

    from intrinsic_neural_fields_tpu_torch.utils.jax_random import PRNGKey, fold_in

    train_epoch, state, data = train_leg.train_epoch, train_leg.state, train_leg.data
    nb, B = train_leg.steps_per_epoch, train_leg.batch
    graph = train_epoch.graph
    before, after = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    before.record()
    _, m = train_epoch(state, fold_in(PRNGKey(0), 98), data, nb, B)
    after.record()
    float(m["loss"])
    plain_wall_ms = 1e3 * (time.perf_counter() - t0)
    replay_ms = before.elapsed_time(after)
    replays = graph.replays
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with PaddedProfile() as p:
        t0 = time.perf_counter()
        start.record()
        _, m = train_epoch(state, fold_in(PRNGKey(0), 99), data, nb, B)
        stop.record()
        float(m["loss"])
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_kernel, counts, port, margins = _profiled_kernels(p, leg)
    device_us = sum(by_kernel.values())
    check(port == {"fwd_bwd": nb, "wgrad_adam": nb},
          f"{leg}: the profiled epoch ran other than {nb} fwd_bwd and {nb} wgrad_adam: "
          f"{port}, {margins}")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    emit("profile_train", leg=leg, steps=nb, wall_ms_per_step=wall_us / 1e3 / nb,
         device_ms_per_step=device_us / 1e3 / nb, device_busy_share=device_us / wall_us,
         events_ms_per_step=start.elapsed_time(stop) / nb, port_kernels_seen=port,
         other_device_events=sum(counts.values()) - sum(port.values()),
         record_margins=margins, unprofiled_wall_ms_per_step=plain_wall_ms / nb,
         unprofiled_replay_ms_per_step=replay_ms / nb,
         replay_share_of_wall=replay_ms / plain_wall_ms,
         graph_replays=graph.replays - replays,
         top_kernels_ms_per_step=[[name[:70], us / 1e3 / nb] for name, us in top])


def profile_eager_steps(run, leg, steps=NEUTEX_PROFILE_STEPS):
    """Device time by kernel and busy share over `steps` eager steps of a
    self-loss or BatchNorm leg (autograd, then the standalone Adam kernel):
    the port's kernels the profiler saw must be exactly one fused_adam per
    step."""
    import torch

    from intrinsic_neural_fields_tpu_torch.utils.jax_random import PRNGKey, fold_in

    train_epoch, state, data, B = run
    torch.cuda.synchronize()
    with PaddedProfile() as p:
        t0 = time.perf_counter()
        _, m = train_epoch(state, fold_in(PRNGKey(0), 97), data, steps, B)
        float(m["loss"])
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_kernel, counts, port, margins = _profiled_kernels(p, leg)
    device_us = sum(by_kernel.values())
    check(port == {"fused_adam": steps},
          f"{leg}: the profiled steps ran other than {steps} fused_adam: {port}, {margins}")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    emit("profile_train", leg=leg, steps=steps, wall_ms_per_step=wall_us / 1e3 / steps,
         device_ms_per_step=device_us / 1e3 / steps, device_busy_share=device_us / wall_us,
         port_kernels_seen=port, device_kernels_per_step=sum(counts.values()) / steps,
         record_margins=margins,
         top_kernels_ms_per_step=[[name[:70], us / 1e3 / steps] for name, us in top])


def profile_dp_epoch(run, leg):
    """Device time by kernel and busy share over one profiled data-parallel
    epoch (a per-step host loop): the port's kernels the profiler saw must
    be D num_batches each of fwd_bwd, the grads-only wgrad and the Adam
    kernel; the unprofiled epoch's wall time beside it."""
    import torch

    from intrinsic_neural_fields_tpu_torch.utils.jax_random import PRNGKey, fold_in

    train_epoch, state, data = run.train_epoch, run.state, run.data
    nb, B = run.steps_per_epoch, run.batch
    D = len(train_epoch.devices)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, m = train_epoch(state, fold_in(PRNGKey(0), 98), data, nb, B)
    float(m["loss"])
    plain_wall_ms = 1e3 * (time.perf_counter() - t0)
    with PaddedProfile() as p:
        t0 = time.perf_counter()
        _, m = train_epoch(state, fold_in(PRNGKey(0), 99), data, nb, B)
        float(m["loss"])
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_kernel, counts, port, margins = _profiled_kernels(p, leg)
    device_us = sum(by_kernel.values())
    check(port == {"fwd_bwd": D * nb, "wgrad": D * nb, "fused_adam": D * nb},
          f"{leg}: the profiled epoch ran other than {D * nb} of each DP kernel: {port}, "
          f"{margins}")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    emit("profile_train", leg=leg, steps=nb, replicas=D, wall_ms_per_step=wall_us / 1e3 / nb,
         device_ms_per_step=device_us / 1e3 / nb, device_busy_share=device_us / wall_us,
         unprofiled_wall_ms_per_step=plain_wall_ms / nb, port_kernels_seen=port,
         device_kernels_per_step=sum(counts.values()) / nb, record_margins=margins,
         top_kernels_ms_per_step=[[name[:70], us / 1e3 / nb] for name, us in top])


# Kineto keeps a device record only where its timestamps fall inside the
# profiler's window, and on the card's host the device records' clock is
# off the host's: kineto warned of kernels stamped up to 0.48 ms before
# their own launch calls (tools/port_profile_records.py). A host-bound
# epoch's last kernel ends about 0.2 ms before its sync returns, so every
# profiled region idles this long inside the window before and after it.
PROFILE_PAD_S = 0.05


class PaddedProfile:
    """torch.profiler over the CPU and the card, its window padded by pad_s
    of idle host time on both sides of the work in the `with` block (which
    ends with a sync); `prof` is the profiler, `margins()` where the port's
    kernel records fell in it."""

    def __init__(self, pad_s=PROFILE_PAD_S):
        self.pad_s = pad_s

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        time.sleep(self.pad_s)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        time.sleep(self.pad_s)
        return self.prof.__exit__(*exc)

    def margins(self):
        """The port's kernel records by kernel; ms from the work's start to
        the first one's start and from the last one's end to the work's end
        (host clock against the records' stamps); the least ms from a launch
        call to its kernel's start (below 0: stamped before its launch)."""
        import torch

        launched, recs = {}, []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if _port_kernel(e.name()) is not None:
                    recs.append(e)
            elif e.name().startswith(("cuda", "cuLaunch")):
                launched[e.correlation_id()] = e.start_ns()
        if not recs:
            return {"records": {}}
        counts = {}
        for e in recs:
            counts[_port_kernel(e.name())] = counts.get(_port_kernel(e.name()), 0) + 1
        lags = [e.start_ns() - launched[e.correlation_id()] for e in recs
                if e.correlation_id() in launched]
        return {"records": counts,
                "first_after_start_ms": (min(e.start_ns() for e in recs) - self.start_ns) / 1e6,
                "end_after_last_ms": (self.end_ns - max(e.start_ns() + e.duration_ns()
                                                        for e in recs)) / 1e6,
                "launch_to_start_min_ms": min(lags) / 1e6 if lags else None}


def _profiled_kernels(p, leg):
    """Device time and launches by kernel name in a PaddedProfile, the
    port's kernels among them by kernel, and where their records fell."""
    by_kernel, counts = _device_us_by_kernel(p.prof, with_counts=True)
    check(sum(by_kernel.values()) > 0, f"{leg}: the profiler saw no device time")
    port = {}
    for name, n in counts.items():
        kernel = _port_kernel(name)
        if kernel is not None:
            port[kernel] = port.get(kernel, 0) + n
    return by_kernel, counts, port, p.margins()


def _port_kernel(name):
    """Which of the port's train kernels a profiler kernel name is (wgrad's
    Adam instantiation apart from its grads-only one), or None."""
    if "wgrad_kernel" in name:
        return "wgrad_adam" if (", true>" in name or "Lb1E" in name) else "wgrad"
    for kernel in ("fwd_bwd_kernel", "fused_adam_kernel", "fused_mlp_fwd_kernel"):
        if kernel in name:
            return kernel[:-len("_kernel")]
    return None


def _device_us_by_kernel(prof, with_counts=False):
    import torch

    by_kernel, counts = {}, {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + dev_us
            counts[e.key] = counts.get(e.key, 0) + e.count
    return (by_kernel, counts) if with_counts else by_kernel


def profile_frames(r, cams, K):
    """Device busy share and device time by kernel over pipelined frames
    (torch.profiler; its own overhead lengthens the wall time, so the busy
    share is a lower bound)."""
    import torch

    from intrinsic_neural_fields_tpu_torch.utils.pipeline import pipelined_foreach

    torch.cuda.synchronize()
    with PaddedProfile() as p:
        t0 = time.perf_counter()
        pipelined_foreach(cams, lambda c: r.render_async(c, K),
                          lambda _c, h: r.render_fetch(h), depth=2)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_kernel = _device_us_by_kernel(p.prof)
    device_us = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    emit("profile", frames=len(cams), wall_ms_per_frame=wall_us / 1e3 / len(cams),
         device_ms_per_frame=device_us / 1e3 / len(cams),
         device_busy_share=device_us / wall_us,
         top_kernels_ms_per_frame=[[name[:70], us / 1e3 / len(cams)] for name, us in top])


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import intrinsic_neural_fields_tpu_torch  # noqa: F401  (fails outside the repo)

    t_all = time.perf_counter()
    phase_s = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        phase_s[name] = time.perf_counter() - t0
        return out

    smi = timed("device", phase_device)
    prep = timed("hq_prep", phase_hq_prep)
    eval_launches, hq_leg = timed("hq_eval", lambda: phase_hq_eval(prep))
    tp_render = timed("throughput", phase_throughput)
    rows = timed("kernels", lambda: phase_kernels({"hq_eval": hq_leg, "throughput": tp_render}))
    srows = timed("sort_kernel", lambda: phase_sort_kernel(tp_render, hq_leg))
    traces = timed("trace_methods", lambda: phase_trace_methods(tp_render))
    pipe = timed("hq_pipeline", lambda: phase_hq_preprocess(prep))
    train_launches, yard_launches, hq_train_leg = timed("hq_train", lambda: phase_hq_train(pipe))
    jax_ckpt = timed("jax_checkpoint", lambda: phase_jax_checkpoint(pipe, hq_leg, eval_launches))
    # what a seed means: the JAX draws held to their fixture, then an HQ epoch from them
    jax_rand, jax_rand_leg = timed("jax_random", lambda: phase_jax_random(pipe))
    bench_arrays, tput_train = timed("train_throughput", phase_train_throughput)
    timed("bench", lambda: phase_bench(bench_arrays, tp_render, tput_train, smi))
    del bench_arrays
    trows = timed("train_kernels", lambda: phase_train_kernels(
        {"hq_train": hq_train_leg, "train_throughput": tput_train, "jax_random": jax_rand_leg}))
    vd_launches, vd_yard_launches, vd_render, vd_train_leg = timed(
        "viewdep_train", lambda: phase_viewdep_train(pipe))
    vrows = timed("viewdep_kernels", lambda: phase_viewdep_kernels(vd_train_leg, vd_render))
    # the user's path with a trained field: each phase's forward launches
    user_paths = timed("meshroom", lambda: phase_meshroom(pipe))
    user_paths.update(timed("lpips", lambda: phase_lpips(pipe, hq_leg)))
    user_paths.update(timed("transfer", lambda: phase_transfer(pipe)))
    user_paths.update(timed("bake", lambda: phase_bake(pipe)))
    video_paths, vd_view_paths = timed("video", lambda: phase_video(pipe))
    user_paths.update(video_paths)
    # the input families: each recipe's path with its counters set to 0 just
    # before and read just after; then its kernels against their twins
    fam_paths, fam_train_legs, fam_fwd_legs, vd_xyz = timed(
        "families", lambda: phase_families(pipe, pipe["hq_train_rays_per_s"]))
    frows = timed("family_kernels", lambda: phase_kernels(fam_fwd_legs))
    ftrows = timed("family_train_kernels", lambda: phase_train_kernels(fam_train_legs))
    # NeuTex: the mapping pretraining and the recipe's eager step, its own counters
    neutex_paths, neutex_adam, neutex_run = timed("neutex", lambda: phase_neutex(pipe))
    # data-parallel training over a device list, sync-BN and the D-way render
    dp_paths, dp_rows, dp_run, bn_run = timed("dp", lambda: phase_dp(pipe))
    # the point-cloud path and the device eigensolvers
    timed("spectral", lambda: phase_spectral(pipe))
    cloud_paths, shot_adam, shot_leg = timed("cloud", lambda: phase_cloud(pipe))
    user_paths.update(cloud_paths)
    crows = timed("cloud_kernels", lambda: phase_kernels({"shot_blob": shot_leg}))
    # Last: the profiler's hooks may slow host-bound torch code run after it.
    timed("profile", lambda: (profile_frames(tp_render.renderer, tp_render.cams[:4],
                                             tp_render.K),
                              profile_train_epoch(hq_train_leg, "hq_train"),
                              profile_train_epoch(tput_train, "train_throughput"),
                              profile_train_epoch(vd_train_leg, "viewdep_train"),
                              *(profile_train_epoch(fam_train_legs[f], f)
                                for f in FAMILY_RECIPES),
                              profile_eager_steps(neutex_run, "neutex_blob"),
                              profile_dp_epoch(dp_run, "dp_train"),
                              profile_eager_steps(bn_run, "bn_train")))
    check(not any(m.startswith(("jax", "flax", "optax", "msgpack",
                                "intrinsic_neural_fields_tpu."))
                  or m in ("jax", "intrinsic_neural_fields_tpu") for m in sys.modules),
          "the port imported JAX, msgpack or the JAX package")

    main_row = rows[0]  # the render path's shape: 8192-ray chunks at k=512
    pkg = "intrinsic_neural_fields_tpu_torch/csrc/"
    ref = "intrinsic_neural_fields_tpu/ops/fused_mlp.py:"
    kernels = [{
        "name": "fused_mlp_fwd", "route": "cuda", "source": pkg + "fused_mlp_fwd.cu",
        "replaces": ref + "1278",
        "launches": train_launches["fused_mlp_fwd"],
        "launches_by_path": {"hq_eval": eval_launches,
                             "hq_train": train_launches["fused_mlp_fwd"], **user_paths,
                             "jax_checkpoint_forward": jax_ckpt["forward"],
                             "jax_checkpoint_eval": jax_ckpt["eval"],
                             **{f"{f}_eval": fam_paths[f]["eval"] for f in FAMILY_RECIPES},
                             "eval_on_mesh": fam_paths["eval_on_mesh"]["eval"],
                             "dp_render": dp_paths["dp_render"],
                             # the bench's render leg: its last pass of 10 frames
                             "bench_render": sum(tp_render.launches_per_frame)},
        "max_abs_err": max([r["max_abs_err"] for r in rows + frows + crows]
                           + [jax_ckpt["max_abs_err"]]),
        "families": {f'{r["leg"]}_B{r["B"]}': {k: r[k] for k in (
            "k", "B", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
            for r in frows + crows},
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the whole MLP
        "redesigned": True,
    }]
    tail = " (tail=ViewDepTailSpec)"
    # launches: the HQ train path's (fused_adam: true, the main path); the
    # grads-only wgrad and the Adam kernel run on its fused_adam: false
    # path, driven and counted on its own
    sources = {"fused_mlp_fwd_bwd": ("fused_mlp_train.cu", "961", ["634", "700", "1305"]),
               "fused_mlp_wgrad_adam": ("fused_mlp_train.cu", "961", ["1068"]),
               "fused_mlp_wgrad": ("fused_mlp_train.cu", "634", ["700", "1305"]),
               "fused_adam": ("fused_adam.cu", "1068", ["1068" + tail])}
    off_main = {"fused_mlp_wgrad": yard_launches, "fused_adam": yard_launches}
    for name, (src, site, also) in sources.items():
        main = trows["hq_train"][name]  # the HQ recipe's shape: k=512, B=4096
        kernels.append({
            "name": name, "route": "cuda", "source": pkg + src, "replaces": ref + site,
            "also_replaces": [ref + a for a in also],
            "launches": off_main.get(name, train_launches)[name],
            "max_abs_err": max(rs[leg][name]["max_abs_err"] for rs in (trows, ftrows)
                               for leg in rs),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            # the xyz and tf_rff recipes' shapes: k_in 3 and 515, f32 tables
            "families": {leg: {"k": fam_train_legs[leg].state.layout.spec.k_in,
                               **{k: ftrows[leg][name][k] for k in (
                                   "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                   "max_abs_err")}} for leg in ftrows},
        })
        if name in ("fused_mlp_fwd_bwd", "fused_mlp_wgrad_adam"):
            kernels[-1]["launches_by_path"] = {
                "hq_train": train_launches[name],
                "jax_checkpoint_resume": jax_ckpt["resume"][name],
                "jax_random": jax_rand["train"][name],
                **{f: fam_paths[f]["train"][name] for f in FAMILY_RECIPES},
                "bench_train": tput_train.launches[name]}
        if name in dp_paths["dp_train"]:
            kernels[-1].setdefault("launches_by_path", {})["dp_train"] = dp_paths["dp_train"][name]
            # a data-parallel replica's shape: k=512, B=2048 (4096 over two replicas)
            kernels[-1]["dp_train_B2048"] = {k: dp_rows[name][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")}
            kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"],
                                             dp_rows[name]["max_abs_err"])
        if "fused_step_bound_ms" in main:
            kernels[-1]["fused_step_bound_ms"] = main["fused_step_bound_ms"]
        if name in REDESIGNED:
            kernels[-1]["redesigned"] = True
        if name in off_main:
            kernels[-1]["launches_path"] = "hq_train with training.fused_adam: false"
    kernels[-1]["launches_by_path"] = {
        "hq_train": train_launches["fused_adam"], "viewdep_train": vd_launches["fused_adam"],
        "hq_train_fused_adam_false": yard_launches["fused_adam"],
        "viewdep_train_fused_adam_false": vd_yard_launches["fused_adam"],
        "hks_blob": fam_paths["hks_blob"]["train"]["fused_adam"], "shot_blob": shot_adam,
        "neutex_blob": neutex_paths["train"], "neutex_pretrain": neutex_paths["pretrain"],
        "dp_train": dp_paths["dp_train"]["fused_adam"], "bn_train": dp_paths["bn_train"],
        "dp_bn": dp_paths["dp_bn"]}
    kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"],
                                     vrows["fused_adam"]["max_abs_err"], neutex_adam["max_abs_err"])
    kernels[-1]["viewdep"] = {k: vrows["fused_adam"][k] for k in
                              ("ms", "plain_ms", "bound_ms", "library_ms", "n")}
    # at the NeuTex model's 793,482 parameters (its eager step's one launch)
    kernels[-1]["neutex_blob"] = {k: neutex_adam[k] for k in
                                  ("ms", "ms_l2_flushed", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "n")}
    # the slice's kernels: the view-dependent path's shapes (k=512; B=8192
    # render chunks for the forward, B=4096 train blocks)
    vd_sources = {"fused_mlp_fwd_viewdep": ("fused_mlp_fwd.cu", "1240", []),
                  "fused_mlp_fwd_bwd_viewdep": ("fused_mlp_train.cu", "961" + tail,
                                                ["655", "729"]),
                  "fused_mlp_wgrad_adam_viewdep": ("fused_mlp_train.cu", "961" + tail,
                                                   ["1068" + tail]),
                  "fused_mlp_wgrad_viewdep": ("fused_mlp_train.cu", "655", ["729"])}
    for name, (src, site, also) in vd_sources.items():
        main = vrows[name]
        launched = (vd_yard_launches if name == "fused_mlp_wgrad_viewdep" else vd_launches)[name]
        kernels.append({
            "name": name, "route": "cuda", "source": pkg + src, "replaces": ref + site,
            "also_replaces": [ref + a for a in also], "launches": launched,
            "max_abs_err": max(main["max_abs_err"], vrows["extrinsic"][name]),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        })
        if "fused_step_bound_ms" in main:
            kernels[-1]["fused_step_bound_ms"] = main["fused_step_bound_ms"]
        if name in REDESIGNED:
            kernels[-1]["redesigned"] = True
        if name == "fused_mlp_wgrad_viewdep":
            kernels[-1]["launches_path"] = "viewdep_train with training.fused_adam: false"
        if name == "fused_mlp_fwd_viewdep":
            kernels[-1]["launches_by_path"] = {"viewdep_train": launched, **vd_view_paths,
                                               "viewdep_xyz_render":
                                                   fam_paths["viewdep_xyz"]["render"]}
            kernels[-1]["families"] = {"viewdep_xyz_B8192": vd_xyz}
            kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"], vd_xyz["max_abs_err"])
    # the sort: the 512^2 render leg's entry sort (2^18 padded) is the main
    # row; launches are the bitonic_vmem trace's (calls; CUDA launches beside)
    main = srows["render512_entry"]
    vm = traces["bitonic_vmem"]
    kernels.append({
        "name": "bitonic_argsort", "route": "cuda", "source": pkg + "bitonic_argsort.cu",
        "replaces": "intrinsic_neural_fields_tpu/ops/raster.py:350",
        "launches": vm["launches"], "cuda_launches": vm["cuda_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in srows.values()),
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "redesigned": True,
        "by_input": {name: {k: r[k] for k in ("E", "cuda_launches_per_call", "ctas", "ms",
                                             "plain_ms", "bound_ms", "library_ms")}
                     for name, r in srows.items()},
    })
    # the traversal: no TPU kernel (the JAX package's _traverse is XLA); one
    # launch per trace, main row the first orbit view's
    tr = traces["raster_traverse"]
    kernels.append({
        "name": "raster_traverse", "route": "cuda", "source": pkg + "raster_traverse.cu",
        "replaces": None, "stands_for": "intrinsic_neural_fields_tpu/ops/raster.py:576 _traverse",
        "launches": traces["argsort"]["traverse_launches"], "max_abs_err": 0.0,
        "ms": tr[0]["ms"], "plain_ms": tr[0]["plain_ms"], "bound_ms": tr[0]["bound_ms"],
        "bound_by": tr[0]["bound_by"], "library_ms": None,
        "by_input": {f"orbit512_view{r['view']}": {k: r[k] for k in (
            "chunks", "chunks_tested", "ms", "plain_ms", "bound_ms")} for r in tr},
    })
    # the binning: no TPU kernel (the JAX package's _bin_faces is XLA);
    # three launches and two sort calls per trace, main row the first view's
    bn = traces["raster_bin"]
    kernels.append({
        "name": "raster_bin", "route": "cuda", "source": pkg + "raster_bin.cu",
        "replaces": None, "stands_for": "intrinsic_neural_fields_tpu/ops/raster.py:374 _bin_faces",
        "launches": traces["argsort"]["bin_launches"], "max_abs_err": 0.0,
        "ms": bn[0]["ms"], "plain_ms": bn[0]["plain_ms"], "bound_ms": bn[0]["bound_ms"],
        "bound_by": bn[0]["bound_by"], "library_ms": None,
        "by_input": {f"orbit512_view{r['view']}": {k: r[k] for k in (
            "ms", "sort_ms", "binning_ms", "host_ms", "plain_ms", "bound_ms", "lost_faces")}
            for r in bn},
    })
    # the wire image: no TPU kernel (the JAX renderer scatters in numpy);
    # one launch a frame, main row the first orbit view's
    wr = traces["render_wire"]
    kernels.append({
        "name": "render_wire", "route": "cuda", "source": pkg + "render_wire.cu",
        "replaces": None,
        "stands_for": "intrinsic_neural_fields_tpu/render/renderer.py:755-761 the host scatter",
        "launches": wr[0]["launches_per_render"], "max_abs_err": 0.0,
        "ms": wr[0]["ms"], "plain_ms": wr[0]["plain_ms"], "bound_ms": wr[0]["bound_ms"],
        "bound_by": wr[0]["bound_by"], "library_ms": wr[0]["library_ms"],
        "by_input": {f"orbit512_view{r['view']}": {k: r[k] for k in (
            "hits", "ms", "plain_ms", "bound_ms", "library_ms")} for r in wr},
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("done", seconds=time.perf_counter() - t_all, phase_s=phase_s)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
