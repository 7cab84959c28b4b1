"""Training orchestration (reference trainer.py:18-337), the JAX package's
loop: one ``train_epoch`` and one ``val_epoch`` per epoch (see steps.py;
``parallel.parallelize_trainer`` swaps in data-parallel ones over a device
list), TensorBoard scalars under the reference's tags, periodic vis
renders, best / interval / last / epoch-200 checkpoints and resume (from
the port's checkpoint.pt or the JAX package's checkpoint.ckpt).

As in the JAX package, min_val_loss starts at +inf, not 1.0 (reference
trainer.py:237). The batch order of epoch e is the JAX Trainer's: drawn
from ``fold_in(base_key, e)`` (utils/jax_random.py), base_key being
PRNGKey(config seed), or the rng_key of the checkpoint the run resumed
from, so a resumed run replays the uninterrupted run's order (a blocks
epoch's order is drawn on the host while the epoch before it runs on the
card: ``train_epoch.prefetch``). Every
checkpoint.pt the Trainer writes carries base_key; one without it (the
upstream trainer's) resumes with PRNGKey(config seed), as the JAX Trainer
does (JAX train/trainer.py:279-299).

An xyz / ff / rff TextureField with ``training.fused_mlp`` trains as the
JAX Trainer trains it (JAX train/trainer.py:91-121, 201-257): every split
is embedded once by the model's own encoder and the epochs run its
``mlp_core_view`` through the kernels; the renders keep the model itself.
A restore whose RFF projection differs from the one the splits were
embedded with embeds them again. When all splits' embedded tables would
exceed ``PRECOMPUTE_BYTES_LIMIT`` the Trainer says so and keeps the
in-forward path (the eager step), the one switch the JAX Trainer makes.
A NeuTex model (``type: neutex``) is never pre-embedded: its state holds
all three networks in module order (``steps.ModuleLayout``), it trains
through the eager step and its vis renders run its module forward on the
mesh's vertex positions.
``training.profile_dir`` writes a torch.profiler trace of epoch
``training.profile_epoch`` (default 1) there.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import replace

import numpy as np
import torch

from .. import resolve_device
from ..data.sampler import (
    PRECOMPUTE_BYTES_LIMIT,
    num_train_batches,
    parse_precompute_dtype,
    pre_embed_ray_data,
    precompute_hit_vencs,
)
from ..evaluation.metrics import epoch_psnr, psnr
from ..models.texture_field import input_encoder_apply, mlp_core_view, view_encoder_apply
from ..ops.fused_mlp import fused_pre_embed_eligible, fused_viewdep_eligible
from ..utils.checkpoint import (
    load_jax_train_checkpoint,
    load_train_checkpoint,
    save_model,
    save_train_checkpoint,
)
from ..utils.jax_random import PRNGKey, fold_in
from .plateau import ReduceLROnPlateau
from .steps import TrainState, batch_stats_of, create_train_state, make_epoch_fns


class ScalarFileWriter:
    """The logger when tensorboardX is not installed: every scalar is one
    JSON line {"tag", "value", "step"} appended to <log_dir>/scalars.jsonl;
    images are dropped."""

    def __init__(self, log_dir):
        self.path = os.path.join(log_dir, "scalars.jsonl")

    def add_scalar(self, tag, value, global_step=None):
        with open(self.path, "a") as f:
            f.write(json.dumps({"tag": tag, "value": float(value), "step": global_step}) + "\n")

    def add_image(self, tag, img, global_step=None):
        pass


def default_writer(log_dir):
    """tensorboardX's SummaryWriter on log_dir, or a ScalarFileWriter there
    when tensorboardX is not installed."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        print(f"tensorboardX not installed: scalars go to {log_dir}/scalars.jsonl")
        return ScalarFileWriter(log_dir)
    return SummaryWriter(log_dir)


class Trainer:
    def __init__(self, model, optimizer, loss_type, renderer, data, mesh, config,
                 writer=None, device="cuda"):
        """model: the TextureField[WithViewDependency] or NeuTex train
        wrapper (its weights start the run); optimizer:
        train.steps.AdamHyper; data: {"train", "val"[, "test"]} RayData on
        `device`; writer: anything with add_scalar/add_image (default:
        ``default_writer`` on <out_dir>/logs)."""
        self.device = resolve_device(device)
        self.model = model
        self.loss_type = loss_type
        self.renderer = renderer
        self.mesh = mesh
        self.config = config
        self.state = create_train_state(model, optimizer, self.device)
        self.shuffle = config["training"].get("shuffle", "full")
        self.fused_mlp = config["training"].get("fused_mlp", False)
        self.train_data = data["train"]
        self.val_data = data["val"]
        self.test_data = data.get("test")
        # The model the epochs run: for a pre-embedded xyz/ff/rff field its
        # mlp_core_view (the same parameters) on the embedded splits.
        self.epoch_model = model
        self._pre_embed_buffers = None
        if self.fused_mlp and fused_pre_embed_eligible(model):
            self._pre_embed_dtype = parse_precompute_dtype(config["data"].get("precompute_dtype"))
            # the raw splits are kept for a re-embed after a restore; the
            # embedding reads the vertex table, never their hit tables
            strip = lambda d: None if d is None else replace(d, hit_features=None)  # noqa: E731
            self._raw_splits = tuple(strip(d) for d in (self.train_data, self.val_data,
                                                        self.test_data))
            if self._apply_pre_embedding():
                self.epoch_model = mlp_core_view(model)
        if (self.fused_mlp and fused_viewdep_eligible(model)
                and self.train_data.feature_strategy == "efuncs"):
            # The view-dependent field's encoding is a fixed function of each
            # cached hit: encode it once, so the train kernels stream it
            # beside the hit features (reference trainer.py:122-150).
            self.train_data = precompute_hit_vencs(
                view_encoder_apply(model), self.train_data, self.state.layout.tail.venc_w,
                dtype=parse_precompute_dtype(config["data"].get("precompute_dtype")))
        self.train_epoch_fn, self.val_epoch_fn = make_epoch_fns(
            self.epoch_model, loss_type, shuffle=self.shuffle, fused=self.fused_mlp,
            fused_adam=config["training"].get("fused_adam", True))

        self.use_lr_scheduler = config["training"].get("use_lr_scheduler", False)
        self.lr_scheduler = ReduceLROnPlateau(factor=0.2)
        self.dataset_type = config["data"].get("type")
        if self.dataset_type not in (None, "meshroom_radial_k3"):
            raise NotImplementedError(f"Unknown dataset type: {self.dataset_type}!")
        self.H = config["data"]["img_height"]
        self.W = config["data"]["img_width"]
        self.val_render_infos = list(zip(config["data"].get("eval_render_input_paths", []),
                                         config["data"].get("eval_render_img_names", [])))

        self.out_dir = config["training"]["out_dir"]
        log_dir = os.path.join(self.out_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        self.writer = default_writer(log_dir) if writer is None else writer

        self.batch_size = config["training"]["batch_size"]
        self.drop_last = config["data"].get("train_drop_last", True)
        self.render_every = config["training"]["render_every"]
        self.print_every = config["training"]["print_every"]
        self.epochs = config["training"]["epochs"]
        self.checkpoint_every = config["training"].get("checkpoint_every")
        self.checkpoint_path = os.path.join(self.out_dir, "checkpoint.pt")
        self.best_model_weights_path = os.path.join(self.out_dir, "model.pt")
        self.model_last_epoch_path = os.path.join(self.out_dir, "model_last_epoch.pt")
        self.best_state_dict = self.state.state_dict()
        self.base_key = PRNGKey(config.get("seed", 0))

    # ------------------------------------------------------------ pre-embedding

    def _apply_pre_embedding(self):
        """Embed every split with the model's encoder as its buffers stand
        (JAX Trainer._apply_pre_embedding). Returns False, leaving the
        splits and the in-forward path, when the tables would exceed the
        precompute budget."""
        dtype = self._pre_embed_dtype
        rows = sum(d.n for d in self._raw_splits if d is not None)
        itemsize = 2 if dtype == torch.bfloat16 else 4
        if rows * self.model.in_dim * itemsize > PRECOMPUTE_BYTES_LIMIT:
            print("fused_mlp: pre-embedded feature tables (all splits) would exceed the "
                  "precompute budget — keeping the in-forward path")
            self.fused_mlp = False
            return False
        enc = input_encoder_apply(self.model)
        train_raw, val_raw, test_raw = self._raw_splits
        self.train_data = pre_embed_ray_data(enc, train_raw, dtype=dtype)
        self.val_data = pre_embed_ray_data(enc, val_raw, dtype=dtype)
        if test_raw is not None:
            self.test_data = pre_embed_ray_data(enc, test_raw, dtype=dtype)
        self._pre_embed_buffers = {k: v.clone() for k, v in self.state.buffers.items()}
        return True

    def _refresh_pre_embedding_after_restore(self):
        """A restored state may carry another RFF projection than the one
        the splits were embedded with (a reference-trained checkpoint brings
        its own B): the model takes the restored buffers, and the splits are
        embedded again when they differ, or the kernels would train against
        the wrong encoding (JAX train/trainer.py:236-257)."""
        self.model.load_state_dict(self.state.buffers, strict=False)
        if self._pre_embed_buffers is None:
            return
        was, now = self._pre_embed_buffers, self.state.buffers
        if set(was) != set(now) or not all(torch.equal(was[k], now[k]) for k in was):
            print("Encoder buffers changed on restore — re-embedding splits...")
            self._apply_pre_embedding()

    # ------------------------------------------------------------ checkpoints

    def _init_or_load_checkpoint(self):
        """Resume from out_dir/checkpoint.pt when present (reference
        trainer.py:214-230), else from the JAX package's checkpoint.ckpt
        (its params, buffers, batch_stats, Adam moments, count and
        hyperparameters, and its rng_key as the base key of the epoch
        orders). A checkpoint.pt without an rng_key keeps PRNGKey(config
        seed). Later checkpoints are written as checkpoint.pt. Returns the
        epoch to start from."""
        if self.checkpoint_every is None:
            return 0
        jax_path = os.path.join(self.out_dir, "checkpoint.ckpt")
        if os.path.exists(self.checkpoint_path):
            print("Restoring from checkpoint...")
            ckpt = load_train_checkpoint(self.checkpoint_path)
        elif os.path.exists(jax_path):
            print(f"Restoring from the JAX package's checkpoint {jax_path}...")
            ckpt = load_jax_train_checkpoint(jax_path, self.config["model"])
        else:
            return 0
        if ckpt["rng_key"] is not None:
            self.base_key = ckpt["rng_key"]
        buffers = self.state.buffers
        self.state = TrainState.from_torch(self.state.layout, ckpt["model_state_dict"],
                                           ckpt["adam"], self.device)
        self.state.buffers = {**buffers, **self.state.buffers}
        print("Done.")
        return ckpt["epoch"] + 1

    # ------------------------------------------------------------ phases

    def evaluate(self, epoch=None):
        metrics = self.val_epoch_fn(self.state, self.val_data, self.batch_size)
        val_loss = float(metrics["loss"])
        val_psnr = float(epoch_psnr(float(metrics["sq_err_per_sample"])))
        self.writer.add_scalar("Val_Loss", val_loss, epoch)
        self.writer.add_scalar("Val Epoch-PSNR", val_psnr, epoch)
        return val_loss, val_psnr

    def test(self):
        """Evaluate the best model on the test split."""
        if self.test_data is None:
            return None
        best = TrainState(self.state.layout,
                          self.state.layout.flat_from_state_dict(self.best_state_dict, self.device),
                          self.state.mu, self.state.nu, self.state.count, self.state.hyper,
                          self.state.buffers, batch_stats_of(self.best_state_dict, self.device))
        test_loss = float(self.val_epoch_fn(best, self.test_data, self.batch_size)["loss"])
        self.writer.add_scalar("Test Loss", test_loss)
        print(f"Test Loss: {test_loss}")
        return test_loss

    def write_vis_metrics_to_tensorboard(self, img_name, rendered_img, gt_img, obj_mask_1d, epoch):
        self.writer.add_image(img_name, rendered_img.transpose(2, 0, 1), global_step=epoch)
        self.writer.add_scalar(f"{img_name}_psnr", psnr(rendered_img, gt_img, obj_mask_1d), epoch)
        mean_distance_2d = 1.0 - np.mean(np.abs(rendered_img - gt_img), -1)
        mean_distance_2d = np.repeat(mean_distance_2d[None, ...], 3, axis=0)
        self.writer.add_image(f"{img_name}_2d_mean_distance", mean_distance_2d, global_step=epoch)
        fake = rendered_img.reshape(-1, 3)[obj_mask_1d]
        real = gt_img.reshape(-1, 3)[obj_mask_1d]
        self.writer.add_scalar(f"{img_name}_dist", np.abs(real - fake).sum(), epoch)

    def _render_view_for_tensorboard(self, input_path, img_name, epoch):
        from ..utils.io import imread, load_cameras, load_obj_mask_as_numpy

        obj_mask_1d = load_obj_mask_as_numpy(input_path).reshape(-1)
        camCv2world, K = load_cameras(input_path)
        # the trace of a fixed vis view is the same every epoch: cached
        rendered_img = self.renderer.render(camCv2world, K, obj_mask_1d=obj_mask_1d,
                                            cache_key=input_path)
        gt_img = imread(os.path.join(input_path, "image", "000.png")).astype(np.float32) / 255.0
        shape = gt_img.shape
        gt_img = gt_img.reshape(-1, 3)
        gt_img[~obj_mask_1d] = 1.0
        self.write_vis_metrics_to_tensorboard(img_name, rendered_img, gt_img.reshape(shape),
                                              obj_mask_1d, epoch)

    def _render_views_for_tensorboard_meshroom(self, epoch):
        """The vis views of a Meshroom run: every view of data.vis_split in
        data.vis_dataset_path, rendered through the undistorted coordinates
        (reference trainer.py:389-407)."""
        from ..data.datasets import MeshroomRadialK3Dataset

        vis = MeshroomRadialK3Dataset(self.config["data"]["vis_dataset_path"],
                                      self.config["data"]["vis_split"], H=self.H, W=self.W)
        for idx, item in enumerate(vis):
            rendered = self.renderer.render(
                item["camCv2world"], item["K"], distortion_coeffs=item["distortion_params"],
                distortion_type=item["distortion_type"], cache_key=f"meshroom_vis_{idx}")
            self.write_vis_metrics_to_tensorboard(f"meshroom_radial_k3_view_{idx}", rendered,
                                                  item["img"], item["obj_mask_1d"], epoch)

    def _visualize(self, epoch):
        self.renderer.update_variables(self.state.state_dict())
        print("Visualizing...")
        vis_start = time.time()
        if self.dataset_type == "meshroom_radial_k3":
            self._render_views_for_tensorboard_meshroom(epoch)
        else:
            for i, (input_path, _img_name) in enumerate(self.val_render_infos):
                self._render_view_for_tensorboard(input_path, f"img{i:03d}", epoch)
        print(f"Done with visualizations after {time.time() - vis_start} seconds.")

    # ------------------------------------------------------------ train

    def _profiler(self):
        """A torch.profiler over the host and, on the card, the device."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities)

    def train(self):
        print("Starting training...")
        epoch_start_idx = self._init_or_load_checkpoint()
        self._refresh_pre_embedding_after_restore()
        n = self.train_data.n
        num_batches = num_train_batches(n, self.batch_size, self.drop_last)
        if num_batches <= 0:
            raise ValueError("training set smaller than one batch")
        min_val_loss = float("inf")
        profile_dir = self.config["training"].get("profile_dir")
        profile_epoch = self.config["training"].get("profile_epoch", 1)

        for epoch in range(epoch_start_idx, self.epochs):
            profiling = profile_dir is not None and epoch == profile_epoch
            with (self._profiler() if profiling else contextlib.nullcontext()) as prof:
                t0 = time.time()
                self.state, metrics = self.train_epoch_fn(
                    self.state, fold_in(self.base_key, epoch), self.train_data,
                    num_batches, self.batch_size)
                prefetch = getattr(self.train_epoch_fn, "prefetch", None)
                if prefetch is not None and epoch + 1 < self.epochs:
                    # the next epoch's block order, drawn while this one runs on the card
                    prefetch(fold_in(self.base_key, epoch + 1), self.train_data, num_batches,
                             self.batch_size)
                train_loss = float(metrics["loss"])  # waits for the epoch's device work
                train_mse = float(metrics["sq_err_per_sample"])
                t1 = time.time()
            if profiling:
                os.makedirs(profile_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(profile_dir,
                                                      f"epoch_{epoch:04d}.pt.trace.json"))
                print(f"Wrote profiler trace for epoch {epoch} to {profile_dir}")

            rays_per_sec = num_batches * self.batch_size / max(t1 - t0, 1e-9)
            self.writer.add_scalar("Train Rays-per-sec", rays_per_sec, epoch)
            train_psnr = float(epoch_psnr(train_mse))
            self.writer.add_scalar("Train_Loss", train_loss, epoch)
            self.writer.add_scalar("Train Epoch-PSNR", train_psnr, epoch)

            val_loss, val_psnr = self.evaluate(epoch)
            if val_loss < min_val_loss:
                min_val_loss = val_loss
                self.best_state_dict = self.state.state_dict()
                save_model(self.best_model_weights_path, self.best_state_dict)

            if self.use_lr_scheduler:
                self.state.set_lr(self.lr_scheduler.step(val_loss, self.state.hyper.learning_rate))

            if epoch == 0 or (epoch + 1) % self.print_every == 0:
                print(
                    f"Epoch: {epoch + 1} / {self.epochs}, Train Loss: {train_loss}, "
                    f"Train PSNR: {train_psnr}, Val Loss: {val_loss}, Val PSNR: {val_psnr} "
                    f"Epoch Time: {t1 - t0}s ({rays_per_sec / 1e6:.2f}M rays/s)"
                )

            if epoch == 0 or (epoch + 1) % self.render_every == 0:
                self._visualize(epoch)

            if self.checkpoint_every is not None and epoch % self.checkpoint_every == 0:
                print("Saving checkpoint...")
                save_train_checkpoint(self.checkpoint_path, epoch, self.state, self.base_key)
                print("Done.")

            if epoch > 0 and (epoch + 1) == 200:
                # persistent snapshot at epoch 200 (reference trainer.py:315-331)
                print(f"Persisting checkpoint at {epoch}...")
                save_train_checkpoint(os.path.join(self.out_dir, f"checkpoint_{epoch}.pt"),
                                      epoch, self.state, self.base_key)
                save_model(os.path.join(self.out_dir, f"best_model_checkpoint_{epoch}.pt"),
                           self.best_state_dict)
                print("Done.")

        self.test()
        print("Done.")
        save_model(self.model_last_epoch_path, self.state.state_dict())
