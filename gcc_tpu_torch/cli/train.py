"""Training entry point of the port (gcc_tpu/cli/train.py; the reference's
train.py:75-174).

    python -m gcc_tpu_torch.cli.train --dataroot ... [flags]

Workflow: parse flags -> build engine (pruning the generator to the MACs
budget first when --scale_prune/--norm_prune) -> loaders -> epoch loop:
per-iteration cooperative train step (teacher + student), the DARTS arch
step on a val batch, periodic loss logging, epoch-end eval -> best
checkpoint, sparsity report, LR/ema schedules. Same flags as the JAX CLI.
The epoch-end metric is FID with ``--inception_path`` (the TF-FID ``.pth``
or its ingested ``.npz``) and real statistics, mIoU on cityscapes with
``--drn_path``, else the proxies; the best checkpoint follows it.

The run is on the card unless ``--gpu_ids -1`` asks for the CPU; one card
only. The JAX package's XLA knobs (meshes, spatial shards, the memory guard
and the device cache) are refused when switched on; their ``auto``/``off``
values and ``--compute_dtype`` are logged once: the port computes in fp32.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Dict

import numpy as np
import torch


def engine_class(model: str):
    from gcc_tpu_torch.engines.cyclegan import CycleGANEngine
    from gcc_tpu_torch.engines.pix2pix import Pix2PixEngine
    from gcc_tpu_torch.engines.sagan import SAGANEngine
    from gcc_tpu_torch.engines.srgan import SRGANEngine
    if "pix2pix" in model:
        return Pix2PixEngine
    if "cyclegan" in model:
        return CycleGANEngine
    if model == "sagan":
        return SAGANEngine
    if model == "srgan":
        return SRGANEngine
    raise NotImplementedError(f"model {model!r} is not implemented")


def run_device(cfg, device=None) -> torch.device:
    """The device of a run: ``device`` when given, else ``--gpu_ids``: -1 is
    the CPU, one id is that card (an error without one), several ids raise
    (data parallelism is ROADMAP Queue A item 7)."""
    from gcc_tpu_torch.device import resolve_device
    if device is not None:
        return resolve_device(device)
    ids = [s.strip() for s in str(cfg.gpu_ids).split(",") if s.strip()]
    if ids == ["-1"]:
        return torch.device("cpu")
    if len(ids) != 1:
        raise NotImplementedError(
            f"--gpu_ids {cfg.gpu_ids}: the port runs on one card; data "
            f"parallelism is ROADMAP Queue A item 7")
    resolve_device(None)  # raises without a card
    dev = torch.device("cuda", int(ids[0]))
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"--gpu_ids {ids[0]}: only "
                           f"{torch.cuda.device_count()} CUDA devices")
    torch.cuda.set_device(dev)
    return dev


def check_knobs(cfg, logger) -> None:
    """Refuse the JAX package's XLA-only features; log what is ignored."""
    refused = []
    if cfg.mesh_shape:
        refused.append(f"--mesh_shape {cfg.mesh_shape}")
    if int(cfg.spatial_shards) > 1:
        refused.append(f"--spatial_shards {cfg.spatial_shards}")
    if cfg.memory_guard in ("on", "strict"):
        refused.append(f"--memory_guard {cfg.memory_guard}")
    if cfg.device_cache == "on":
        refused.append("--device_cache on")
    if refused:
        raise NotImplementedError(
            f"{', '.join(refused)}: not in the port yet (ROADMAP Queue A: "
            f"meshes and spatial shards are item 7, the memory guard and the "
            f"device cache follow the training run)")
    logger.info(
        f"port: computes in float32 (--compute_dtype {cfg.compute_dtype} "
        f"ignored); XLA-only --memory_guard {cfg.memory_guard}, "
        f"--device_cache {cfg.device_cache}, --compile_cache "
        f"{cfg.compile_cache or 'off'} ignored")


def build_engine(cfg, logger=None, device=None):
    """Engine + pruned cfgs, mirroring train.py:84-91 + prune_util.prune."""
    from gcc_tpu_torch import compress
    from gcc_tpu_torch.utils.checkpoint import load_checkpoint

    log = logger.info if logger else print
    cls = engine_class(cfg.model)
    if not (cfg.norm_prune or cfg.scale_prune):
        return cls(cfg, device=device)
    if cfg.target_budget is None:
        raise RuntimeError("the target budget must exist")
    if cfg.pretrain_path is None:
        raise RuntimeError("the pretrain path must exist")
    ckpt = load_checkpoint(cfg.pretrain_path)
    tol = compress.tolerance_for(cfg.dataroot)
    mode = "scale" if cfg.scale_prune else "norm"
    if "cyclegan" in cfg.model:
        if "horse2zebra" in cfg.dataroot:
            # the reference overrides its own search with these cfgs
            # (utils/prune_util.py:120-121)
            cfg_a, cfg_b = compress.cyclegan_reference_cfgs()
        else:
            cfg_a, _ = compress.prune_mobile_resnet(
                ckpt["G_A"]["params"], target_budget_g=cfg.target_budget,
                tolerance_g=0.05, image_size=cfg.load_size)
            cfg_b, _ = compress.prune_mobile_resnet(
                ckpt["G_B"]["params"], target_budget_g=cfg.target_budget_B,
                tolerance_g=0.05, image_size=cfg.load_size)
        log(f"pruned cfg_AtoB: {cfg_a}")
        log(f"pruned cfg_BtoA: {cfg_b}")
        return cls(cfg, cfg_AtoB=cfg_a, cfg_BtoA=cfg_b, device=device)
    g_params = ckpt["G"]["params"]
    if cfg.backbone == "resnet" and "pix2pix" in cfg.model:
        fc, g = compress.prune_mobile_resnet_union(
            g_params, target_budget_g=cfg.target_budget, tolerance_g=tol,
            image_size=cfg.load_size)
        log(f"pruned filter_cfgs: {fc} ({g:.6f} GMACs)")
        return cls(cfg, filter_cfgs=fc, device=device)
    if cfg.model == "sagan":
        fc, g = compress.prune_sagan(g_params,
                                     target_budget_g=cfg.target_budget,
                                     tolerance_g=tol, z_dim=cfg.z_dim,
                                     image_size=cfg.crop_size)
        log(f"pruned filter_cfgs: {fc} ({g:.6f} GMACs)")
        return cls(cfg, filter_cfgs=fc, device=device)
    if cfg.model == "srgan":
        fc, g = compress.prune_srresnet(
            g_params, mode=mode, n_channels=cfg.ngf,
            target_budget_g=cfg.target_budget, tolerance_g=tol,
            lr_size=cfg.image_size // cfg.upscale_factor)
        log(f"pruned filter_cfgs: {fc} ({g:.6f} GMACs)")
        return cls(cfg, filter_cfgs=fc, device=device)
    # pix2pix U-Net (the unprunable stem/innermost widths are the model's
    # ngf, Pix2Pix.py:825-826)
    fc, cc, g = compress.prune_unet(
        g_params, mode=mode, ngf=cfg.ngf, target_budget_g=cfg.target_budget,
        tolerance_g=tol, num_downs=cfg.num_downs, image_size=cfg.load_size)
    log(f"pruned filter_cfgs: {fc}")
    log(f"pruned channel_cfgs: {cc} ({g:.6f} GMACs)")
    return cls(cfg, filter_cfgs=fc, channel_cfgs=cc, device=device)


def set_input(cfg, batch: Dict, device) -> Dict[str, torch.Tensor]:
    """Direction swap (models/Pix2Pix.py:453-458) + host NHWC numpy ->
    float32 NCHW tensors on the device; path lists are dropped."""
    from gcc_tpu_torch.data import to_device
    out = {k: to_device(v, device) for k, v in batch.items()
           if isinstance(v, np.ndarray)}
    if "A" in out and cfg.direction == "BtoA":
        out["A"], out["B"] = out["B"], out["A"]
    return out


def main(argv=None) -> int:
    from gcc_tpu_torch import config as config_mod
    return run(config_mod.parse(argv))


def _write_opt(path: str, cfg) -> None:
    # print_options parity (options/options.py:130-152)
    with open(path, "w") as f:
        f.write("----------------- Options ---------------\n")
        for fld in dataclasses.fields(cfg):
            f.write(f"{fld.name}: {getattr(cfg, fld.name)}\n")
        f.write("----------------- End -------------------\n")


def _load_teachers(cfg, engine, state, logger) -> None:
    """--initial_path (the student G), --teacher_initial_path (the teacher
    G) and --distillation_path (the frozen teacher's G and D). CycleGAN's
    nets come per direction: G_A/G_B (D_A/D_B) into tg_a/tg_b (td_a/td_b)."""
    from gcc_tpu_torch.utils.checkpoint import load_checkpoint
    from gcc_tpu_torch.utils.weights import load_jax_variables
    pairs = ([("_a", "_A"), ("_b", "_B")] if "cyclegan" in cfg.model
             else [("", "")])
    if cfg.initial_path:
        engine.load_net_params(state, load_checkpoint(cfg.initial_path),
                               load_discriminator=False)
        logger.info(f"loaded initial G from {cfg.initial_path}")
    if cfg.teacher_initial_path and engine.distill:
        tck = load_checkpoint(cfg.teacher_initial_path)
        for ours, theirs in pairs:
            load_jax_variables(state.nets[f"tg{ours}"], tck[f"G{theirs}"])
        logger.info(f"loaded teacher G from {cfg.teacher_initial_path}")
    if cfg.normal_distillation and cfg.distillation_path:
        # frozen-teacher distillation from a fixed checkpoint
        tck = load_checkpoint(cfg.distillation_path)
        for ours, theirs in pairs:
            load_jax_variables(state.nets[f"tg{ours}"], tck[f"G{theirs}"])
            if tck.get(f"D{theirs}") is not None:
                load_jax_variables(state.nets[f"td{ours}"],
                                   tck[f"D{theirs}"])
        logger.info(f"loaded frozen teacher from {cfg.distillation_path}")


def _arch_lr(cfg, epoch: int, plateau) -> float:
    """The DARTS LR of an epoch: --arch_lr_step's per-model step rules
    (SAGAN.py:348-353 step/40, Pix2Pix.py:432-437 and CycleGAN
    step/(n_epochs-1), SRGAN the model's own LR policy, SRGAN.py:370-371,
    385), or the plateau's factor."""
    from gcc_tpu_torch.utils.schedule import multiplier_after_steps
    if cfg.arch_lr_step and plateau:
        return cfg.arch_lr * (plateau.lr / cfg.lr)
    steps = max(epoch - cfg.epoch_count, 0)
    if cfg.arch_lr_step and cfg.model == "srgan":
        return cfg.arch_lr * multiplier_after_steps(
            cfg.lr_policy, steps, n_epochs=cfg.n_epochs,
            n_epochs_decay=cfg.n_epochs_decay,
            lr_decay_iters=cfg.lr_decay_iters)
    if cfg.arch_lr_step and steps > 0:
        # before the first scheduler step the multiplier is 1 whatever the
        # step size: pix2pix's is 0 at --n_epochs 1, where gcc_tpu divides
        # by it (ROADMAP Queue C)
        decay_iters = 40 if cfg.model == "sagan" else cfg.n_epochs - 1
        if decay_iters < 1:
            raise ValueError(
                f"--arch_lr_step steps every n_epochs - 1 = {decay_iters} "
                f"epochs: give --n_epochs 2 or more to train past epoch "
                f"{cfg.epoch_count}")
        return cfg.arch_lr * multiplier_after_steps(
            "step", steps, lr_decay_iters=decay_iters)
    return cfg.arch_lr


def run(cfg, device=None) -> int:
    """One training run; ``device`` None takes ``--gpu_ids`` (the card)."""
    from gcc_tpu_torch.utils.logging import get_logger

    run_dir = os.path.join(cfg.checkpoints_dir, cfg.name)
    os.makedirs(run_dir, exist_ok=True)
    logger = get_logger(os.path.join(run_dir, "logger.log"))
    check_knobs(cfg, logger)
    dev = run_device(cfg, device)

    # Graceful preemption: SIGTERM finishes the in-flight iteration, saves
    # the full train state and exits 0, so --continue_train restarts the
    # interrupted epoch. Installed before the engine build. Outside the main
    # thread (embedded use) signals cannot be caught: the feature is off.
    preempt = {"flag": False}
    prev_sigterm = None
    try:
        prev_sigterm = signal.signal(
            signal.SIGTERM, lambda _s, _f: preempt.update(flag=True))
    except ValueError:
        pass
    anomaly = torch.is_anomaly_enabled()
    if cfg.debug_nans:
        torch.autograd.set_detect_anomaly(True)
        logger.info("autograd anomaly detection enabled (--debug_nans)")
    try:
        return _train(cfg, dev, run_dir, logger, preempt)
    finally:
        torch.autograd.set_detect_anomaly(anomaly)
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)


def _train(cfg, dev, run_dir, logger, preempt) -> int:
    from gcc_tpu_torch.data import create_split_dataset
    from gcc_tpu_torch.data.loader import InfiniteLoader
    from gcc_tpu_torch.eval.orchestrators import evaluate_engine
    from gcc_tpu_torch.ops.mask import named_alphas, sparsity_report
    from gcc_tpu_torch.utils.best_info import BestInfo, maximize_metric
    from gcc_tpu_torch.utils.checkpoint import (ckpt_name, load_state,
                                                save_checkpoint, save_state)
    from gcc_tpu_torch.utils.logging import JsonlWriter
    from gcc_tpu_torch.utils.numerics import assert_finite_losses
    from gcc_tpu_torch.utils.schedule import (Plateau, ema_beta_for_epoch,
                                              lr_for_epoch)

    _write_opt(os.path.join(run_dir, "opt.txt"), cfg)
    jsonl = JsonlWriter(os.path.join(run_dir, "metrics.jsonl")) \
        if cfg.log_jsonl else None
    best = BestInfo(cfg)
    logger.info(f"device: {dev}"
                + (f" ({torch.cuda.get_device_name(dev)})"
                   if dev.type == "cuda" else ""))

    engine = build_engine(cfg, logger, device=dev)
    state = engine.init_state(seed=cfg.seed)
    _load_teachers(cfg, engine, state, logger)

    # true resume: full state incl. optimizer moments + EMA + dropout rng
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    state_path = os.path.join(ckpt_dir, "train_state.ckpt")
    meta_path = os.path.join(ckpt_dir, "train_state.json")
    start_epoch = cfg.epoch_count
    if cfg.continue_train and os.path.exists(state_path):
        load_state(state_path, state)
        with open(meta_path) as f:
            start_epoch = json.load(f)["epoch"] + 1
        logger.info(f"resumed full train state from {state_path} "
                    f"(continuing at epoch {start_epoch})")

    def save_train_state(meta: dict) -> None:
        save_state(state_path, state)
        with open(meta_path, "w") as f:
            json.dump(meta, f)

    train_loader, val_loader = create_split_dataset(cfg, seed=cfg.seed)
    logger.info(f"The number of training images = "
                f"{len(train_loader.dataset)}")

    darts_mode = (cfg.darts_discriminator and engine.distill
                  and not cfg.generator_only)
    total_epochs = cfg.n_epochs + cfg.n_epochs_decay
    total_iters = 0
    # metric-driven LR (torch ReduceLROnPlateau parity; fed the epoch-end
    # eval metric each save_epoch_freq, negated when the metric maximizes)
    plateau = Plateau(cfg.lr) if cfg.lr_policy == "plateau" else None
    prof = None
    if cfg.profile_steps > 0:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        logger.info(f"profiling first {cfg.profile_steps} iterations")

    for epoch in range(start_epoch, total_epochs + 1):
        epoch_start = time.time()
        # epoch-keyed shuffles: resumed runs replay the uninterrupted order
        train_loader.set_epoch(epoch)
        val_loader.set_epoch(epoch)
        # a fresh DARTS val iterator each epoch (train.py:131); it cycles if
        # val is smaller than train
        val_stream = InfiniteLoader(val_loader)
        lr = plateau.lr if plateau else lr_for_epoch(cfg, epoch)
        ema_beta = ema_beta_for_epoch(cfg, epoch)
        arch_lr = _arch_lr(cfg, epoch, plateau)
        try:
            for i, data in enumerate(train_loader):
                iter_start = time.time()
                batch = set_input(cfg, data, dev)
                if darts_mode:
                    val_batch = set_input(cfg, next(val_stream), dev)
                    state, losses = engine.train_arch_step(
                        state, batch, val_batch, lr, ema_beta, arch_lr)
                else:
                    state, losses = engine.train_step(state, batch, lr)
                total_iters += cfg.batch_size

                if cfg.check_numerics:
                    try:
                        assert_finite_losses(losses, epoch=epoch,
                                             iters=total_iters)
                    except FloatingPointError as e:
                        logger.error(str(e))
                        raise

                if prof is not None and i + 1 >= cfg.profile_steps:
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    prof.stop()
                    trace = os.path.join(run_dir, "profile", "trace.json")
                    os.makedirs(os.path.dirname(trace), exist_ok=True)
                    prof.export_chrome_trace(trace)
                    logger.info(f"profiler trace written to {trace}")
                    prof = None

                if total_iters % cfg.print_freq < cfg.batch_size:
                    vals = {k: float(v) for k, v in losses.items()}
                    t_comp = (time.time() - iter_start) / cfg.batch_size
                    msg = " ".join(f"{k}: {v:.3f}" for k, v in vals.items())
                    logger.info(f"(epoch: {epoch}, iters: {total_iters}, "
                                f"time: {t_comp:.3f}) {msg}")
                    if jsonl:
                        jsonl.write({"epoch": epoch, "iters": total_iters,
                                     "lr": lr, **vals})

                if preempt["flag"]:
                    save_train_state({"epoch": epoch - 1,
                                      "preempted_in_epoch": epoch})
                    logger.info(
                        f"SIGTERM: full train state saved mid-epoch {epoch} "
                        f"(iters {total_iters}); --continue_train restarts "
                        f"epoch {epoch}")
                    return 0
        finally:
            val_stream.close()

        if epoch % cfg.save_epoch_freq == 0:
            # FID / mIoU with the evaluator weights, else the proxy
            current_perf = evaluate_engine(cfg, engine, state, logger, epoch)
            _save_best(cfg, engine, state, best, current_perf, epoch, logger)
            if plateau is not None and current_perf is not None:
                scalar = (float(np.mean(list(current_perf.values())))
                          if isinstance(current_perf, dict)
                          else float(current_perf))
                if maximize_metric(cfg):
                    scalar = -scalar
                new_lr = plateau.step(scalar)
                if new_lr != lr:
                    logger.info(f"plateau: lr {lr:.7f} -> {new_lr:.7f}")
            save_train_state({"epoch": epoch})
            if epoch == total_epochs:
                save_checkpoint(
                    ckpt_name(ckpt_dir, epoch),
                    engine.checkpoint_payload(state, epoch, current_perf))
        if cfg.darts_discriminator:
            alphas = {}
            for key in ("d", "d_a", "d_b"):
                if key in state.nets:
                    alphas.update(named_alphas(key, state.nets[key]))
            for name, ratio in sparsity_report(
                    alphas, threshold=cfg.threshold).items():
                logger.info(f"{name} sparsity ratio: {ratio:.2f}")
        logger.info(f"End of epoch {epoch} / {total_epochs} \t "
                    f"Time Taken: {int(time.time() - epoch_start)} sec \t "
                    f"lr: {lr:.7f} ema_beta: {ema_beta:.4f}")
        if preempt["flag"]:
            # SIGTERM during epoch-end eval/save: the epoch is complete, so
            # save with this epoch's number and exit now
            save_train_state({"epoch": epoch})
            logger.info(f"SIGTERM: full train state saved at end of epoch "
                        f"{epoch}; --continue_train resumes at {epoch + 1}")
            return 0
    if prof is not None:  # fewer iterations than --profile_steps
        prof.stop()
    logger.info(best.summary())
    return 0


def _save_best(cfg, engine, state, best, perf, epoch, logger) -> None:
    """Best-metric checkpointing (train.py:14-73). A dict of named metrics
    (CycleGAN's directions, SRGAN's sets) keeps one best per name, in the
    reference's slots: PSNR 0-3, SSIM 4-7 (train.py:47-52)."""
    from gcc_tpu_torch.eval.orchestrators import SR_TEST_SETS
    from gcc_tpu_torch.utils.checkpoint import ckpt_name, save_checkpoint
    if perf is None:
        return
    save_dir = os.path.join(cfg.checkpoints_dir, cfg.name, "checkpoints")
    if isinstance(perf, dict):
        sets = list(SR_TEST_SETS) + ["val"]
        last = len(best.best_metric) - 1
        for i, (name, value) in enumerate(perf.items()):
            if name.endswith(("_psnr", "_ssim")):
                base, kind = name.rsplit("_", 1)
                idx = sets.index(base) if base in sets else 0
                idx = min(idx + (4 if kind == "ssim" else 0), last)
            else:
                idx = min(i, last)
            if best.update(value, epoch, index=idx):
                save_checkpoint(
                    ckpt_name(save_dir, isbest=True, direction=name),
                    engine.checkpoint_payload(state, epoch, value))
                logger.info(f"saving best [{name}] at epoch {epoch}: "
                            f"{value:.4f}")
        return
    if best.update(float(perf), epoch):
        save_checkpoint(
            ckpt_name(save_dir, isbest=True, direction=cfg.direction),
            engine.checkpoint_payload(state, epoch, float(perf)))
        logger.info(f"saving best model at epoch {epoch}: {perf:.4f}")


if __name__ == "__main__":
    raise SystemExit(main())
