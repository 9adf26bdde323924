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

The run is on the card unless ``--gpu_ids -1`` asks for the CPU.
``--gpu_ids 0,1,...`` or ``--mesh_shape N`` trains data-parallel, one
process a card (parallel/mesh.py: NCCL, global BatchNorm and losses, one
gradient all-reduce per update); ``--gpu_ids -1 --mesh_shape N`` runs N
Gloo ranks on the CPU. The count is the largest at most the request that
divides ``--batch_size``, the global batch. Rank 0 logs, evaluates and
writes the checkpoints; the other ranks wait for it at a barrier with a
timeout. A packed root (``cli.prepare``) streams uint8 batches that
normalize on the device; ``--device_cache`` keeps the packed store on the
device (``auto``: a store of at most 25 % of the card's memory, on a card)
and then each iteration ships only the transform parameters.
``--memory_guard`` measures the first step's peak device memory before the
run goes on (utils/memory_guard.py; ``auto`` on a card, ``strict`` aborts
when it does not fit; each rank measures its shard). ``--mesh_shape a,b``
asks for a*b ranks, as the JAX package's training mesh does.
``--spatial_shards S`` shards the rows of the epoch-end eval's images over
the ranks (parallel/spatial.py): in a data-parallel run every rank runs the
eval's generator passes and rank 0 alone computes the metric; in one
process the flag degrades to 1 shard. ``--compute_dtype`` (bf16 by
default, as in the JAX package) casts every family's train and val
batches, and the engine computes in their dtype. ``--compile_cache`` is
XLA's and ignored.
"""

from __future__ import annotations

import dataclasses
import json
import logging
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


def _gpu_ids(cfg) -> list:
    return [s.strip() for s in str(cfg.gpu_ids).split(",") if s.strip()]


def run_device(cfg, device=None) -> torch.device:
    """The device of a one-process run: ``device`` when given, else
    ``--gpu_ids``: -1 is the CPU, one id is that card (an error without
    one); several ids raise (only cli.train trains data-parallel)."""
    from gcc_tpu_torch.device import resolve_device
    if device is not None:
        return resolve_device(device)
    ids = _gpu_ids(cfg)
    if ids == ["-1"]:
        return torch.device("cpu")
    if len(ids) != 1:
        raise NotImplementedError(
            f"--gpu_ids {cfg.gpu_ids}: this entry point runs on one card; "
            f"cli.train trains data-parallel (ROADMAP Queue A item 5)")
    resolve_device(None)  # raises without a card
    dev = torch.device("cuda", int(ids[0]))
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"--gpu_ids {ids[0]}: only "
                           f"{torch.cuda.device_count()} CUDA devices")
    torch.cuda.set_device(dev)
    return dev


def check_knobs(cfg, logger) -> None:
    """Log the dtype the run computes in and what is ignored."""
    from gcc_tpu_torch.device import compute_dtype
    dtype = str(compute_dtype(cfg)).replace("torch.", "")
    if not cfg.isTrain:
        what = ("port: evaluates in float32, as the JAX package's eval "
                "does")
    else:
        what = f"port: computes in {dtype} (--compute_dtype {dtype})"
    logger.info(f"{what}; XLA-only --compile_cache "
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
    """Direction swap (models/Pix2Pix.py:453-458) + host NHWC numpy -> NCHW
    tensors on the device in the run's compute dtype (``--compute_dtype``,
    as gcc_tpu/cli/train.py:92-110 casts; SAGAN's numpy z too); path lists
    are dropped.

    Packed datasets deliver uint8 (data/packed.py): those keys go over raw
    (4x fewer host->device bytes) and normalize on the device. Device-cached
    loaders (data/device_cache.py) deliver tensors already there, in their
    own dtype: they pass through."""
    from gcc_tpu_torch.data import to_device
    from gcc_tpu_torch.data.packed import device_normalize
    from gcc_tpu_torch.device import compute_dtype
    dtype = compute_dtype(cfg)
    out, u8 = {}, {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            if v.dtype == np.uint8:
                u8[k] = torch.from_numpy(v).to(device)
            else:
                out[k] = to_device(v, device).to(dtype)
        elif isinstance(v, torch.Tensor):
            out[k] = v
    out.update(device_normalize(u8, dtype))
    if "A" in out and cfg.direction == "BtoA":
        out["A"], out["B"] = out["B"], out["A"]
    return out


def _head(x, n: int):
    """The first n items of a batch: every array or tensor of a dict or a
    tuple cut along dim 0 (paths, scalars and the rest as they are)."""
    if isinstance(x, dict):
        return {k: _head(v, n) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_head(v, n) for v in x)
    if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim > 0:
        return x[:n]
    return x


def mesh_plan(cfg):
    """The data-parallel layout a run asks for: None (one process, no
    mesh), or (device kind, the ranks' card ids; None each on the CPU).

    ``--gpu_ids -1 --mesh_shape N``: N ranks on the CPU. ``--gpu_ids
    a,b,...``: one rank a card; with ``--mesh_shape N`` the first N of
    them, or N cards from a single id up. ``--mesh_shape a,b`` asks for
    a*b ranks (gcc_tpu/cli/train.py:233-237). Cards that this host lacks
    raise."""
    ids = _gpu_ids(cfg)
    n = int(np.prod(cfg.mesh_shape)) if cfg.mesh_shape else None
    if ids == ["-1"]:
        return None if n is None else ("cpu", [None] * n)
    if n is None and len(ids) == 1:
        return None
    cards = [int(i) for i in ids]
    if n is not None:
        if len(cards) == 1:
            cards = list(range(cards[0], cards[0] + n))
        elif n > len(cards):
            raise ValueError(f"--mesh_shape {n} over --gpu_ids "
                             f"{cfg.gpu_ids}: more ranks than cards")
        cards = cards[:n]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if max(cards) >= have or len(set(cards)) != len(cards):
        raise NotImplementedError(
            f"--gpu_ids {cfg.gpu_ids}: data parallelism (ROADMAP Queue A "
            f"item 5) over cards {cards} needs them, and this host has "
            f"{have}; --gpu_ids -1 --mesh_shape N runs N ranks on the CPU")
    return "cuda", cards


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


def run(cfg, device=None, mesh=None) -> int:
    """One training run; ``device`` None takes ``--gpu_ids`` (the card)
    and ``--mesh_shape``; ``mesh`` is set in a rank of a data-parallel run
    (``run_mesh``)."""
    from gcc_tpu_torch.utils.logging import get_logger

    run_dir = os.path.join(cfg.checkpoints_dir, cfg.name)
    os.makedirs(run_dir, exist_ok=True)
    if mesh is None or mesh.rank == 0:
        logger = get_logger(os.path.join(run_dir, "logger.log"))
    else:  # the other ranks say only what goes wrong
        logger = logging.getLogger(f"gcc-tpu-torch.rank{mesh.rank}")
        logger.setLevel(logging.WARNING)
    check_knobs(cfg, logger)
    if device is None and mesh is None:
        plan = mesh_plan(cfg)
        if plan is not None:
            return run_mesh(cfg, *plan, logger=logger)
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
        return _train(cfg, dev, run_dir, logger, preempt, mesh)
    finally:
        torch.autograd.set_detect_anomaly(anomaly)
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)


def run_mesh(cfg, kind: str, cards, logger) -> int:
    """A data-parallel run over ``cards`` (``mesh_plan``): as many ranks as
    divide ``--batch_size``, each a process that runs ``run`` under its
    mesh; one rank runs in this process, through the collectives all the
    same. SIGTERM here reaches every rank, and they stop together."""
    from gcc_tpu_torch.parallel import mesh as pmesh
    world = len(cards)
    while cfg.batch_size % world:
        world -= 1
    where = "the CPU (Gloo)" if kind == "cpu" else f"cards {cards[:world]}"
    logger.info(f"mesh: {world} data-parallel ranks on {where} (requested "
                f"{len(cards)}; the largest count that divides --batch_size "
                f"{cfg.batch_size}), {cfg.batch_size // world} rows a rank")
    if world == 1:
        device = "cpu" if kind == "cpu" else f"cuda:{cards[0]}"
        mesh = pmesh.init_distributed(
            0, 1, f"tcp://127.0.0.1:{pmesh.free_port()}", device)
        try:
            return run(cfg, mesh.device, mesh)
        finally:
            pmesh.shutdown()
    threads = max(1, torch.get_num_threads() // world) \
        if kind == "cpu" else None
    pmesh.spawn(_rank_run, world, args=(cfg,), device_kind=kind,
                devices=cards[:world], threads=threads)
    return 0


def _rank_run(mesh, cfg) -> None:
    """One rank of ``run_mesh``."""
    run(cfg, mesh.device, mesh)


def _train(cfg, dev, run_dir, logger, preempt, mesh=None) -> int:
    from gcc_tpu_torch.data import create_split_dataset
    from gcc_tpu_torch.data.device_cache import (DeviceCacheLoader,
                                                 FusedCachedStep,
                                                 InfiniteParams)
    from gcc_tpu_torch.data.loader import InfiniteLoader
    from gcc_tpu_torch.eval.orchestrators import evaluate_engine, row_sharded
    from gcc_tpu_torch.ops.mask import named_alphas, sparsity_report
    from gcc_tpu_torch.parallel.mesh import any_rank, replicate_state
    from gcc_tpu_torch.utils.best_info import BestInfo, maximize_metric
    from gcc_tpu_torch.utils.checkpoint import (ckpt_name, load_state,
                                                save_checkpoint, save_state)
    from gcc_tpu_torch.utils.logging import JsonlWriter
    from gcc_tpu_torch.utils.memory_guard import check_step
    from gcc_tpu_torch.utils.numerics import assert_finite_losses
    from gcc_tpu_torch.utils.schedule import (Plateau, ema_beta_for_epoch,
                                              lr_for_epoch)

    lead = mesh is None or mesh.rank == 0  # logs, evaluates, saves
    if lead:
        _write_opt(os.path.join(run_dir, "opt.txt"), cfg)
    jsonl = JsonlWriter(os.path.join(run_dir, "metrics.jsonl")) \
        if cfg.log_jsonl and lead else None
    best = BestInfo(cfg)
    logger.info(f"device: {dev}"
                + (f" ({torch.cuda.get_device_name(dev)})"
                   if dev.type == "cuda" else ""))

    engine = build_engine(cfg, logger, device=dev)
    engine.mesh = mesh
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

    # rank 0's state on every rank, checked by checksum
    state = replicate_state(state, mesh)

    def save_train_state(meta: dict) -> None:
        if not lead:
            return
        save_state(state_path, state)
        with open(meta_path, "w") as f:
            json.dump(meta, f)

    train_loader, val_loader = create_split_dataset(
        cfg, seed=cfg.seed, device=dev, logger=logger, mesh=mesh)
    rows = cfg.batch_size // (1 if mesh is None else mesh.world)
    logger.info(f"The number of training images = "
                f"{len(train_loader.dataset)}")

    darts_mode = (cfg.darts_discriminator and engine.distill
                  and not cfg.generator_only)
    # device-resident loaders: the iteration takes the transform parameters
    # and materializes its batches on the device (FusedCachedStep)
    fused = None
    if isinstance(train_loader, DeviceCacheLoader) and (
            not darts_mode or isinstance(val_loader, DeviceCacheLoader)):
        fused = FusedCachedStep(engine, train_loader,
                                val_loader if darts_mode else None,
                                swap_ab=cfg.direction == "BtoA")
        logger.info("device_cache: batches materialize from the device "
                    "store inside the training iteration")
    # the memory guard measures the first iteration's step (auto: on a
    # card; the CPU has no peak statistics)
    guard_pending = cfg.memory_guard in ("on", "strict") or (
        cfg.memory_guard == "auto" and dev.type == "cuda")
    total_epochs = cfg.n_epochs + cfg.n_epochs_decay
    total_iters = 0
    # metric-driven LR (torch ReduceLROnPlateau parity; fed the epoch-end
    # eval metric each save_epoch_freq, negated when the metric maximizes)
    plateau = Plateau(cfg.lr) if cfg.lr_policy == "plateau" else None
    prof = None
    if cfg.profile_steps > 0 and lead:
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
        val_stream = (InfiniteParams(val_loader)
                      if fused is not None and darts_mode
                      else InfiniteLoader(val_loader))
        lr = plateau.lr if plateau else lr_for_epoch(cfg, epoch)
        ema_beta = ema_beta_for_epoch(cfg, epoch)
        arch_lr = _arch_lr(cfg, epoch, plateau)
        # generators: closed when the epoch ends, so a loader's threads
        # stop on an early return too
        batches = (train_loader.iter_param_batches() if fused is not None
                   else iter(train_loader))
        waited, n_iters = 0.0, 0
        t_wait = time.perf_counter()
        try:
            for i, data in enumerate(batches):
                val_data = next(val_stream) if darts_mode else None
                waited += time.perf_counter() - t_wait
                iter_start = time.time()
                if fused is not None:
                    # the device store: ship only the transform parameters
                    runner, batch = fused, data[0]
                    val_batch = val_data[0] if darts_mode else None
                else:
                    runner, batch = engine, set_input(cfg, data, dev)
                    val_batch = (set_input(cfg, val_data, dev)
                                 if darts_mode else None)

                def step(n, runner=runner, batch=batch, val_batch=val_batch):
                    """This iteration's step on the first n items."""
                    if darts_mode:
                        return runner.train_arch_step(
                            state, _head(batch, n), _head(val_batch, n), lr,
                            ema_beta, arch_lr)
                    return runner.train_step(state, _head(batch, n), lr)

                if guard_pending:
                    guard_pending = False
                    check_step(step, state, rows, dev, logger=logger,
                               strict=cfg.memory_guard == "strict")
                state, losses = step(rows)
                total_iters += cfg.batch_size
                n_iters += 1

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

                if any_rank(mesh, preempt["flag"]):
                    save_train_state({"epoch": epoch - 1,
                                      "preempted_in_epoch": epoch})
                    logger.info(
                        f"SIGTERM: full train state saved mid-epoch {epoch} "
                        f"(iters {total_iters}); --continue_train restarts "
                        f"epoch {epoch}")
                    return 0
                t_wait = time.perf_counter()
        finally:
            val_stream.close()
            batches.close()
        if n_iters:
            logger.info(f"data: waited {1e3 * waited / n_iters:.3f} ms an "
                        f"iteration for its batches ({n_iters} iterations)")

        if epoch % cfg.save_epoch_freq == 0:
            scalar = None
            if lead:
                # FID / mIoU with the evaluator weights, else the proxy
                current_perf = evaluate_engine(cfg, engine, state, logger,
                                               epoch)
                _save_best(cfg, engine, state, best, current_perf, epoch,
                           logger)
                if current_perf is not None:
                    scalar = (float(np.mean(list(current_perf.values())))
                              if isinstance(current_perf, dict)
                              else float(current_perf))
                    if maximize_metric(cfg):
                        scalar = -scalar
                save_train_state({"epoch": epoch})
                if epoch == total_epochs:
                    save_checkpoint(
                        ckpt_name(ckpt_dir, epoch),
                        engine.checkpoint_payload(state, epoch, current_perf))
            elif row_sharded(cfg):
                # the eval's rows sharded over the ranks: this rank runs the
                # generator passes beside rank 0, and no metric
                evaluate_engine(cfg, engine, state, logger, epoch,
                                lead=False)
            if mesh is not None:
                # the other ranks wait for rank 0's eval and take its metric
                scalar = json.loads(mesh.barrier(f"epoch/{epoch}",
                                                 json.dumps(scalar)))
            if plateau is not None and scalar is not None:
                new_lr = plateau.step(scalar)
                if new_lr != lr:
                    logger.info(f"plateau: lr {lr:.7f} -> {new_lr:.7f}")
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
        if any_rank(mesh, preempt["flag"]):
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
