"""Evaluation entry point of the port (gcc_tpu/cli/test.py; the reference's
test.py:131-163).

    python -m gcc_tpu_torch.cli.test --pretrain_path <ckpt> [flags]

Loads a checkpoint (either package's), rebuilds the pruned architecture
from the ``cfg`` stored inside it (the pruned topology is data,
test.py:140-141), runs the generator over the eval dataset, dumps images to
<checkpoints_dir>/<name>/test_results and reports the metric through the
eval orchestrators. The device is chosen as in ``cli.train``.

``--spatial_shards S`` shards each image's rows over the ranks
(parallel/spatial.py; the count lowered per image height), for every
family but SAGAN, whose z input has no rows (a warning). The ranks are
``cli.train``'s (``mesh_plan``): ``--gpu_ids a,b,...`` one a card,
``--gpu_ids -1 --mesh_shape N`` N Gloo ranks on the CPU. Every rank runs
the loader and the generator passes in step; rank 0 alone writes the
images and the logs and computes the metric. With one rank the flag
degrades to 1 shard, with a warning.
"""

from __future__ import annotations

import os


def dump_cap(cfg):
    """Image-dump cap: ``--ntest N`` wins; with the default ntest=inf SAGAN
    caps at 1000 images (reference test.py:51) and the other families dump
    the whole eval set (test.py:27-28 keeps its cap commented out)."""
    if cfg.ntest != float("inf"):
        return int(cfg.ntest)
    return 1000 if cfg.model == "sagan" else None


def rebuild_engine(cfg, ckpt, device=None):
    from gcc_tpu_torch.cli.train import engine_class
    from gcc_tpu_torch.utils.checkpoint import restore_cfg
    filter_cfgs, channel_cfgs = restore_cfg(ckpt)
    cls = engine_class(cfg.model)
    if "cyclegan" in cfg.model:
        return cls(cfg, cfg_AtoB=filter_cfgs, cfg_BtoA=channel_cfgs,
                   device=device)
    if cfg.model in ("sagan", "srgan"):
        return cls(cfg, filter_cfgs=filter_cfgs, device=device)
    return cls(cfg, filter_cfgs=filter_cfgs, channel_cfgs=channel_cfgs,
               device=device)


def main(argv=None) -> int:
    import torch

    from gcc_tpu_torch import config as config_mod
    from gcc_tpu_torch.cli.train import mesh_plan
    from gcc_tpu_torch.parallel import mesh as pmesh

    cfg = config_mod.parse(argv).replace(isTrain=False)
    plan = mesh_plan(cfg)
    if plan is None:
        return run(cfg)
    kind, cards = plan
    threads = max(1, torch.get_num_threads() // len(cards)) \
        if kind == "cpu" else None
    pmesh.spawn(_rank_run, len(cards), args=(cfg,), device_kind=kind,
                devices=cards, threads=threads)
    return 0


def _rank_run(mesh, cfg) -> None:
    """One rank of a test run over ``mesh_plan``'s ranks."""
    run(cfg, mesh)


def run(cfg, mesh=None) -> int:
    """The test run of one process, or of one rank of ``mesh``."""
    import logging

    from gcc_tpu_torch.cli.train import check_knobs, run_device
    from gcc_tpu_torch.data import create_dataset, to_device, to_host
    from gcc_tpu_torch.eval.orchestrators import evaluate_engine
    from gcc_tpu_torch.utils.checkpoint import load_checkpoint
    from gcc_tpu_torch.utils.image import save_images
    from gcc_tpu_torch.utils.logging import get_logger

    lead = mesh is None or mesh.rank == 0  # writes, logs, scores
    run_dir = os.path.join(cfg.checkpoints_dir, cfg.name)
    os.makedirs(run_dir, exist_ok=True)
    if lead:
        logger = get_logger(os.path.join(run_dir, "logger.log"))
    else:  # the other ranks say only what goes wrong
        logger = logging.getLogger(f"gcc-tpu-torch.rank{mesh.rank}")
        logger.setLevel(logging.WARNING)
    check_knobs(cfg, logger)
    dev = mesh.device if mesh is not None else run_device(cfg)

    sp = max(1, int(cfg.spatial_shards))
    if sp > 1 and cfg.model == "sagan":
        logger.warning("--spatial_shards ignored: SAGAN's z input has no "
                       "spatial axis")
        sp = 1
    elif sp > 1:
        logger.info(f"spatial partitioning: image rows sharded up to "
                    f"{sp}-way (auto-reduced per image height)")
    if not lead and sp == 1:
        return 0  # nothing to run in step with rank 0

    def gen(x, **kw):
        if sp > 1:
            return engine.generate_spatial(state, x, n_spatial=sp, **kw)
        return engine.generate(state, x, **kw)

    if not cfg.pretrain_path or not os.path.exists(cfg.pretrain_path):
        raise FileNotFoundError("pretrain model path must exist")
    ckpt = load_checkpoint(cfg.pretrain_path)
    engine = rebuild_engine(cfg, ckpt, device=dev)
    state = engine.init_state(seed=cfg.seed)
    engine.load_net_params(state, ckpt, load_discriminator=False)
    logger.info(f"loaded the model from {cfg.pretrain_path}")

    # dump images (test.py:25-58); visual sets as get_current_visuals
    # (Pix2Pix.py:686-692, SAGAN, SRGAN, CycleGAN)
    result_dir = os.path.join(run_dir, "test_results")
    loader = create_dataset(cfg.replace(batch_size=1, serial_batches=True,
                                        no_flip=True), seed=0)
    n, cap = 0, dump_cap(cfg)
    for batch in loader:
        if cfg.model == "sagan":
            fake = engine.generate(state, to_device(batch["z"], dev))
            visuals = {"fake_img": to_host(fake),
                       "real_img": batch["real_img"]}
            name = batch["img_path"][0]
        elif cfg.model == "srgan":
            fake = gen(to_device(batch["lr"], dev))
            visuals = {"fake_hr": to_host(fake), "real_hr": batch["hr"]}
            name = batch["hr_names"][0]
        elif "cyclegan" in cfg.model:
            A, B = to_device(batch["A"], dev), to_device(batch["B"], dev)
            fake_B = gen(A, direction="AtoB")
            rec_A = gen(fake_B, direction="BtoA")
            fake_A = gen(B, direction="BtoA")
            rec_B = gen(fake_A, direction="AtoB")
            visuals = {"real_A": batch["A"], "fake_B": to_host(fake_B),
                       "rec_A": to_host(rec_A), "real_B": batch["B"],
                       "fake_A": to_host(fake_A), "rec_B": to_host(rec_B)}
            name = os.path.basename(batch["A_paths"][0])
        else:
            kin, kout = ("B", "A") if cfg.direction == "BtoA" else ("A", "B")
            fake = gen(to_device(batch[kin], dev))
            visuals = {"real_A": batch[kin], "fake_B": to_host(fake),
                       "real_B": batch[kout]}
            name = os.path.basename(batch["A_paths"][0])
        if lead:
            save_images(result_dir, visuals, name,
                        aspect_ratio=cfg.aspect_ratio)
        n += 1
        if cap is not None and n >= cap:
            break
    logger.info(f"dumped {n} results to {result_dir}")

    perf = evaluate_engine(cfg, engine, state, logger,
                           epoch=ckpt.get("epoch"), lead=lead)
    if lead:
        logger.info(f"metrics: {perf}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
