"""The runs that tests/test_torch_parallel.py and tests/test_torch_fused_d.py
hold against each other: one engine's seeded iterations over one global
batch stream, in one process or as one rank of a data-parallel mesh.

Spawned ranks import this module by name, so it imports torch and the port
only (no JAX): a rank starts in a few seconds.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch

from gcc_tpu_torch.config import Config
from gcc_tpu_torch.engines.cyclegan import CycleGANEngine
from gcc_tpu_torch.engines.pix2pix import Pix2PixEngine
from gcc_tpu_torch.engines.sagan import SAGANEngine
from gcc_tpu_torch.engines.srgan import SRGANEngine
from gcc_tpu_torch.ops.layers import BatchNorm
from gcc_tpu_torch.parallel.mesh import (
    batch_mean, reduce_gradients, replicate_state, scope, shard_batch,
    state_checksum,
)
from gcc_tpu_torch.utils.weights import from_jax_nets, to_jax_nets

GLOBAL_BATCH = 4
N_STEPS = 2
LR = 2e-4

# name -> (engine, Config kwargs, batch maker (rng, n) -> dict of NCHW numpy)
_IMG = lambda rng, n, s: (rng.rand(n, 3, s, s) * 2 - 1).astype(np.float32)  # noqa: E731


def _ab(size):
    return lambda rng, n: {"A": _IMG(rng, n, size), "B": _IMG(rng, n, size)}


FAMILIES = {
    # U-Net with BatchNorm, online distillation, DARTS and dropout (6 downs:
    # depth 4 drops)
    "unet": (Pix2PixEngine, dict(
        model="pix2pix", backbone="unet", ngf=4, ndf=4, teacher_ngf=8,
        teacher_ndf=8, crop_size=64, num_downs=6, gan_mode="hinge",
        online_distillation=True, darts_discriminator=True, lambda_L1=100.0,
        lambda_content=50.0, lambda_gram=1e4), _ab(64)),
    # MobileResnet with the fused stage blocks (80 px keeps the gate open)
    "resnet_fused": (Pix2PixEngine, dict(
        model="pix2pix", backbone="resnet", ngf=4, ndf=4, teacher_ngf=8,
        teacher_ndf=8, crop_size=80, gan_mode="hinge", fused_resblock="on",
        online_distillation=True, darts_discriminator=True, lambda_L1=100.0,
        lambda_content=50.0, lambda_gram=1e4), _ab(80)),
    "cyclegan": (CycleGANEngine, dict(
        model="cyclegan", ngf=4, ndf=4, teacher_ngf=4, teacher_ndf=4,
        crop_size=32, gan_mode="lsgan", online_distillation=True,
        darts_discriminator=True, lambda_content=0.01, lambda_gram=10.0,
        pool_size=4), _ab(32)),
    "sagan": (SAGANEngine, dict(
        model="sagan", ngf=4, ndf=4, teacher_ngf=8, teacher_ndf=8,
        crop_size=64, z_dim=16, gan_mode="hinge", online_distillation=True,
        darts_discriminator=True, lambda_content=1.0, lambda_gram=1.0),
        lambda rng, n: {"z": rng.randn(n, 16).astype(np.float32),
                        "real_img": _IMG(rng, n, 64)}),
    "srgan": (SRGANEngine, dict(
        model="srgan", ngf=4, ndf=4, teacher_ngf=8, teacher_ndf=8,
        image_size=32, upscale_factor=4, gan_mode="vanilla",
        online_distillation=True, darts_discriminator=True,
        lambda_content=0.1, lambda_gram=0.1),
        lambda rng, n: {"lr": _IMG(rng, n, 8), "hr": _IMG(rng, n, 32)}),
}


def batches(family: str, seed: int = 3, n_steps: int = N_STEPS,
            batch: int = GLOBAL_BATCH, size=None) -> list:
    """The global (train, val) batches of each step, numpy NCHW (A and B
    of ``size`` px when given)."""
    make = _ab(size) if size else FAMILIES[family][2]
    rng = np.random.RandomState(seed)
    return [(make(rng, batch), make(rng, batch)) for _ in range(n_steps)]


def engine(family: str, mesh=None, device="cpu", **overrides):
    cls, kw, _ = FAMILIES[family]
    return cls(Config(**{**kw, **overrides}), device=device, mesh=mesh)


def _tensors(batch: dict, device, dtype) -> dict:
    return {k: torch.from_numpy(v).to(device=device, dtype=dtype)
            for k, v in batch.items()}


def run(family: str, mesh=None, device="cpu", nets0=None, arch=True,
        dtype=torch.float32, steps=None, **overrides) -> dict:
    """``family``'s iterations (train step, then the arch step when
    ``arch``) over its seeded global batches, from the seed-0 init (or
    ``nets0``, JAX-layout nets); under ``mesh`` on this rank's rows. Returns
    the per-step metrics, the final nets in the JAX layout, the state's
    host copy, its checksum and the mesh's counters per step."""
    eng = engine(family, mesh, device, **overrides)
    state = eng.init_state(seed=0) if nets0 is None \
        else from_jax_nets(eng, nets0)
    state = replicate_state(state, mesh)
    metrics, counters = [], []
    for tb, vb in steps or batches(family):
        tb = shard_batch(_tensors(tb, device, dtype), mesh)
        vb = shard_batch(_tensors(vb, device, dtype), mesh)
        if mesh is not None:
            mesh.reset_counters()
        if arch:
            state, m = eng.train_arch_step(state, tb, vb, LR, 0.9)
        else:
            state, m = eng.train_step(state, tb, LR)
        metrics.append({k: float(v) for k, v in m.items()})
        if mesh is not None:
            counters.append(dict(mesh.counters))
    return {"metrics": metrics, "nets": to_jax_nets(state),
            "state": state.state_dict(), "checksum": state_checksum(state),
            "counters": counters}


def bn_run(x, w, dtype, rows=slice(None)) -> dict:
    """Forward and backward of a BatchNorm(5) of fixed weights on ``x``'s
    ``rows``, its loss a batch mean (global under a mesh, as in every
    engine), its parameter gradients through ``reduce_gradients``."""
    bn = BatchNorm(5)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, 5))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, 5))
    xt = torch.from_numpy(x[rows]).to(getattr(torch, dtype)) \
        .requires_grad_(True)
    y = bn(xt)
    loss = batch_mean(y.float() * torch.from_numpy(w[rows]))
    gx, gw, gb = torch.autograd.grad(loss, [xt, bn.weight, bn.bias])
    gw, gb = reduce_gradients([gw, gb])
    return {"y": y.float().detach().numpy(), "gx": gx.float().numpy(),
            "gw": gw.numpy(), "gb": gb.numpy(),
            "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}


def rank_runs(mesh, jobs, out_dir) -> None:
    """Spawned rank: each job (name, run kwargs) run in turn, the results
    pickled to ``out_dir/<name>.<rank>.pkl``. A job with ``bn`` is a
    BatchNorm case (name, dtype, x, w): ``bn_run`` on this rank's rows
    under the mesh ("two") and without it ("local", no cross-rank part)."""
    torch.manual_seed(1234 + mesh.rank)  # a rank must not need the global seed
    for name, kw in jobs:
        if "bn" in kw:
            _, dtype, x, w = kw["bn"]
            rows = mesh.rows(x.shape[0])
            with scope(mesh):
                two = bn_run(x, w, dtype, rows)
            res = {"two": two, "local": bn_run(x, w, dtype, rows)}
        else:
            res = run(mesh=mesh, device=mesh.device, **kw)
        with open(os.path.join(out_dir, f"{name}.{mesh.rank}.pkl"), "wb") as f:
            pickle.dump(res, f)


def rank_cli_fault(mesh, cfg, fault) -> None:
    """A rank of cli.train's data-parallel run whose rank 1, in its second
    iteration, raises (``fault`` "raises") or stops answering ("hangs")."""
    from gcc_tpu_torch.cli import train
    if mesh.rank == 1:
        cls = train.engine_class(cfg.model)
        step, calls = cls.train_arch_step, []

        def faulty(self, *a, **kw):
            calls.append(1)
            if len(calls) == 2:
                if fault == "raises":
                    raise RuntimeError("rank 1: injected fault")
                time.sleep(3600)
            return step(self, *a, **kw)

        cls.train_arch_step = faulty
    train._rank_run(mesh, cfg)


def load(out_dir, name, rank):
    with open(os.path.join(out_dir, f"{name}.{rank}.pkl"), "rb") as f:
        return pickle.load(f)
