"""Configuration system of the PyTorch port.

A copy of ``gcc_tpu/config.py`` (the port imports nothing of the JAX
package). The flag surface is kept identical, so the JAX package's scripts
and saved configs parse unchanged here; knobs that only the JAX package
reads (mesh axes, compile cache, device cache, Pallas thresholds) are
carried and ignored by the port until the slice that needs them.

Mirrors the full flag surface of the reference CLI (options/options.py:6-128)
as a typed dataclass, including the per-model/per-dataset imperative default
overrides applied by ``options.parse()`` (options/options.py:154-232).

Deviations from the reference (deliberate fixes, see SURVEY.md §2.4):
  * ``generator_only`` is declared (the reference reads it at
    options/options.py:196 without ever declaring it — a latent AttributeError).
  * Accelerator-specific knobs are added (mesh axes, dtypes, seed).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from dataclasses import dataclass
from typing import List, Optional, Tuple


@dataclass
class Config:
    # ---- basic parameters (options/options.py:9-16) ----
    dataroot: str = ""
    name: str = "default"
    checkpoints_dir: str = "./experiments"
    phase: str = "train"
    load_path: Optional[str] = None
    pretrain_path: Optional[str] = None

    # ---- model parameters (options/options.py:19-29) ----
    model: str = "pix2pix"  # [pix2pix | cyclegan | sagan | srgan]
    input_nc: int = 3
    output_nc: int = 3
    ngf: int = 64
    pretrain_ngf: int = 64
    ndf: int = 128
    backbone: str = "unet"  # [unet | resnet]
    no_dropout: bool = False
    num_downs: int = 8
    continue_train: bool = False

    # ---- dataset parameters (options/options.py:32-43) ----
    dataset_mode: str = "aligned"  # [aligned | unaligned | sa | sr | synthetic]
    direction: str = "AtoB"
    serial_batches: bool = False
    num_threads: int = 8
    batch_size: int = 1
    load_size: int = 286
    crop_size: int = 256
    max_dataset_size: float = math.inf
    preprocess: str = "resize_and_crop"
    no_flip: bool = False
    split_dataset: bool = False

    # ---- train parameters (options/options.py:53-67) ----
    print_freq: int = 500
    save_epoch_freq: int = 1
    epoch_count: int = 1
    n_epochs: int = 100
    n_epochs_decay: int = 150
    lr: float = 2e-4
    gan_mode: str = "hinge"  # [vanilla | lsgan | hinge | wgangp]
    pool_size: int = 100
    lr_policy: str = "linear"  # [linear | step | plateau | cosine]
    lr_decay_iters: int = 50
    lambda_A: float = 10.0
    lambda_B: float = 10.0
    lambda_identity: float = 0.5
    lambda_L1: float = 0.0

    # ---- test parameters (options/options.py:70-72) ----
    ntest: float = math.inf
    aspect_ratio: float = 1.0
    drn_path: str = "./database/cityscapes/drn-d-105_ms_cityscapes.pth"

    # ---- prune parameters (options/options.py:75-84) ----
    scale_prune: bool = False
    norm_prune: bool = False
    lambda_weight: float = 0.0
    lambda_scale: float = 0.0
    target_budget: Optional[float] = None  # GMACs
    target_budget_B: Optional[float] = None  # GMACs (cyclegan B direction)
    lottery_path: Optional[str] = None

    # ---- darts parameters (options/options.py:87-98) ----
    darts_discriminator: bool = False
    arch_lr: float = 1e-4
    arch_lr_step: bool = False
    ema_beta: float = 1.0
    threshold: float = 0.5
    # adaptive_ema (options/options.py:92) is dead in the reference: all four
    # models apply the adaptive ema_beta schedule UNCONDITIONALLY at epoch end
    # (Pix2Pix.py:611, CycleGAN.py:621, SAGAN.py:553, SRGAN.py:551); we match
    # that behavior (utils/schedule.ema_beta_for_epoch), so the flag is
    # declared for CLI parity only and intentionally unread.
    adaptive_ema: bool = False
    # The five flags below are declared by the reference CLI
    # (options/options.py:90-97) but NEVER read by any reference code path
    # (the only mentions are commented-out blocks, e.g. SAGAN.py:334-335).
    # Declared here for script/flag-surface parity; intentionally unread.
    lambda_alpha: float = 0.01
    regular: bool = False
    arch_base_loss: bool = False
    only_arch_base: bool = False
    normalize_arch: bool = False
    clear_arch: bool = False

    # ---- distillation (options/options.py:101-107) ----
    online_distillation: bool = False
    normal_distillation: bool = False
    distillation_path: Optional[str] = None
    lambda_content: float = 0.0
    lambda_gram: float = 0.0
    teacher_ngf: int = 64
    teacher_ndf: int = 64

    # ---- super-resolution (options/options.py:111-122) ----
    lambda_SR_adversarial: float = 1e-3
    lambda_SR_content: float = 0.0
    lambda_SR_perceptual: float = 1.0
    image_size: int = 96
    upscale_factor: int = 4
    lr_img_type: str = "imagenet-norm"
    hr_img_type: str = "[-1, 1]"
    initial_path: Optional[str] = None
    teacher_initial_path: Optional[str] = None
    generator_only: bool = False  # used (never declared) by the reference

    # ---- noise gan (options/options.py:125-126) ----
    z_dim: int = 128
    center_crop: bool = False

    # ---- TPU-native additions (no reference equivalent) ----
    native_loader: bool = False  # C++ transform engine (gcc_tpu.native)
    debug_nans: bool = False  # jax_debug_nans (SURVEY.md §5 sanitizers row)
    check_numerics: bool = False  # post-step finite-check on the named-loss dict; aborts with the offending loss names (cheaper than --debug_nans: no per-primitive re-execution, one host sync per step)
    profile_steps: int = 0  # capture a jax.profiler trace of the first N iters
    seed: int = 0
    compute_dtype: str = "bfloat16"  # dtype for conv math inside the step
    param_dtype: str = "float32"
    data_axis: str = "data"  # mesh axis name for batch sharding
    mesh_shape: Optional[Tuple[int, ...]] = None  # None => all devices on data axis
    spatial_shards: int = 1  # >1: shard image H over devices at eval (parallel/spatial.py)
    fused_d_batch: bool = False  # one D forward over the stacked fake+real pair: halves the D-wgrad all-reduce traffic on multi-chip meshes (engines/common.py:d_pair); off = reference-exact per-half BN batches / spectral iterations
    pallas_attn_threshold: int = 1024  # min H*W for the fused flash-attention kernel on TPU
    fused_resblock: str = "auto"  # auto|on|off: fused MobileResnet block kernels (auto = off until measured)
    compile_cache: str = "auto"  # persistent XLA compilation cache dir; auto => <checkpoints_dir>/jax_compile_cache; "" disables
    memory_guard: str = "auto"  # auto|on|strict|off: project the step's HBM peak before the first iteration (utils/memory_guard.py); auto skips CPU, strict aborts on projected OOM
    prefetch: int = 2  # host->device pipeline depth
    device_cache: str = "auto"  # auto|on|off: keep packed datasets resident in device HBM (data/device_cache.py); auto caches stores <= 25% of HBM on non-CPU backends
    eval_batch: int = 1  # generator batch for epoch-end eval; 1 = reference bs=1 protocol (metric/test_metric.py:16-21). >1 batches the eval forwards (same outputs: eval mode has no dropout and uses running BN stats; order/cap preserved) — big win on dispatch-latency-bound hosts. SRGAN's variable-shape test sets always run per-image.
    pack_output: str = ""  # cli.prepare output dir ("" => <dataroot>_packed)
    vgg_path: Optional[str] = None  # torch VGG19 state_dict for SRGAN perceptual loss
    inception_path: Optional[str] = None  # FID InceptionV3 weights
    log_jsonl: bool = True
    isTrain: bool = True
    # the reference's --gpu_ids: the port's CLIs run on that card, or on the
    # CPU with -1 (one id: data parallelism is ROADMAP Queue A item 7)
    gpu_ids: str = "0"

    # populated by presets
    norm: str = "batch"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def apply_presets(cfg: Config) -> Config:
    """Per-model default overrides, mirroring options/options.py:164-228."""
    c = cfg
    synthetic = c.dataset_mode == "synthetic"
    if c.model in ("pix2pix", "newpix2pix"):
        c = c.replace(norm="batch", dataset_mode="aligned", no_flip=True,
                      load_size=256, pool_size=0, teacher_ndf=128, lambda_L1=100.0)
        if "cityscapes" in c.dataroot:
            c = c.replace(direction="BtoA", save_epoch_freq=5, n_epochs=100,
                          n_epochs_decay=150, print_freq=100)
        if "edges2shoes" in c.dataroot:
            c = c.replace(batch_size=4, n_epochs=10, n_epochs_decay=30)
        if "maps" in c.dataroot:
            c = c.replace(n_epochs=100, direction="BtoA", no_flip=False,
                          load_size=286, n_epochs_decay=200, save_epoch_freq=5,
                          print_freq=100, lambda_L1=10.0)
    elif c.model == "srgan":
        c = c.replace(dataset_mode="sr", gan_mode="vanilla", lr=1e-4)
        if c.generator_only:
            c = c.replace(n_epochs=130, n_epochs_decay=0, batch_size=16)
        else:
            c = c.replace(n_epochs=30, n_epochs_decay=0, batch_size=16,
                          lr_policy="step")
            c = c.replace(lr_decay_iters=c.n_epochs // 2)
    elif c.model == "sagan":
        c = c.replace(dataset_mode="sa", crop_size=64, batch_size=64, lr=1e-4,
                      n_epochs_decay=0, save_epoch_freq=5)
        if "church" in c.dataroot:
            c = c.replace(n_epochs=300, center_crop=False)
        else:
            c = c.replace(n_epochs=100, center_crop=True)
    elif "cyclegan" in c.model:
        # pool_size=50: the reference hard-codes ImagePool(50) for all four
        # pools regardless of the flag (models/CycleGAN.py:342-343); we honor
        # an explicitly passed --pool_size but default to reference parity.
        c = c.replace(dataset_mode="unaligned", gan_mode="lsgan", n_epochs=100,
                      n_epochs_decay=100, print_freq=100, pool_size=50)

    # sparsity pretraining runs at 1/10 epoch counts (options/options.py:226-228)
    if c.lambda_weight > 0 or c.lambda_scale > 0:
        c = c.replace(n_epochs=c.n_epochs // 10,
                      n_epochs_decay=c.n_epochs_decay // 10)
    if synthetic:  # synthetic data survives the per-model preset
        c = c.replace(dataset_mode="synthetic")
    return c


_BOOL_FLAGS = [
    "native_loader", "debug_nans", "check_numerics", "no_dropout", "serial_batches", "no_flip", "split_dataset", "scale_prune",
    "norm_prune", "darts_discriminator", "arch_lr_step", "adaptive_ema",
    "regular", "arch_base_loss", "only_arch_base", "normalize_arch",
    "clear_arch", "online_distillation", "normal_distillation", "center_crop",
    "generator_only", "continue_train", "fused_d_batch",
]


def build_parser() -> argparse.ArgumentParser:
    """CLI parser with the reference's flag names (script parity)."""
    p = argparse.ArgumentParser("GCC-TPU")
    for f in dataclasses.fields(Config):
        flag = "--" + f.name
        if f.name in _BOOL_FLAGS:
            p.add_argument(flag, action="store_true", default=False)
        elif f.name == "mesh_shape":
            p.add_argument(flag, type=str, default=None)
        else:
            # annotations are strings under `from __future__ import
            # annotations`; resolve by name
            ann = f.type if isinstance(f.type, str) else getattr(
                f.type, "__name__", str(f.type))
            if "int" in ann and "Optional" not in ann:
                typ = int
            elif "float" in ann or f.name in (
                    "target_budget", "target_budget_B", "max_dataset_size",
                    "ntest"):
                typ = float
            else:
                typ = str
            default = f.default if f.default is not dataclasses.MISSING else None
            p.add_argument(flag, type=typ, default=default)
    return p


def parse(argv: Optional[List[str]] = None) -> Config:
    """Parse CLI flags into a Config with presets applied (options.parse()).

    Unlike the reference — whose parse() silently clobbers user-passed
    values with per-model defaults (options/options.py:164-228) —
    explicitly passed flags win over presets here.
    """
    import sys
    raw = list(sys.argv[1:]) if argv is None else list(argv)
    ns = build_parser().parse_args(raw)
    kw = {f.name: getattr(ns, f.name) for f in dataclasses.fields(Config)}
    if isinstance(kw.get("mesh_shape"), str) and kw["mesh_shape"]:
        kw["mesh_shape"] = tuple(int(x) for x in kw["mesh_shape"].split(","))
    cfg = apply_presets(Config(**kw))
    user_keys = {tok[2:].split("=")[0] for tok in raw
                 if tok.startswith("--")}
    overrides = {k: kw[k] for k in user_keys
                 if k in kw and getattr(cfg, k) != kw[k]}
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg
