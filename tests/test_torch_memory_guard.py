"""The port's memory guard (gcc_tpu_torch/utils/memory_guard.py) on the CPU.

* Given the same peaks, ``check_step`` returns ``gcc_tpu``'s dicts, logs its
  messages and raises its strict error (``gcc_tpu.utils.memory_guard._peak``
  and the port's measurement patched, as tests/test_utils_extra.py drives
  the JAX guard); a full batch that runs out of memory is projected from
  the halves.
* On the CPU the guard is skipped: there are no peak statistics.
* A measurement restores everything the step wrote, also when the step
  runs out of memory; two CLI iterations with the guard forced to measure
  (the full batch and its half) leave the U-Net run (dropout drawn from the
  generators) and the CycleGAN run (replay pools) bit for bit where
  ``--memory_guard off`` leaves them.
"""

import filecmp

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gcc_tpu.utils import memory_guard as jguard  # noqa: E402
from gcc_tpu_torch.cli import train as ttrain  # noqa: E402
from gcc_tpu_torch.utils import memory_guard as guard  # noqa: E402
from torch_limits import one_thread  # noqa: E402,F401

GIB = 1 << 30


class _Log:
    def __init__(self):
        self.infos, self.warnings = [], []

    def info(self, msg):
        self.infos.append(str(msg))

    def warning(self, msg):
        self.warnings.append(str(msg))


def _theirs(monkeypatch, peaks, batch, hbm, strict):
    monkeypatch.setattr(jguard, "_peak",
                        lambda jitted, args: peaks[args[1].shape[0]])
    log = _Log()
    args = (jnp.zeros(()), jnp.zeros((batch, 2)))
    try:
        out = jguard.check_step(None, args, batch_argnums=(1,),
                                batch_size=batch, hbm_bytes=hbm, logger=log,
                                strict=strict)
    except jguard.MemoryGuardError as e:
        out = ("raised", str(e))
    return out, log


def _ours(monkeypatch, peaks, batch, hbm, strict):
    monkeypatch.setattr(guard, "measurable", lambda device: True)
    monkeypatch.setattr(guard, "_peak",
                        lambda step, state, n, device: peaks[n])
    log = _Log()
    try:
        out = guard.check_step(None, None, batch, "cpu", hbm_bytes=hbm,
                               logger=log, strict=strict)
    except guard.MemoryGuardError as e:
        out = ("raised", str(e))
    return out, log


# (peaks by batch, batch, device bytes): under the budget; over it with a
# suggested batch; over it with a batch-independent peak; over it with no
# half-batch peak; over it at batch 1 (no fit)
CASES = [({8: 3 * GIB}, 8, 16 * GIB),
         ({8: 20 * GIB, 4: 11 * GIB}, 8, 16 * GIB),
         ({8: 20 * GIB, 4: 19.9 * GIB}, 8, 16 * GIB),
         ({8: 20 * GIB, 4: None}, 8, 16 * GIB),
         ({1: 20 * GIB}, 1, 16 * GIB)]
CASE_IDS = ["under", "suggests", "batch-independent", "no-half", "batch-1"]


@pytest.mark.parametrize("strict", [False, True], ids=["on", "strict"])
@pytest.mark.parametrize("peaks,batch,hbm", CASES, ids=CASE_IDS)
def test_check_step_equals_jax(monkeypatch, peaks, batch, hbm, strict):
    peaks = {k: None if v is None else int(v) for k, v in peaks.items()}
    theirs, tlog = _theirs(monkeypatch, peaks, batch, hbm, strict)
    ours, olog = _ours(monkeypatch, peaks, batch, hbm, strict)
    assert ours == theirs
    assert olog.infos == tlog.infos and olog.warnings == tlog.warnings
    over = peaks[batch] > hbm
    assert (isinstance(ours, tuple) and ours[0] == "raised") == (
        strict and over)


def test_out_of_memory_at_the_full_batch(monkeypatch):
    """The full batch runs out: halves are measured until two ran, and the
    peak at the full batch is projected from them."""
    peaks = {8: None, 4: None, 2: 6 * GIB, 1: 4 * GIB}
    out, log = _ours(monkeypatch, peaks, 8, 16 * GIB, False)
    assert out["out_of_memory"] and out["peak_bytes"] == 18 * GIB
    assert out["bytes_per_image"] == 2 * GIB
    assert out["fixed_bytes"] == 2 * GIB
    assert out["suggested_max_batch"] == 7
    assert "ran out of memory at batch 8" in log.warnings[0]
    none = {n: None for n in (8, 4, 2, 1)}
    out, log = _ours(monkeypatch, none, 8, 16 * GIB, False)
    assert out == {"peak_bytes": None, "hbm_bytes": 16 * GIB,
                   "out_of_memory": True}
    raised, _ = _ours(monkeypatch, none, 8, 16 * GIB, True)
    assert raised[0] == "raised" and "ran out" in raised[1]


def test_skipped_on_the_cpu():
    log = _Log()
    assert guard.check_step(None, None, 4, "cpu", logger=log) is None
    assert log.infos == ["memory guard: no device memory statistics on the "
                         "CPU; skipped"]


def _tiny_unet(seed=0):
    from gcc_tpu_torch.config import Config
    from gcc_tpu_torch.engines.pix2pix import Pix2PixEngine
    cfg = Config(model="pix2pix", backbone="unet", ngf=4, ndf=4,
                 teacher_ngf=8, teacher_ndf=8, num_downs=5, crop_size=32,
                 online_distillation=True, darts_discriminator=True,
                 lambda_content=1.0, lambda_gram=1.0)
    engine = Pix2PixEngine(cfg, device="cpu")
    rng = np.random.RandomState(seed)
    batch = {k: torch.from_numpy(rng.rand(4, 3, 32, 32).astype(np.float32))
             for k in ("A", "B")}
    return engine, engine.init_state(seed=seed), batch


def _same_state(a, b):
    assert a["step"] == b["step"]
    np.testing.assert_array_equal(a["rng"], b["rng"])
    for net in a["nets"]:
        for name, t in a["nets"][net].items():
            np.testing.assert_array_equal(t, b["nets"][net][name],
                                          err_msg=f"{net}.{name}")
    for k in a["ema"]:
        np.testing.assert_array_equal(a["ema"][k], b["ema"][k])
    for k in a["opts"]:
        assert a["opts"][k]["count"] == b["opts"][k]["count"]
        for m in ("mu", "nu"):
            for x, y in zip(a["opts"][k][m], b["opts"][k][m]):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("oom", [False, True], ids=["ran", "out-of-memory"])
def test_measurement_restores_the_state(monkeypatch, oom):
    monkeypatch.setattr(guard, "_reset_peak", lambda device: None)
    monkeypatch.setattr(guard, "_read_peak", lambda device: 1234)
    engine, state, batch = _tiny_unet()
    before = state.state_dict()
    cpu_rng = torch.get_rng_state()

    def step(n):
        engine.train_arch_step(state, {k: v[:n] for k, v in batch.items()},
                               batch, 2e-4, 0.9, 1e-4)
        torch.rand(3)  # the global generator moves too
        assert state.step == 1
        if oom:
            raise torch.cuda.OutOfMemoryError("out of memory")

    assert guard._peak(step, state, 2, "cpu") == (None if oom else 1234)
    _same_state(state.state_dict(), before)
    assert torch.equal(torch.get_rng_state(), cpu_rng)


UNET = ("--dataroot synthetic --dataset_mode synthetic --model pix2pix "
        "--ngf 4 --ndf 4 --num_downs 5 --crop_size 32 --load_size 32 "
        "--batch_size 4 --max_dataset_size 8 --num_threads 2 --n_epochs 1 "
        "--n_epochs_decay 0 --save_epoch_freq 1 --print_freq 4 "
        "--teacher_ngf 8 --teacher_ndf 8 --online_distillation "
        "--darts_discriminator --lambda_content 50 --lambda_gram 1e4")
CG = ("--dataroot synthetic --dataset_mode synthetic --model cyclegan "
      "--ngf 4 --ndf 4 --teacher_ngf 4 --teacher_ndf 4 --crop_size 32 "
      "--load_size 32 --batch_size 1 --max_dataset_size 2 --num_threads 2 "
      "--n_epochs 1 --n_epochs_decay 0 --save_epoch_freq 1 --print_freq 1 "
      "--pool_size 1 --online_distillation --darts_discriminator "
      "--lambda_content 1 --lambda_gram 1")


@pytest.mark.parametrize("flags", [UNET, CG], ids=["unet", "cyclegan"])
def test_guarded_run_equals_unguarded(tmp_path, monkeypatch, flags):
    """--memory_guard on, made to measure on the CPU with a peak over the
    budget (so the half batch is measured too), against --memory_guard
    off: the same train_state.ckpt, byte for byte, after 2 iterations."""
    calls = []
    monkeypatch.setattr(guard, "measurable", lambda device: True)
    monkeypatch.setattr(guard, "device_hbm_bytes",
                        lambda device=None: (GIB, "patched"))
    monkeypatch.setattr(guard, "_reset_peak", lambda device: None)
    monkeypatch.setattr(guard, "_read_peak",
                        lambda device: calls.append(device) or 2 * GIB)
    for mode in ("on", "off"):
        assert ttrain.main(
            f"{flags} --memory_guard {mode} --name {mode} --checkpoints_dir "
            f"{tmp_path} --gpu_ids -1".split()) == 0
    half = "4" in flags.split("--batch_size ")[1][:2]
    assert len(calls) == (2 if half else 1)
    log = (tmp_path / "on" / "logger.log").read_text()
    assert "memory guard: projected step peak 2.00 GiB EXCEEDS" in log
    ckpt = "checkpoints/train_state.ckpt"
    assert filecmp.cmp(tmp_path / "on" / ckpt, tmp_path / "off" / ckpt,
                       shallow=False)
