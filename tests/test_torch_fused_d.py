"""``--fused_d_batch`` in the port (engines/common.py d_pair), the cases of
tests/test_fused_d.py:

* InstanceNorm D: the fused forward and its parameter gradients equal the
  two-forward path's; the captured features are x_b's half's.
* CycleGAN with DARTS off (every D InstanceNorm): the whole fused train
  step equals the unfused one, at tests/test_fused_d.py's bounds.
* Every engine's fused step (pix2pix, CycleGAN, SAGAN, SRGAN) runs and its
  losses are finite.
* Data parallel: the fused pix2pix step on 2 Gloo ranks equals 1 process
  (losses rtol 2e-4 / atol 1e-5, G's parameters and D's running stats
  2e-5 / 2e-3).
* The all-reduce bytes (parallel/mesh.py's counters): in gcc_tpu the fused
  forward halves D's weight-gradient all-reduces, which XLA inserts per
  product; the port reduces one flat buffer per update whatever the
  forwards, so --fused_d_batch leaves the gradient bytes unchanged and
  only cuts the BatchNorm statistics' all-reduces (one D forward, not two).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parallel_workers as W  # noqa: E402

from gcc_tpu_torch.engines.common import (  # noqa: E402
    arch_params, d_pair, grads_of, weight_params,
)
from gcc_tpu_torch.models.discriminators import PatchGAN  # noqa: E402
from gcc_tpu_torch.ops.layers import init_params  # noqa: E402
from gcc_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from torch_limits import one_thread, spawn_within  # noqa: E402,F401

# tests/test_fused_d.py's pix2pix, no dropout
PIX2PIX = dict(crop_size=32, num_downs=5, no_dropout=True)


def _d(seed=0):
    return init_params(PatchGAN(3, 4, norm="instance"),
                       torch.Generator().manual_seed(seed)).train()


def _x(rng, n):
    return torch.from_numpy((rng.rand(n, 3, 32, 32) * 2 - 1)
                            .astype(np.float32))


def test_d_pair_fused_exact_instance_norm():
    d = _d()
    rng = np.random.RandomState(0)
    xa, xb = _x(rng, 4), _x(rng, 4)
    params = list(d.parameters())
    out = {}
    for fused in (False, True):
        pa, pb, _ = d_pair(d, xa, xb, fused=fused)
        loss = torch.mean(pa ** 2) + torch.mean(torch.abs(pb))
        out[fused] = (pa.detach(), pb.detach(), loss.detach(),
                      grads_of(loss, params))
    (pa0, pb0, l0, g0), (pa1, pb1, l1, g1) = out[False], out[True]
    torch.testing.assert_close(pa1, pa0, atol=1e-5, rtol=0)
    torch.testing.assert_close(pb1, pb0, atol=1e-5, rtol=0)
    torch.testing.assert_close(l1, l0, atol=1e-6, rtol=0)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=0)


def test_d_pair_features_are_the_second_half():
    d = _d(1)
    rng = np.random.RandomState(1)
    xa, xb = _x(rng, 3), _x(rng, 3)
    with torch.no_grad():
        _, pb0, f0 = d_pair(d, xa, xb, fused=False)
        _, pb1, f1 = d_pair(d, xa, xb, fused=True)
    assert len(f0) == len(f1) > 0
    for u, w in zip(f0, f1):
        assert u.shape == w.shape
        torch.testing.assert_close(w, u, atol=1e-5, rtol=0)
    torch.testing.assert_close(pb1, pb0, atol=1e-5, rtol=0)


def test_cyclegan_fused_step_matches_unfused():
    """DARTS off: every CycleGAN D is InstanceNorm, so fusing changes only
    the sum order (Adam's first steps amplify it to +-lr where a gradient
    is at noise level: atol 1e-3)."""
    runs = [W.run("cyclegan", arch=False, darts_discriminator=False,
                  fused_d_batch=fused) for fused in (False, True)]
    (m0, n0), (m1, n1) = [(r["metrics"], r["nets"]) for r in runs]
    for a, b in zip(m0, m1):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=2e-4, atol=1e-5,
                                       err_msg=k)
    for net in ("g_a", "d_a"):
        for (path, a), (_, b) in zip(_leaves(n0[net]["params"]),
                                     _leaves(n1[net]["params"])):
            np.testing.assert_allclose(b, a, atol=1e-3, err_msg=path)


def _leaves(tree, prefix=""):
    if not isinstance(tree, dict):
        yield prefix.rstrip("/"), np.asarray(tree)
        return
    for k in sorted(tree):
        yield from _leaves(tree[k], f"{prefix}{k}/")


@pytest.mark.parametrize("family", ["unet", "cyclegan", "sagan", "srgan"])
def test_engines_fused_step_finite(family):
    res = W.run(family, fused_d_batch=True,
                steps=W.batches(family, seed=3, n_steps=1))
    assert all(np.isfinite(v) for v in res["metrics"][0].values()), family


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("fused_dp"))
    kw = dict(family="unet", **PIX2PIX,
              steps=W.batches("unet", seed=7, batch=4, n_steps=2,
                              size=32))
    jobs = [("fused", dict(kw, arch=False, fused_d_batch=True)),
            ("fused_arch", dict(kw, fused_d_batch=True)),
            ("unfused_arch", dict(kw, fused_d_batch=False))]
    with spawn_within(60, "the two ranks of the dp fixture"):
        pmesh.spawn(W.rank_runs, 2, args=(jobs, out), threads=1,
                    timeout=60.0)
    return out, kw


def test_fused_two_ranks_equal_one_process(dp):
    out, kw = dp
    one = W.run(**dict(kw, arch=False, fused_d_batch=True))
    for rank in (0, 1):
        two = W.load(out, "fused", rank)
        for a, b in zip(one["metrics"], two["metrics"]):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_allclose(b[k], a[k], rtol=2e-4, atol=1e-5,
                                           err_msg=k)
        for net, coll in (("g", "params"), ("d", "batch_stats")):
            got = dict(_leaves(two["nets"][net][coll]))
            for path, a in _leaves(one["nets"][net][coll]):
                np.testing.assert_allclose(got[path], a, atol=2e-5,
                                           rtol=2e-3, err_msg=path)


def test_fused_leaves_gradient_bytes_unchanged(dp):
    """One gradient all-reduce per update (5 an iteration: teacher D,
    teacher G, D, G with the transforms, the arch step's alphas), each the
    update's parameter bytes, fused or not; the fused D forwards reduce
    fewer BatchNorm statistics."""
    out, kw = dp
    fused, unfused = (W.load(out, n, 0)["counters"]
                      for n in ("fused_arch", "unfused_arch"))
    eng = W.engine("unet", **{k: v for k, v in kw.items()
                              if k not in ("family", "steps")})
    nets = eng.init_state(seed=0).nets
    n_params = sum(p.numel() for p in eng._g_bundle(nets)
                   + weight_params(nets["d"]) + weight_params(nets["td"])
                   + weight_params(nets["tg"]) + arch_params(nets["d"]))
    for step_f, step_u in zip(fused, unfused):
        assert step_f["grad_calls"] == step_u["grad_calls"] == 5
        assert step_f["grad_bytes"] == step_u["grad_bytes"] == 4 * n_params
        assert step_f["stat_bytes"] < step_u["stat_bytes"]
    print(f"per iteration: {fused[0]['grad_bytes']} gradient bytes either "
          f"way; statistics {unfused[0]['stat_bytes']} -> "
          f"{fused[0]['stat_bytes']} bytes fused")

