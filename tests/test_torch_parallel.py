"""The port's data-parallel training (gcc_tpu_torch/parallel/mesh.py) on the
CPU: two Gloo ranks, each a spawned process holding half of the global
batch, against one process over the whole batch.

* The slice against the JAX package: the port's pix2pix (U-Net, BatchNorm,
  online distillation, DARTS D, no dropout as tests/test_parallel.py has
  it) for 2 train steps on 2 ranks, against gcc_tpu's train_step over
  make_mesh(2) from the same weights on the same batches, at
  tests/test_torch_unet.py's bounds: losses within 1e-4 + 2e-3|t|, every
  parameter and running stat within 5e-5.
* 2 ranks against 1 process, port against port, all four families
  (pix2pix U-Net with dropout, pix2pix resnet with the fused blocks,
  CycleGAN with replay pools, SAGAN, SRGAN), train and arch steps, at
  tests/test_parallel.py's tolerances: losses rtol 2e-4 / atol 1e-5, the
  generators' BatchNorm scales, biases and running stats 2e-5 / 2e-3,
  every other parameter atol 1e-3 (Adam's first steps flip the sign of
  gradients at the reduction-noise level), and so the discriminators'
  running stats, which those parameters feed, spectral u, v 1e-5 / 1e-4. After the steps the
  two ranks' states (parameters, buffers, pools, moments, EMA, generator)
  hash the same.
* Global BatchNorm, fp32 (two-pass, two all-reduces) and bf16 (one-pass,
  one): forward, input and parameter gradients and running stats equal to
  one process's, and the bounds catch a W x or 1/W x gradient and a
  BatchNorm without its cross-rank part.

The CLI on a mesh: tests/test_torch_parallel_cli.py.
"""

import functools
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parallel_workers as W  # noqa: E402

from gcc_tpu_torch.ops.layers import BatchNorm  # noqa: E402
from gcc_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from torch_limits import one_thread, spawn_within  # noqa: E402,F401

TIMEOUT = 60.0  # seconds a rank waits for the other
# the slice against gcc_tpu: tests/test_torch_unet.py's configuration
JAX_KW = dict(crop_size=32, num_downs=5, no_dropout=True, ndf=8)


def _leaves(tree, prefix=""):
    if not isinstance(tree, dict):
        yield prefix.rstrip("/"), np.asarray(tree)
        return
    for k in sorted(tree):
        yield from _leaves(tree[k], f"{prefix}{k}/")


def jax_batches():
    """2 steps of global batch 4 at 32 px (val batches unused)."""
    rng = np.random.RandomState(11)
    mk = lambda: (rng.rand(4, 3, 32, 32) * 2 - 1).astype(np.float32)  # noqa: E731
    return [({"A": mk(), "B": mk()}, {"A": mk(), "B": mk()})
            for _ in range(2)]


@functools.lru_cache(maxsize=None)
def jax_nets0():
    return W.to_jax_nets(W.engine("unet", **JAX_KW).init_state(seed=0))


def bn_cases():
    """Global-BatchNorm inputs: (name, dtype, x (8, 5, 6, 6), upstream
    weights of the same shape)."""
    rng = np.random.RandomState(5)
    x = (rng.randn(8, 5, 6, 6) * 1.5 + 0.3).astype(np.float32)
    w = rng.randn(8, 5, 6, 6).astype(np.float32)
    return [(f"bn_{dt}", dt, x, w) for dt in ("float32", "bfloat16")]


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """One spawn of two Gloo ranks runs every job; the results by name and
    rank."""
    out = str(tmp_path_factory.mktemp("dp"))
    jobs = [(f, {"family": f}) for f in W.FAMILIES]
    jobs.append(("jax_unet", {"family": "unet", "nets0": jax_nets0(),
                              "arch": False, "steps": jax_batches(),
                              **JAX_KW}))
    jobs += [(c[0], {"bn": c}) for c in bn_cases()]
    t0 = time.time()
    with spawn_within(120, "the two ranks of the dp fixture"):
        pmesh.spawn(W.rank_runs, 2, args=(jobs, out), threads=1,
                    timeout=TIMEOUT)
    print(f"two ranks: {time.time() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# helpers without a mesh
# ---------------------------------------------------------------------------

def test_helpers_are_the_identity_without_a_mesh():
    x = torch.randn(4, 3)
    assert pmesh.active() is None
    assert pmesh.all_reduce_sum(x) is x
    assert pmesh.all_gather_rows(x) is x
    assert pmesh.local_rows(x) is x
    assert pmesh.global_batch(4) == 4
    assert torch.equal(pmesh.batch_mean(x), torch.mean(x))
    gs = [torch.randn(2), torch.randn(3)]
    assert pmesh.reduce_gradients(gs) is gs
    batch = {"A": x, "paths": ["a"] * 4}
    assert pmesh.shard_batch(batch, None) is batch
    assert pmesh.any_rank(None, True) and not pmesh.any_rank(None, False)


def test_rows_and_shard_batch():
    mesh = pmesh.Mesh(rank=1, world=2, device=torch.device("cpu"))
    assert mesh.rows(8) == slice(4, 8)
    with pytest.raises(ValueError, match="does not split"):
        mesh.rows(5)
    b = pmesh.shard_batch({"A": torch.arange(8), "p": list("abcdefgh"),
                           "n": np.arange(8)}, mesh)
    assert b["A"].tolist() == [4, 5, 6, 7] and b["p"] == list("efgh")
    assert b["n"].tolist() == [4, 5, 6, 7]


def test_the_boundary_test_covers_the_mesh():
    """tests/test_torch_boundary.py checks every .py of the port: the new
    package is among them."""
    import test_torch_boundary as tb
    names = {p.name for p in tb.PORT_FILES if p.parent.name == "parallel"}
    assert names == {"__init__.py", "mesh.py", "spatial.py"}


# ---------------------------------------------------------------------------
# the slice against the JAX package
# ---------------------------------------------------------------------------

def test_two_ranks_match_gcc_tpu_mesh(dp):
    import jax
    import jax.numpy as jnp

    from gcc_tpu.config import Config as JaxConfig
    from gcc_tpu.engines.common import GANState as JaxState
    from gcc_tpu.engines.pix2pix import Pix2PixEngine as JaxEngine
    from gcc_tpu.parallel import make_mesh, replicate_state, shard_batch

    nets0 = jax_nets0()
    jeng = JaxEngine(JaxConfig(**{**W.FAMILIES["unet"][1], **JAX_KW}))
    nets = jax.tree_util.tree_map(jnp.asarray, nets0)
    p = {k: v["params"] for k, v in nets.items()}
    opts = {"g": jeng.tx_g.init({"g": p["g"], "tf": p["tf"]}),
            "d": jeng.tx_d.init(p["d"]), "td": jeng.tx_d.init(p["td"]),
            "tg": jeng.tx_g.init({"g": p["tg"]}),
            "arch": jeng.tx_arch.init(nets["d"]["arch"])}
    mesh = make_mesh(2)
    jst = replicate_state(JaxState(step=jnp.int32(0), nets=nets, opts=opts,
                                   ema={"d_arch": jnp.float32(0.0)},
                                   rng=jax.random.PRNGKey(0)), mesh)
    lr = jnp.float32(W.LR)
    step, hist = None, []
    for tb, _ in jax_batches():
        jb = shard_batch({k: jnp.asarray(np.transpose(v, (0, 2, 3, 1)))
                          for k, v in tb.items()}, mesh)
        if step is None:
            step = jax.jit(jeng._train_step).lower(jst, jb, lr).compile(
                {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True})
        jst, m = step(jst, jb, lr)
        hist.append({k: float(v) for k, v in m.items()})
    jnets = jax.tree_util.tree_map(np.asarray, jst.nets)

    for rank in (0, 1):
        got = W.load(dp, "jax_unet", rank)
        for i, (j, t) in enumerate(zip(hist, got["metrics"])):
            assert set(j) == set(t)
            for k in j:
                assert abs(j[k] - t[k]) < 1e-4 + 2e-3 * abs(j[k]), \
                    f"rank {rank} step {i} {k}: jax {j[k]} port {t[k]}"
        for net in jnets:
            jl, tl = dict(_leaves(jnets[net])), dict(_leaves(got["nets"][net]))
            assert set(jl) == set(tl), net
            for path in jl:
                d = float(np.max(np.abs(jl[path] - tl[path])))
                assert d < 5e-5, f"rank {rank} {net}/{path}: {d}"


# ---------------------------------------------------------------------------
# 2 ranks against 1 process, port against port
# ---------------------------------------------------------------------------

def assert_runs_agree(one, two, family):
    for i, (a, b) in enumerate(zip(one["metrics"], two["metrics"])):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=2e-4, atol=1e-5,
                                       err_msg=f"{family} step {i} {k}")
    for net in one["nets"]:
        for coll, tree in one["nets"][net].items():
            other = dict(_leaves(two["nets"][net][coll]))
            leaves = dict(_leaves(tree))
            norms = {p.rsplit("/", 1)[0] for p in leaves
                     if p.endswith("/scale")}
            for path, a in leaves.items():
                name = f"{family} {net}/{coll}/{path}"
                d_side = net.lstrip("t").startswith("d")
                if not d_side and (coll == "batch_stats"
                                   or path.rsplit("/", 1)[0] in norms):
                    # a generator's BatchNorm: running stats, scale, bias
                    tol = dict(atol=2e-5, rtol=2e-3)
                elif coll == "spectral":
                    tol = dict(atol=1e-5, rtol=1e-4)
                else:
                    tol = dict(atol=1e-3, rtol=0)
                np.testing.assert_allclose(other[path], a, err_msg=name,
                                           **tol)


@pytest.mark.parametrize("family", list(W.FAMILIES))
def test_two_ranks_equal_one_process(family, dp):
    one = W.run(family)
    for rank in (0, 1):
        assert_runs_agree(one, W.load(dp, family, rank), family)


@pytest.mark.parametrize("family", list(W.FAMILIES))
def test_ranks_hold_the_same_state(family, dp):
    """Bit for bit across the ranks: every parameter and buffer (pools and
    their counts), the Adam moments, the EMA, the step and the generator;
    and the state moved."""
    r0, r1 = W.load(dp, family, 0), W.load(dp, family, 1)
    assert r0["checksum"] == r1["checksum"]
    assert r0["metrics"] == r1["metrics"]
    assert r0["counters"] == r1["counters"]
    for key in r0["state"]["ema"]:
        assert float(r0["state"]["ema"][key]) != 0.0, key
    if family == "cyclegan":
        for pool in ("pool_a", "pool_b", "tpool_a", "tpool_b"):
            sd0 = r0["state"]["nets"][pool]
            assert int(sd0["_extra_state"]) == 4  # filled by 2 x 4 images
            np.testing.assert_array_equal(
                sd0["buffer"], r1["state"]["nets"][pool]["buffer"])
    # one gradient all-reduce per update: 5 updates a train+arch step
    assert [c["grad_calls"] for c in r0["counters"]] == [5, 5]


# ---------------------------------------------------------------------------
# global BatchNorm
# ---------------------------------------------------------------------------

BN_TOL = {"float32": dict(atol=2e-5, rtol=2e-3),
          "bfloat16": dict(atol=2e-5, rtol=2e-2)}  # bf16: 2^-6 of each value


@pytest.mark.parametrize("name,dtype,x,w", bn_cases(),
                         ids=[c[0] for c in bn_cases()])
def test_global_batchnorm(name, dtype, x, w, dp):
    one = W.bn_run(x, w, dtype)
    tol = BN_TOL[dtype]
    ranks = [W.load(dp, name, r) for r in (0, 1)]
    for r, got in enumerate(ranks):
        rows = slice(4 * r, 4 * r + 4)
        np.testing.assert_allclose(got["two"]["y"], one["y"][rows],
                                   err_msg=f"{name} y", **tol)
        # a rank's own rows take W times their 1-process gradient (each
        # rank backpropagates the global loss: parallel/mesh.py)
        np.testing.assert_allclose(got["two"]["gx"] / 2, one["gx"][rows],
                                   err_msg=f"{name} gx", **tol)
        for k in ("gw", "gb", "mean", "var"):
            np.testing.assert_allclose(got["two"][k], one[k],
                                       err_msg=f"{name} {k}", **tol)
    # the bounds catch the usual faults: a W x or 1/W x gradient, and a
    # BatchNorm without its cross-rank part
    got = ranks[0]["two"]

    def caught(a, b):
        return not np.allclose(a, b, **tol)

    for f in (2.0, 0.5):
        assert caught(got["gw"] * f, one["gw"]) and \
            caught(got["gx"] / 2 * f, one["gx"][:4])
    local = ranks[0]["local"]
    assert caught(local["y"], one["y"][:4])
    assert caught(local["gx"] / 2, one["gx"][:4])
    assert caught(local["gw"], one["gw"])
    assert caught(local["var"], one["var"])
    # the running variance's unbias factor counts the global batch
    xd = torch.from_numpy(x).to(getattr(torch, dtype)).double().numpy()
    n = x.shape[0] * x.shape[2] * x.shape[3]
    want = 0.9 + 0.1 * xd.var(axis=(0, 2, 3)) * n / (n - 1)
    np.testing.assert_allclose(got["var"], want, rtol=1e-5)
    assert caught(local["var"], want)


def test_batchnorm_without_a_mesh_is_unchanged():
    """No mesh: the fp32 two-pass and the bf16 one-pass forms as before, bit
    for bit (the engines' fp32 path and the serving export's rounding)."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(3, 4, 5, 5).astype(np.float32))
    for dt in (torch.float32, torch.bfloat16):
        bn = BatchNorm(4)
        with torch.no_grad():
            bn.weight.fill_(1.2)
            bn.bias.fill_(0.1)
        xd = x.to(dt)
        xf = xd.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = ((xf - mean[None, :, None, None]).square().mean(dim=(0, 2, 3))
               if dt == torch.float32
               else xf.square().mean(dim=(0, 2, 3)) - mean.square())
        want = ((xf - mean[None, :, None, None])
                * (torch.rsqrt(var + 1e-5) * 1.2)[None, :, None, None]
                + 0.1).to(dt)
        assert torch.equal(bn(xd), want)
        assert torch.equal(bn.running_var,
                           0.9 + 0.1 * var * (75 / 74))
