"""SAGAN at ``pallas_attn_threshold=16`` against the JAX package's einsum
route.

At threshold 16 every attention block of the SAGAN networks takes the
port's flash route (on the CPU, the plain versions of the B1 kernels'
functions and their custom backward): the discriminator's attn1 at 8x8
(dq 32, dv 256 at ndf 64) and attn2 at 4x4 (dq 64, dv 512, the widths
that the full-width discriminator gives), the generator's attn1 at 16x16
and attn2 at 32x32. JAX on the CPU keeps its einsum route at every
threshold. Weights are carried across with the attention gammas non-zero
(0.5, -0.3); the train-mode forward's output and features, and the
gradients of a fixed cotangent with respect to the input and to every
parameter, are compared in fp32: outputs within 2e-5, gradients within
1e-4 * max(|ref|, 1) (reduction order only).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gcc_tpu.models.discriminators import (  # noqa: E402
    SAGANDiscriminator as JaxSAGAND,
)
from gcc_tpu.models.generators import SAGANGenerator as JaxSAGANG  # noqa: E402
from gcc_tpu_torch.models.discriminators import SAGANDiscriminator  # noqa: E402
from gcc_tpu_torch.models.generators import SAGANGenerator  # noqa: E402
from gcc_tpu_torch.ops import attention  # noqa: E402
from gcc_tpu_torch.utils.weights import (  # noqa: E402
    export_jax_variables, load_jax_variables,
)
from torch_limits import one_thread  # noqa: E402,F401

GAMMA = {"attn1": 0.5, "attn2": -0.3}


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _port_grads(net):
    """The port's parameter gradients as a JAX-layout params tree."""
    saved = {n: p.detach().clone() for n, p in net.named_parameters()}
    with torch.no_grad():
        for n, p in net.named_parameters():
            p.copy_(p.grad)
    tree = export_jax_variables(net)["params"]
    with torch.no_grad():
        for n, p in net.named_parameters():
            p.copy_(saved[n])
    return tree


@pytest.mark.parametrize("net", ["discriminator", "generator"])
def test_threshold_16_matches_jax_einsum(net, monkeypatch):
    widths = []
    flash = attention.flash_attention

    def recording(q, k, v):
        widths.append((q.shape[1], v.shape[1], q.shape[2]))
        return flash(q, k, v)

    monkeypatch.setattr(attention, "flash_attention", recording)
    R = np.random.RandomState(5)
    if net == "discriminator":
        jm = JaxSAGAND(ndf=64, pallas_attn_threshold=16)
        x = (R.rand(2, 64, 64, 3) * 2 - 1).astype(np.float32)
        tm = SAGANDiscriminator(64, attn_threshold=16)
        t_in = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
        expect = {(32, 256, 64), (64, 512, 16)}
    else:
        jm = JaxSAGANG(ngf=8, z_dim=8, pallas_attn_threshold=16)
        x = R.randn(2, 8).astype(np.float32)
        tm = SAGANGenerator(ngf=8, z_dim=8, attn_threshold=16)
        t_in = torch.from_numpy(x)
        expect = {(2, 16, 256), (1, 8, 1024)}
    v = _np(jm.init({"params": jax.random.PRNGKey(3)}, jnp.asarray(x)))
    for name, g in GAMMA.items():
        v["params"][name]["gamma"] = np.float32(g)
    load_jax_variables(tm, v)
    tm.train()

    def jax_out(params, xin):
        out, mut = jm.apply({**v, "params": params}, xin, train=True,
                            mutable=["batch_stats", "spectral",
                                     "intermediates"])
        return out, mut["intermediates"]

    jy, inter = jax.jit(jax_out)(v["params"], jnp.asarray(x))
    cot = R.randn(*jy.shape).astype(np.float32)
    jgp, jgx = jax.jit(jax.grad(
        lambda p, xin: jnp.sum(jax_out(p, xin)[0] * cot), argnums=(0, 1)))(
            v["params"], jnp.asarray(x))

    t_in.requires_grad_(True)
    ty, tfeats = tm(t_in)
    assert set(widths) == expect
    got_y = _nhwc(ty) if ty.ndim == 4 else ty.detach().numpy()
    np.testing.assert_allclose(got_y, np.asarray(jy), atol=2e-5)
    jfeats = [np.asarray(inter[k][0]) for k in sorted(inter)]
    for a, b in zip(tfeats, jfeats):
        np.testing.assert_allclose(_nhwc(a), b, atol=2e-5)
    t_cot = torch.from_numpy(np.ascontiguousarray(
        cot.transpose(0, 3, 1, 2) if cot.ndim == 4 else cot))
    (ty * t_cot).sum().backward()

    gx = t_in.grad.numpy()
    gx = gx.transpose(0, 2, 3, 1) if gx.ndim == 4 else gx
    jgx = np.asarray(jgx)
    np.testing.assert_allclose(gx, jgx, atol=1e-4 * max(np.abs(jgx).max(), 1))
    got = dict(_leaves(_port_grads(tm)))
    for path, b in _leaves(_np(jgp)):
        tol = 1e-4 * max(float(np.abs(b).max()), 1.0)
        np.testing.assert_allclose(got[path], b, atol=tol, err_msg=path)
