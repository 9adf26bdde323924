"""The port's serving export (gcc_tpu_torch.utils.serve_export and
``python -m gcc_tpu_torch.cli.export``) against the port's own generate and
against the JAX package's StableHLO artifacts (gcc_tpu.utils.hlo_export), on
the CPU at the tiny configurations of tests/test_hlo_export.py.

* Each family's fp32 artifact, round-tripped through save_exported /
  load_exported and exported once with a symbolic batch: within 1e-6 of the
  port's ``engine.generate`` at batch 1 and 3 (U-Net student and teacher,
  MobileResnet with fused blocks on and off: the same artifact, held to the
  fused generate at the fused-unfused agreement; CycleGAN's two
  directions; SAGAN at pallas_attn_threshold 1, which the portable copy
  undoes; SRGAN 8 -> 32), and within 1e-5 of gcc_tpu's artifact of the
  same weights.
* bf16 (``--serve_dtype bfloat16``): rms(port - jax_bf16) <= 1/4
  rms(jax_bf16 - jax_fp32) for each generator class, or, past it, the first
  difference a conv's fp32 sum at one ulp, the rules of
  tests/test_torch_bf16.py; the ratios are printed.
* ``quantize_int8``: q and s bit for bit gcc_tpu's under the weight layout's
  permutation, at every layer type (conv and depthwise, the transpose convs
  of U-Net and MobileResnet, SAGAN's spectral deconvs and attention convs,
  the spectral convs of its D, SRGAN's sub-pixel conv and the dense layer of
  its D); each scale reconstructs its channel within one step.
* The int8 artifact at ngf 16: < 0.5x the fp32 file, <= 0.02 and > 45 dB
  from generate, within 1e-5 of gcc_tpu's int8 artifact, and no float copy
  of a quantized weight in the program.
* An export changes no net of the engine, and no program mutates a buffer.
* End to end: a gcc_tpu pix2pix checkpoint through the port's cli.export
  (fp32 and int8), each .pt2 loaded in a ``python -I`` process that can
  import neither package, against gcc_tpu.cli.export's artifacts.
* --platforms tpu, an unknown direction, and --platforms cuda without a
  card raise.

The JAX states are built from the port's init (``to_jax_nets``); what the
init leaves at 0 or 1 (conv biases, SAGAN's gammas, BatchNorm's running
statistics) is drawn from a seed, so that every rounding point shows.
"""

import contextlib
import functools
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import export as jexport  # noqa: E402

from gcc_tpu.config import Config as JaxConfig  # noqa: E402
from gcc_tpu.utils import hlo_export as hx  # noqa: E402
from gcc_tpu_torch.cli import export as texport  # noqa: E402
from gcc_tpu_torch.config import Config  # noqa: E402
from gcc_tpu_torch.ops.layers import Conv, ConvTranspose  # noqa: E402
from gcc_tpu_torch.utils import serve_export as sx  # noqa: E402
from gcc_tpu_torch.utils.weights import to_jax_nets  # noqa: E402
from torch_limits import ONE_THREAD, one_thread, watched  # noqa: E402,F401

BF = torch.bfloat16

# tests/test_hlo_export.py's tiny configurations; the resnet's fused blocks
# on (their gate opens from a 20 px input). The students are pruned
# (blocks elided), as the generators a serving export is for: the resnet
# keeps blocks 0 and 8 of its nine (tests/test_torch_bf16.py's RESNET_CFG),
# CycleGAN's G_A blocks 0, 4 and 8 and G_B block 4, SRGAN's SRResNet blocks
# 0 and 3 of 16
FAMILIES = {
    "unet": (dict(model="pix2pix", ngf=4, ndf=4, teacher_ngf=8,
                  teacher_ndf=8, crop_size=32, num_downs=5,
                  online_distillation=True), {}),
    "resnet": (dict(model="pix2pix", backbone="resnet", ngf=4, ndf=4,
                    teacher_ngf=4, teacher_ndf=4, crop_size=32,
                    fused_resblock="on"),
               {"filter_cfgs": [3, 6, 12, 5, 12] + [0, 0] * 7
                + [3, 12, 6, 3]}),
    "cyclegan": (dict(model="cyclegan", ngf=4, ndf=4, teacher_ngf=4,
                      teacher_ndf=4, crop_size=32, pool_size=0),
                 {"cfg_AtoB": [4, 8, 16] + ([6, 16] + [0, 0] * 3) * 2
                  + [6, 16, 8, 4],
                  "cfg_BtoA": [4, 8, 16] + [0, 0] * 4 + [5, 16] + [0, 0] * 4
                  + [8, 4]}),
    "sagan": (dict(model="sagan", ngf=4, ndf=4, teacher_ngf=8,
                   teacher_ndf=8, crop_size=64, z_dim=16,
                   pallas_attn_threshold=1), {}),
    "srgan": (dict(model="srgan", ngf=4, ndf=4, image_size=32,
                   upscale_factor=4, generator_only=True),
              {"filter_cfgs": [3, 0, 0, 4] + [0] * 12}),
    "int8": (dict(model="pix2pix", ngf=16, ndf=4, teacher_ngf=8,
                  teacher_ndf=8, crop_size=32, num_downs=5), {}),
}
# (family, direction, teacher)
EXPORTS = {"unet": ("unet", "AtoB", False),
           "unet_teacher": ("unet", "AtoB", True),
           "resnet": ("resnet", "AtoB", False),
           "cyclegan_AtoB": ("cyclegan", "AtoB", False),
           "cyclegan_BtoA": ("cyclegan", "BtoA", False),
           "sagan": ("sagan", "AtoB", False),
           "srgan": ("srgan", "AtoB", False),
           "int8": ("int8", "AtoB", False)}
# gcc_tpu's programs compiled to round where their source rounds (XLA's
# excess precision would keep bf16 results in fp32, tests/test_torch_bf16.py),
# and quickly
EXACT = {"xla_allow_excess_precision": False,
         "xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}


def _engines(family):
    from gcc_tpu.engines import cyclegan as jc, pix2pix as jp, sagan as js
    from gcc_tpu.engines import srgan as jsr
    from gcc_tpu_torch.cli.train import engine_class
    kw, cfgs = FAMILIES[family]
    port = engine_class(kw["model"])(Config(**kw), device="cpu", **cfgs)
    jcls = {"pix2pix": jp.Pix2PixEngine, "cyclegan": jc.CycleGANEngine,
            "sagan": js.SAGANEngine, "srgan": jsr.SRGANEngine}[kw["model"]]
    return port, jcls(JaxConfig(**kw), **cfgs)


def lively(net, rng):
    """The init's weights (tests/test_hlo_export.py's), with what the init
    leaves at 0 or 1 drawn instead, since those hide where a bf16 net
    rounds: conv biases, SAGAN's gammas and the BatchNorm running
    statistics."""
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("gamma"):
                p.fill_(0.5)
            elif name.endswith("bias") and p.ndim == 1 \
                    and float(p.abs().max()) == 0.0:
                p.copy_(torch.from_numpy(0.1 * rng.randn(*p.shape)))
        for name, b in net.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.from_numpy(0.1 * rng.randn(*b.shape)))
            elif name.endswith("running_var"):
                b.copy_(torch.from_numpy(rng.uniform(0.5, 2, b.shape)))


@functools.lru_cache(maxsize=None)
def case(family):
    """(port engine, its state, JAX engine, a JAX state of the same nets)."""
    port, jeng = _engines(family)
    state = port.init_state(seed=0)
    rng = np.random.RandomState(1)
    for key, net in state.nets.items():
        if key.startswith(("g", "tg")):
            lively(net, rng)
    SNAPSHOTS[family] = _snapshot(state)
    jstate = types.SimpleNamespace(nets=to_jax_nets(state))
    return port, state, jeng, jstate


SNAPSHOTS = {}


def _snapshot(state):
    """Every net's tensors (copied) and its modules' train flags."""
    return {k: ({n: t.detach().clone() for n, t in net.state_dict().items()},
                [m.training for m in net.modules()])
            for k, net in state.nets.items()}


def inputs(name, batch):
    """NCHW (port) and NHWC (JAX) inputs from one numpy RandomState."""
    family = EXPORTS[name][0]
    shape = sx.example_input_shape(case(family)[0].cfg)
    rng = np.random.RandomState(batch)
    if len(shape) == 2:
        z = rng.randn(batch, shape[1]).astype(np.float32)
        return z, z
    x = (rng.rand(batch, *shape[1:]) * 2 - 1).astype(np.float32)
    return x, np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1)))


def nchw(y):
    y = np.asarray(y, np.float32)
    return y if y.ndim == 2 else np.transpose(y, (0, 3, 1, 2))


@pytest.fixture(scope="module")
def art_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("serving"))


@contextlib.contextmanager
def fused_blocks(state, flag):
    """Every MobileResnet of the state with use_fused_blocks = flag inside
    the block, as the engine had it after."""
    nets = [n for n in state.nets.values() if hasattr(n, "use_fused_blocks")]
    before = [n.use_fused_blocks for n in nets]
    for n in nets:
        n.use_fused_blocks = flag
    try:
        yield
    finally:
        for n, b in zip(nets, before):
            n.use_fused_blocks = b


@functools.lru_cache(maxsize=None)
def port_artifact(name, dtype, quant, folder, fused=True):
    """(callable module, bytes, ExportedProgram) of the port's artifact with
    a symbolic batch, saved by save_exported; an fp32 artifact without int8
    weights is read back by load_exported, the others called as exported.
    ``fused``: the engine's MobileResnets with fused blocks on (as
    configured) or off."""
    family, direction, teacher = EXPORTS[name]
    port, state, _, _ = case(family)
    with fused_blocks(state, False) if not fused else contextlib.nullcontext():
        ep = sx.export_generator(port, state,
                                 sx.example_input_shape(port.cfg),
                                 direction=direction, teacher=teacher,
                                 dtype=getattr(torch, dtype),
                                 weight_quant=quant)
    path = os.path.join(folder, f"{name}_{dtype}_{quant}_{fused}.pt2")
    size = sx.save_exported(ep, path)
    if dtype == "float32" and quant is None:
        return sx.load_exported(path), size, ep
    return ep.module(), size, ep


def run_port(mod, x, dtype="float32"):
    with torch.no_grad():
        y = mod(torch.from_numpy(x).to(getattr(torch, dtype)))
    return y.float().numpy()


@functools.lru_cache(maxsize=None)
def jax_artifact(name, dtype, quant):
    """gcc_tpu's artifact of the same weights, serialized and read back."""
    family, direction, teacher = EXPORTS[name]
    _, _, jeng, jstate = case(family)
    shape = sx.example_input_shape(case(family)[0].cfg)
    shape = shape if len(shape) == 2 else (1,) + shape[2:] + shape[1:2]
    exp = hx.export_generator(jeng, jstate, shape, direction=direction,
                              teacher=teacher, platforms=("cpu",),
                              dtype=getattr(jnp, dtype), weight_quant=quant)
    return jexport.deserialize(bytearray(bytes(exp.serialize())))


def run_jax(exp, x, dtype="float32"):
    """The artifact compiled without XLA's excess precision, which would
    skip the rounding of bf16 results (tests/test_torch_bf16.py)."""
    x = jnp.asarray(x, getattr(jnp, dtype))
    call = jax.jit(exp.call).lower(x).compile(EXACT)
    return nchw(call(x))


@functools.lru_cache(maxsize=None)
def jax_output(name, dtype, quant=None):
    """gcc_tpu's artifact on inputs(name, 3), NCHW float32."""
    return run_jax(jax_artifact(name, dtype, quant), inputs(name, 3)[1],
                   dtype)


def generate(name, x):
    family, direction, teacher = EXPORTS[name]
    port, state, _, _ = case(family)
    kw = {"direction": direction} if family == "cyclegan" else {}
    return port.generate(state, torch.from_numpy(x), teacher=teacher,
                         **kw).numpy()


FP32 = ["unet", "unet_teacher", "resnet", "cyclegan_AtoB", "cyclegan_BtoA",
        "sagan", "srgan"]


@pytest.mark.parametrize("name", FP32)
def test_artifact_matches_generate(name, art_dir):
    """One symbolic export serves batch 1 and 3 within 1e-6 of generate;
    the program mutates no buffer. SAGAN's generate takes the flash route
    (its CUDA kernels' plain versions here) where the artifact takes the
    einsum route. The resnet's artifact is one program whether the engine
    has fused blocks on or off; it holds generate with them off within
    1e-6, and with them on (B2's plain version) within the fused-unfused
    agreement of tests/test_torch_mobile_block.py (3e-6 + 1e-5 |y|)."""
    mod, _, ep = port_artifact(name, "float32", None, art_dir)
    assert not ep.graph_signature.buffers_to_mutate
    state = case(EXPORTS[name][0])[1]
    for b in (1, 3):
        x, _ = inputs(name, b)
        y = run_port(mod, x)
        assert y.shape[0] == b
        with fused_blocks(state, False):
            np.testing.assert_allclose(y, generate(name, x), atol=1e-6,
                                       rtol=0)
        if name == "resnet":
            np.testing.assert_allclose(y, generate(name, x), atol=3e-6,
                                       rtol=1e-5)
    if name == "resnet":
        mod_off, _, ep_off = port_artifact(name, "float32", None, art_dir,
                                           fused=False)
        assert ep_off.graph_module.code == ep.graph_module.code
        x, _ = inputs(name, 3)
        np.testing.assert_array_equal(run_port(mod_off, x), run_port(mod, x))
        assert state.nets["g"].use_fused_blocks is True
    if name == "sagan":  # the engine's own net keeps its threshold
        g = state.nets["g"]
        assert g.attn1.flash_threshold == g.attn2.flash_threshold == 1


@pytest.mark.parametrize("name", FP32)
def test_artifact_matches_gcc_tpu(name, art_dir):
    mod, _, _ = port_artifact(name, "float32", None, art_dir)
    x, xj = inputs(name, 3)
    np.testing.assert_allclose(run_port(mod, x), jax_output(name, "float32"),
                               atol=1e-5, rtol=0)


def rms(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def _jax_modules(tree, prefix=""):
    """flax's captured intermediates as {module path: output}."""
    out = {}
    for k, v in tree.items():
        if k == "__call__":
            out[prefix[:-1]] = v[0]
        elif isinstance(v, dict):
            out.update(_jax_modules(v, f"{prefix}{k}."))
    return out


def bf16_ulps(a, b):
    """|a - b| in bf16 ulps at the larger magnitude of the two."""
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), np.finfo(np.float32).tiny)
    return float(np.max(np.abs(a - b) / 2.0 ** (np.floor(np.log2(mag)) - 7)))


def first_difference(name):
    """Where the port's bf16 generator first leaves gcc_tpu's, module by
    module in the port's order on inputs(name, 3): (module name, module,
    port output, gcc_tpu output) or None, and gcc_tpu's output there.
    gcc_tpu's forward runs on its bf16 variables as arguments, so nothing
    of the net is folded into constants."""
    family, direction, teacher = EXPORTS[name]
    port, state, jeng, jstate = case(family)
    net, key = sx.pick_generator(port, state, direction, teacher)
    net = sx.portable(net).eval().to(BF)
    jmod = hx._portable(hx._pick_generator(jeng, direction, teacher)[0])
    jv = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                jstate.nets[key])
    x, xj = inputs(name, 3)
    xb = jnp.asarray(xj, jnp.bfloat16)

    def fwd(v, x):
        return jmod.apply(v, x, train=False, capture_intermediates=True,
                          mutable=["intermediates"])

    out, inter = jax.jit(fwd).lower(jv, xb).compile(EXACT)(jv, xb)
    inter = _jax_modules(inter["intermediates"])
    order = []
    for mname, mod in net.named_modules():
        if mname:
            mod.register_forward_hook(
                lambda m, i, o, n=mname: order.append((n, m, o)))
    with torch.no_grad():
        net(torch.from_numpy(x).to(BF))
    for n, m, o in order:
        if isinstance(o, torch.Tensor) and n in inter:
            got, want = o.float().numpy(), nchw(inter[n])
            if not np.array_equal(got, want):
                return (n, m, got, want), nchw(out)
    return None, nchw(out)


@pytest.mark.parametrize("name", ["unet", "resnet", "sagan", "srgan"])
def test_bf16_artifact_against_gcc_tpu(name, art_dir):
    """rms(port - jax_bf16) <= 1/4 rms(jax_bf16 - jax_fp32), per generator
    class (CycleGAN's is the resnet's MobileResnetGenerator), or, as
    tests/test_torch_bf16.py holds a forward in which the two frameworks'
    fp32 conv sums round apart: the first module where the port's bf16
    forward leaves gcc_tpu's is a convolution, one bf16 ulp apart in at
    most 1 % of its outputs, and gcc_tpu's forward there is its artifact's
    bit for bit. Measured: U-Net, SAGAN and SRGAN 0 (bit for bit); the
    resnet 0.381, first apart at down_0 (3x3 stride 2, 3 -> 6) in 0.022 %
    of its outputs (ROADMAP Queue C)."""
    mod, _, ep = port_artifact(name, "bfloat16", None, art_dir)
    assert not ep.graph_signature.buffers_to_mutate
    x, _ = inputs(name, 3)
    port = run_port(mod, x, "bfloat16")
    jb, j32 = jax_output(name, "bfloat16"), jax_output(name, "float32")
    ratio = rms(port - jb) / rms(jb - j32)
    print(f"bf16 {name}: rms(port - jax_bf16) / rms(jax_bf16 - jax_fp32) "
          f"= {ratio:.3g}")
    if ratio <= 0.25:
        return
    first, jax_forward = first_difference(name)
    np.testing.assert_array_equal(jax_forward, jb)
    assert first is not None
    n, m, got, want = first
    share = float(np.mean(got != want))
    print(f"bf16 {name}: first apart at {n} ({type(m).__name__}), "
          f"{bf16_ulps(got, want):.3g} ulp, {100 * share:.3g} % of outputs")
    assert isinstance(m, (Conv, ConvTranspose)), n
    assert bf16_ulps(got, want) <= 1.0, n
    assert share <= 0.01, n


def _jax_leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _jax_leaves(tree[k], f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", tree[k]


# (family, net key, layer types that must be among the quantized leaves)
QUANT_NETS = {"unet": ("unet", "g", {"Conv", "ConvTranspose"}),
              "resnet": ("resnet", "g", {"Conv", "depthwise",
                                         "ConvTranspose"}),
              "sagan_g": ("sagan", "g", {"SpectralConvTranspose",
                                         "ConvTranspose", "Conv"}),
              "sagan_d": ("sagan", "d", {"SpectralConv"}),
              "srgan_g": ("srgan", "g", {"Conv", "subpixel"}),
              "srgan_d": ("srgan", "d", {"Dense"})}


@pytest.mark.parametrize("which", list(QUANT_NETS))
def test_quantize_int8_bits_match_gcc_tpu(which):
    """Leaf by leaf, q and s are gcc_tpu's under the layout permutation of
    utils/weights.py; the same leaves are quantized; each scale rebuilds
    its channel within one step."""
    from gcc_tpu_torch.ops.layers import ConvTranspose
    from gcc_tpu_torch.utils.weights import _CONV_PERM, _DECONV_PERM
    family, key, kinds = QUANT_NETS[which]
    _, state, _, jstate = case(family)
    net = state.nets[key]
    owners = dict(net.named_modules())
    ours = sx.quantize_int8(net)
    params = jstate.nets[key]["params"]
    _, _, qinfo = hx.quantize_int8(params)
    seen, names = set(), set()
    for (path, w), info in zip(_jax_leaves(params), qinfo):
        if info is None:
            assert np.asarray(w).ndim < 2, path
            continue
        name = path[:-len("kernel")] + "weight"
        owner = owners[name.rpartition(".")[0]]
        perm = (1, 0) if w.ndim == 2 else _DECONV_PERM \
            if isinstance(owner, ConvTranspose) else _CONV_PERM
        q, s = ours[name]
        assert q.dtype == np.int8 and s.dtype == np.float32
        np.testing.assert_array_equal(q, np.transpose(info[0], perm))
        np.testing.assert_array_equal(s, np.transpose(info[1], perm))
        w = dict(net.named_parameters())[name].detach().numpy()
        assert (np.abs(q.astype(np.float32) * s - w) < s + 1e-12).all(), name
        names.add(name)
        seen.add(type(owner).__name__)
        if getattr(owner, "groups", 1) > 1:
            seen.add("depthwise")
        if "subpixel" in name:
            seen.add("subpixel")
    assert set(ours) == names
    assert kinds <= seen, (kinds, seen)


def test_int8_artifact(art_dir):
    """ngf 16, as tests/test_hlo_export.py's int8 case: the file under half
    the fp32 one, <= 0.02 and > 45 dB from generate, within 1e-5 of
    gcc_tpu's int8 artifact (the same dequantized bits), and no float copy
    of a quantized weight anywhere in the program."""
    mod32, size32, _ = port_artifact("int8", "float32", None, art_dir)
    mod, size, ep = port_artifact("int8", "float32", "int8", art_dir)
    assert size < 0.5 * size32, (size, size32)
    quantized = sx.quantize_int8(case("int8")[1].nets["g"])
    tensors = list(ep.state_dict.values()) + list(ep.constants.values())
    shapes = {q.shape for q, _ in quantized.values()}
    assert not any(t.is_floating_point() and tuple(t.shape) in shapes
                   for t in tensors)
    assert sum(t.numel() for t in tensors if t.dtype == torch.int8) == \
        sum(q.size for q, _ in quantized.values())
    assert not ep.graph_signature.buffers_to_mutate
    x, xj = inputs("int8", 3)
    y, y0 = run_port(mod, x), generate("int8", x)
    assert np.abs(y - y0).max() <= 0.02
    psnr = 10 * np.log10(4.0 / float(np.mean((y - y0) ** 2)))
    print(f"int8 artifact: {size} of {size32} bytes, {psnr:.1f} dB")
    assert psnr > 45.0, psnr
    np.testing.assert_allclose(y, jax_output("int8", "float32", "int8"),
                               atol=1e-5, rtol=0)


# the exports each family's other tests make
UNCHANGED = {"unet": (("float32", None), ("bfloat16", None)),
             "sagan": (("float32", None), ("bfloat16", None)),
             "int8": (("float32", None), ("float32", "int8"))}


@pytest.mark.parametrize("family", sorted(UNCHANGED))
def test_export_leaves_the_engine_unchanged(family, art_dir):
    """Running BatchNorm statistics (U-Net) and spectral vectors (SAGAN):
    after the family's exports in fp32, bf16 and with int8 weights, every
    net's tensors are bit for bit and its modes as they were."""
    for dtype, quant in UNCHANGED[family]:
        port_artifact(family, dtype, quant, art_dir)
    before, after = SNAPSHOTS[family], _snapshot(case(family)[1])
    assert before.keys() == after.keys()
    for k, (tensors, modes) in before.items():
        assert modes == after[k][1], k
        for n, t in tensors.items():
            assert torch.equal(t, after[k][0][n]), f"{k}.{n}"


LOADER = textwrap.dedent("""
    import importlib.util, sys
    for m in ("gcc_tpu_torch", "gcc_tpu"):
        assert importlib.util.find_spec(m) is None, m
        sys.modules[m] = None
    import numpy as np, torch
    x = torch.from_numpy(np.load(sys.argv[1]))
    for p in sys.argv[2:]:
        with torch.no_grad():
            np.save(p + ".npy", torch.export.load(p).module()(x).numpy())
""")


def test_cli_end_to_end(tmp_path, monkeypatch):
    """A gcc_tpu checkpoint through the port's cli.export (fp32 and int8);
    each .pt2 runs in a process that can import neither package and
    matches gcc_tpu.cli.export's artifact of the same checkpoint. gcc_tpu's
    CLI starts from a state of the port's init instead of flax's op-by-op
    init_state (its generator is the checkpoint's either way)."""
    from gcc_tpu.cli.export import main as jmain
    from gcc_tpu.engines.common import GANState
    from gcc_tpu.engines.pix2pix import Pix2PixEngine
    from gcc_tpu.utils.checkpoint import save_checkpoint
    _, state, jeng, jstate = case("unet")
    monkeypatch.setattr(Pix2PixEngine, "init_state", lambda self, key: GANState(
        step=jnp.int32(0), nets=dict(jstate.nets), opts={}, ema={}, rng=key))
    ckpt = os.path.join(tmp_path, "model_best.ckpt")
    save_checkpoint(ckpt, jeng.checkpoint_payload(jstate, epoch=1,
                                                  metric=0.0))
    flags = ["--model", "pix2pix", "--dataroot", str(tmp_path), "--name",
             "exp", "--checkpoints_dir", str(tmp_path), "--pretrain_path",
             ckpt, "--ngf", "4", "--ndf", "4", "--num_downs", "5",
             "--crop_size", "32"]
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    paths = []
    for quant, tag in (("none", ""), ("int8", "_int8")):
        assert texport.main(["--output_dir", port_dir, "--platforms", "cpu",
                             "--gpu_ids", "-1", "--quantize", quant]
                            + flags) == 0
        paths.append(os.path.join(port_dir, f"pix2pix_G{tag}.pt2"))
    x, xj = inputs("unet", 3)
    np.save(tmp_path / "x.npy", x)
    loader = subprocess.Popen(
        [sys.executable, "-I", "-c", LOADER, str(tmp_path / "x.npy")] + paths,
        cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={"PATH": os.environ["PATH"], **ONE_THREAD},
        start_new_session=True)
    want = []
    with watched(loader, 300, "test_cli_end_to_end: the loader"):
        for quant, tag in (("none", ""), ("int8", "_int8")):
            assert jmain(["--output_dir", jax_dir, "--platforms", "cpu",
                          "--quantize", quant] + flags) == 0
            want.append(run_jax(hx.load_exported(
                os.path.join(jax_dir, f"pix2pix_G{tag}.stablehlo")), xj))
        _, err = loader.communicate(timeout=300)
    assert loader.returncode == 0, err
    log = open(os.path.join(tmp_path, "exp", "logger.log")).read()
    assert f"exported {paths[0]} (" in log and "quantize=int8" in log
    for path, ref in zip(paths, want):
        np.testing.assert_allclose(np.load(path + ".npy"), ref, atol=1e-5,
                                   rtol=0)
    np.testing.assert_allclose(np.load(paths[0] + ".npy"),
                               generate("unet", x), atol=1e-6, rtol=0)


@pytest.mark.parametrize("family", ["unet", "cyclegan", "sagan", "srgan"])
def test_example_input_shape(family):
    """gcc_tpu's serving input shape, NHWC there and NCHW here."""
    kw = FAMILIES[family][0]
    ours = sx.example_input_shape(Config(**kw))
    theirs = hx.example_input_shape(JaxConfig(**kw))
    assert ours == (theirs if len(theirs) == 2 else
                    (theirs[0], theirs[3], theirs[1], theirs[2]))


def test_refusals(tmp_path):
    """--platforms tpu names cuda; --platforms cuda without a card raises
    before anything is written; an unknown direction raises."""
    base = ["--model", "pix2pix", "--dataroot", str(tmp_path), "--name", "r",
            "--checkpoints_dir", str(tmp_path), "--pretrain_path",
            str(tmp_path / "none.ckpt"), "--gpu_ids", "-1"]
    with pytest.raises(ValueError, match="cuda"):
        texport.main(["--platforms", "cpu,tpu"] + base)
    with pytest.raises(ValueError, match="cpu and cuda"):
        texport.main(["--platforms", "gpu"] + base)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            texport.main(["--platforms", "cpu,cuda"] + base)
        assert not os.path.exists(tmp_path / "r")
    port, state, _, _ = case("cyclegan")
    with pytest.raises(ValueError, match="direction"):
        sx.export_generator(port, state, (1, 3, 32, 32), direction="AtoC")
    with pytest.raises(ValueError, match="direction"):
        sx.pick_generator(port, case("unet")[1], "sideways")
