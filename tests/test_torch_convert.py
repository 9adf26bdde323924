"""python -m gcc_tpu_torch.cli.convert against gcc_tpu.cli.convert.

A reference-format .pth of each family (written by gcc_tpu's exporter from
seeded random weights of the port's nets at tiny widths) converted by both
packages gives byte-identical .ckpt files; converted back (--reverse) from
the port's .ckpt, both give the same .pth tensors and fields.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gcc_tpu.cli import convert as jconvert  # noqa: E402
from gcc_tpu.utils.torch_export import export_checkpoint  # noqa: E402
from gcc_tpu_torch.cli import convert  # noqa: E402
from gcc_tpu_torch.models.discriminators import (  # noqa: E402
    PatchGAN, SAGANDiscriminator, SRGANDiscriminator,
)
from gcc_tpu_torch.models.generators import (  # noqa: E402
    MobileResnetGenerator, SAGANGenerator, SRResNet, UnetGenerator,
)
from gcc_tpu_torch.utils.weights import export_jax_variables  # noqa: E402
from torch_limits import one_thread  # noqa: E402,F401

FAMILIES = ("pix2pix", "cyclegan", "sagan", "srgan")
NUM_DOWNS = 5


def _nets(model):
    if model == "pix2pix":
        return {"G": UnetGenerator(num_downs=NUM_DOWNS, ngf=4),
                "D": PatchGAN(6, 4, masked=True)}
    if model == "cyclegan":
        return {"G_A": MobileResnetGenerator(ngf=4),
                "G_B": MobileResnetGenerator(ngf=4),
                "D_A": PatchGAN(3, 4, masked=True),
                "D_B": PatchGAN(3, 4, norm="instance")}
    if model == "sagan":
        return {"G": SAGANGenerator(ngf=4, z_dim=8),
                "D": SAGANDiscriminator(4, masked=True)}
    return {"G": SRResNet(8), "D": SRGANDiscriminator(8, masked=True)}


def _random(tree, rng):
    if isinstance(tree, dict):
        return {k: _random(v, rng) for k, v in tree.items()}
    a = np.asarray(tree)
    noise = np.asarray(0.1 * rng.randn(*a.shape))  # 0-d: SAGAN's gamma
    return (noise + (1.0 if a.ndim == 1 else 0.0)).astype(a.dtype)


def _reference_pth(model, path, seed=0):
    """The reference's container for one family, as gcc_tpu exports it."""
    rng = np.random.RandomState(seed)
    ckpt = {k: _random(export_jax_variables(v), rng)
            for k, v in _nets(model).items()}
    ckpt.update(epoch=7, cfg=(None, None), fid=12.5)
    export_checkpoint(model, ckpt, path, num_downs=NUM_DOWNS)


def _args(model, src, dst, *extra):
    return ["--model", model, "--pretrain_path", str(src), "--output",
            str(dst), "--num_downs", str(NUM_DOWNS), *extra]


@pytest.mark.parametrize("model", FAMILIES)
def test_convert_byte_identical(model, tmp_path):
    pth = tmp_path / "reference.pth"
    _reference_pth(model, str(pth))
    ours, theirs = tmp_path / "ours.ckpt", tmp_path / "theirs.ckpt"
    assert convert.main(_args(model, pth, ours)) == 0
    assert jconvert.main(_args(model, pth, theirs)) == 0
    assert ours.read_bytes() == theirs.read_bytes()


def _same(a, b, where=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("model", FAMILIES)
def test_convert_reverse_same_tensors(model, tmp_path):
    """--reverse of the port's .ckpt: the same .pth as gcc_tpu's, and a
    second forward conversion of it gives the .ckpt's bytes back."""
    pth = tmp_path / "reference.pth"
    _reference_pth(model, str(pth), seed=1)
    ckpt = tmp_path / "ported.ckpt"
    assert convert.main(_args(model, pth, ckpt)) == 0
    ours, theirs = tmp_path / "ours.pth", tmp_path / "theirs.pth"
    assert convert.main(_args(model, ckpt, ours, "--reverse")) == 0
    assert jconvert.main(_args(model, ckpt, theirs, "--reverse")) == 0
    _same(torch.load(ours, weights_only=True),
          torch.load(theirs, weights_only=True))
    again = tmp_path / "again.ckpt"
    assert convert.main(_args(model, ours, again)) == 0
    assert again.read_bytes() == ckpt.read_bytes()


def test_reference_metric_as_numpy_scalar(tmp_path):
    """The reference saves its FID as the float64 its metric returns; the
    port reads it with weights_only=True all the same."""
    pth = tmp_path / "reference.pth"
    _reference_pth("srgan", str(pth))
    obj = torch.load(pth, weights_only=True)
    obj["psnr"] = np.float64(27.25)
    torch.save(obj, pth)
    out = convert.convert("srgan", str(pth), str(tmp_path / "o.ckpt"))
    assert float(out["fid"]) == 27.25
