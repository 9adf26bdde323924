"""The port's evaluator networks (gcc_tpu_torch/metrics/{inception,miou}.py
and the evaluator trees of utils/weights.py) against the JAX package's.

Random weights made by gcc_tpu's from-spec torch topologies
(utils/torch_ref_evaluators.py: every BatchNorm statistic randomised,
running variances positive) go through both packages' loaders; the same
numpy inputs go through both networks. JAX's networks run jitted, once per
shape. Bounds: forward 1e-4 relative (tests/test_evaluator_parity.py), the
299 resize 1e-5, Pillow's float logit resize 1e-5.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from gcc_tpu.metrics import inception as jinc  # noqa: E402
from gcc_tpu.metrics import miou as jmiou  # noqa: E402
from gcc_tpu.metrics.vgg import load_torch_vgg19 as jload_vgg  # noqa: E402
from gcc_tpu.utils import torch_ref_evaluators as tre  # noqa: E402
from gcc_tpu_torch.metrics import inception as inc  # noqa: E402
from gcc_tpu_torch.metrics import miou  # noqa: E402
from gcc_tpu_torch.utils import weights  # noqa: E402

THIN_DRN = (1, 1, 2, 2, 2, 2, 1, 1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(ours, theirs) -> float:
    ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs,
                                                            np.float64)
    return float(np.abs(ours - theirs).max() / max(np.abs(theirs).max(),
                                                   1e-8))


@pytest.fixture(scope="module")
def inception_sd():
    tm = tre.TFIDInception()
    tre.randomize(tm, seed=3)
    return {k: v.numpy() for k, v in tm.state_dict().items()}


@pytest.fixture(scope="module")
def jax_inception(inception_sd):
    return jinc.load_torch_fid_inception(inception_sd)


@pytest.fixture(scope="module")
def port_inception(inception_sd):
    return inc.load_torch_fid_inception(inception_sd)


@functools.lru_cache(maxsize=None)
def _drn_sd(layers, seed=11):
    tm = tre.TDRNSeg(layers=layers)
    tre.randomize(tm, seed=seed)
    tm.restore_fixed_up()
    # reference checkpoints carry DataParallel's 'module.' prefix
    return {"module." + k: v.numpy() for k, v in tm.state_dict().items()}


def _tree_equal(a, b) -> bool:
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    return (jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
            and all(np.array_equal(np.asarray(x), np.asarray(y))
                    for x, y in zip(la, lb)))


def test_inception_at_75_matches_jax(jax_inception, port_inception,
                                     monkeypatch):
    """Two images at 75², no resize: every block and pool of the network."""
    x = np.random.RandomState(7).rand(2, 75, 75, 3).astype(np.float32)
    theirs = jax.jit(lambda p, v: jinc.FIDInceptionV3(
        resize_input=False).apply({"params": p}, v))(jax_inception,
                                                     jnp.asarray(x))
    monkeypatch.setattr(port_inception, "resize_input", False)
    with torch.no_grad():
        ours = port_inception(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert ours.shape == (2, 2048)
    assert _rel(ours, theirs) < 1e-4, _rel(ours, theirs)


def test_inception_full_protocol_matches_jax(jax_inception, port_inception):
    """One [-1, 1] image through each package's extractor: uint8, /255,
    the 299 resize, 2x - 1, the network, the global mean."""
    img = np.random.RandomState(8).uniform(-1, 1, (1, 64, 48, 3)).astype(
        np.float32)
    theirs = jinc.InceptionExtractor(jax_inception).activations(img)
    ours = inc.InceptionExtractor(port_inception,
                                  device="cpu").activations(img)
    assert _rel(ours, theirs) < 1e-4, _rel(ours, theirs)


def test_resize_299_matches_jax():
    x = np.random.RandomState(0).rand(1, 17, 23, 3).astype(np.float32)
    theirs = jax.image.resize(jnp.asarray(x), (1, 299, 299, 3), "bilinear",
                              antialias=False)
    ours = inc.resize_299(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(),
                               np.asarray(theirs), atol=1e-5, rtol=1e-5)


class _Recorder(torch.nn.Module):
    """Stands in for the network: keeps what the extractor feeds it."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def forward(self, x):
        self.seen.append(x.clone())
        return x.mean(dim=(2, 3))


def test_extractor_uint8_round_trip():
    """The network sees gcc_tpu's quantised images bit for bit, values on
    both sides of the clip included."""
    imgs = np.random.RandomState(1).uniform(-1.2, 1.2, (3, 8, 8, 3)).astype(
        np.float32)
    rec = _Recorder()
    inc.InceptionExtractor(rec, device="cpu").activations(imgs)
    u8 = np.clip((imgs + 1) / 2 * 255.0, 0, 255).astype(np.uint8)
    want = u8.astype(np.float32) / 255.0  # gcc_tpu's InceptionExtractor
    got = rec.seen[0].permute(0, 2, 3, 1).numpy()
    assert np.array_equal(got, want)


def test_extractor_batching(port_inception, monkeypatch):
    """Batches of 2 over 5 images give batch 5's activations."""
    net = port_inception
    monkeypatch.setattr(net, "resize_input", False)
    imgs = np.random.RandomState(2).uniform(-1, 1, (5, 75, 75, 3)).astype(
        np.float32)
    whole = inc.InceptionExtractor(net, "cpu", batch_size=5).activations(imgs)
    parts = inc.InceptionExtractor(net, "cpu", batch_size=2).activations(imgs)
    assert parts.shape == (5, 2048)
    np.testing.assert_allclose(parts, whole, rtol=0, atol=1e-6 * np.abs(
        whole).max())


@pytest.mark.parametrize("layers,hw", [(THIN_DRN, (32, 64)),
                                       (jmiou.DRN_D_105_LAYERS, (32, 32))],
                         ids=["thin", "drn_d_105"])
def test_drnseg_matches_jax(layers, hw):
    """Logits after the fixed 8x upsample, from a 'module.'-prefixed
    checkpoint whose depths both packages read from its keys."""
    sd = _drn_sd(layers)
    jsd = jmiou._drn_sd(sd)
    assert miou.infer_drn_layers(miou._drn_sd(sd)) == \
        jmiou.infer_drn_layers(jsd) == layers
    x = np.random.RandomState(5).randn(1, *hw, 3).astype(np.float32)
    params = jmiou.load_torch_drnseg(jsd, layers=layers)
    theirs = jax.jit(lambda p, v: jmiou.upsample_logits_8x(
        jmiou.DRNSeg(layers=layers).apply({"params": p}, v)))(
        params, jnp.asarray(x))
    net = miou.load_torch_drnseg(sd)
    with torch.no_grad():
        ours = miou.upsample_logits_8x(net(torch.from_numpy(x).permute(
            0, 3, 1, 2))).permute(0, 2, 3, 1).numpy()
    assert ours.shape == (1, *hw, 19)
    assert _rel(ours, theirs) < 1e-4, _rel(ours, theirs)


def test_histogram_and_miou_match_jax():
    rng = np.random.RandomState(4)
    pred = rng.randint(0, 19, 5000)
    label = rng.randint(-1, 21, 5000)  # out-of-range labels are skipped
    hist = miou.fast_hist(pred, label, 19)
    assert np.array_equal(hist, jmiou.fast_hist(pred, label, 19))
    assert np.array_equal(miou.per_class_iu(hist), jmiou.per_class_iu(hist))
    hist[3] = 0  # a class never seen: nan, skipped by the mean
    assert miou.miou_from_hist(hist) == jmiou.miou_from_hist(hist)


def test_logit_resize_matches_pillow():
    """Pillow's per-channel float bilinear (gcc_tpu's resize_logits_pil)."""
    x = np.random.RandomState(6).randn(2, 13, 21, 4).astype(np.float32) * 5
    ours = miou.resize_logits_pil(x, 56, 40)
    theirs = jmiou.resize_logits_pil(x, 56, 40)
    assert ours.shape == theirs.shape == (2, 40, 56, 4)
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5)


def _cityscapes_root(tmp_path, n=3, h=64, w=128):
    """An aligned val root, trainIds labels and table.txt (the reference's
    datasets/table.txt: "<name> <label file> <leftImg8bit file>")."""
    root = tmp_path / "cityscapes"
    (root / "val").mkdir(parents=True)
    (root / "labels").mkdir()
    rng = np.random.RandomState(3)
    lines = []
    for i in range(n):
        name = f"img_{i:03d}"
        Image.fromarray((rng.rand(16, 32, 3) * 255).astype(np.uint8)).save(
            root / "val" / f"{name}.png")
        Image.fromarray(rng.randint(0, 19, (h, w)).astype(np.uint8)).save(
            root / "labels" / f"{name}_label.png")
        lines.append(f"{name} labels/{name}_label.png {name}_leftImg8bit.png")
    (root / "table.txt").write_text("\n".join(lines) + "\n")
    return root


def test_compute_miou_matches_jax(tmp_path):
    """The protocol end to end on a thin DRN: fakes resized to the labels'
    64x128, DRN, 8x upsample, argmax, table.txt lookup, histogram."""
    from gcc_tpu.config import Config as JConfig
    from gcc_tpu.data.datasets import AlignedDataset as JAligned
    from gcc_tpu_torch.config import Config
    from gcc_tpu_torch.data.datasets import AlignedDataset

    root = _cityscapes_root(tmp_path)
    drn = str(root / "drn.npz")
    np.savez(drn, **miou._drn_sd(_drn_sd(THIN_DRN)))
    # the fakes of a generator that mostly copies its input: not uniform
    fakes = np.random.RandomState(9).uniform(-1, 1, (3, 16, 16, 3)).astype(
        np.float32)
    kw = dict(dataroot=str(root), phase="val", drn_path=drn,
              load_size=16, crop_size=16)
    jcfg, cfg = JConfig(**kw), Config(**kw)
    theirs = jmiou.compute_miou(jcfg, fakes, JAligned(jcfg))
    ours = miou.compute_miou(cfg, fakes, AlignedDataset(cfg), device="cpu")
    assert np.isfinite(ours) and ours == theirs


@pytest.mark.parametrize("kind", ["inception", "drn", "vgg"])
def test_evaluator_trees_both_ways(kind, jax_inception, port_inception):
    """utils/weights.py: the port's state dict -> gcc_tpu's tree equals
    gcc_tpu's own loader bit for bit, and the tree -> the port's state
    dict strict-loads into the port's network to the same tensors."""
    if kind == "inception":
        theirs, net = jax_inception, port_inception
    elif kind == "drn":
        sd = _drn_sd(THIN_DRN)
        theirs = jmiou.load_torch_drnseg(jmiou._drn_sd(sd), layers=THIN_DRN)
        net = miou.load_torch_drnseg(sd)
    else:
        from gcc_tpu_torch.metrics.vgg import TruncatedVGG19
        tm = tre.TVGG19Features()
        tre.randomize(tm, seed=5)
        theirs = jload_vgg({k: v.numpy() for k, v in tm.state_dict().items()})
        net = TruncatedVGG19()
        weights.load_jax_variables(net, {"params": theirs})
    theirs = jax.tree_util.tree_map(np.asarray, theirs)
    port_sd = {k: v.numpy() for k, v in net.state_dict().items()}
    assert _tree_equal(weights.evaluator_tree(kind, port_sd), theirs)
    back = weights.evaluator_state_dict(kind, theirs)
    fresh = type(net)() if kind != "drn" else miou.DRNSeg(THIN_DRN)
    fresh.load_state_dict({k: torch.from_numpy(v) for k, v in back.items()},
                          strict=True)
    for k, v in net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(fresh.state_dict()[k], v), k
    assert set(back) == {k for k in port_sd
                         if not k.endswith("num_batches_tracked")}
    # strict: a leaf too many or too few raises
    extra = dict(theirs, stray={"kernel": np.zeros(1)})
    with pytest.raises(ValueError, match="leaves"):
        weights.evaluator_state_dict(kind, extra)
    port_sd.pop(next(iter(port_sd)))
    with pytest.raises(ValueError, match="missing"):
        weights.evaluator_tree(kind, port_sd)


def test_best_metric_direction(tmp_path):
    """The best checkpoint follows the metric the eval reports: mIoU and
    the PSNR proxy rise, FID falls. gcc_tpu agrees except where it
    maximises an FID (ROADMAP Queue C)."""
    from gcc_tpu.config import Config as JConfig
    from gcc_tpu.utils.best_info import maximize_metric as jmaximize
    from gcc_tpu_torch.config import Config
    from gcc_tpu_torch.utils.best_info import BestInfo, maximize_metric

    root = tmp_path / "cityscapes"
    root.mkdir()
    inception, drn = tmp_path / "inception.npz", tmp_path / "drn.npz"
    inception.write_bytes(b"x")
    cases = [  # (kw, files present, maximise)
        (dict(model="pix2pix"), (), True),  # the PSNR proxy
        (dict(model="pix2pix", drn_path=str(drn)), (drn,), True),  # mIoU
        (dict(model="pix2pix", inception_path=str(inception)),
         (root / "real_stat_B.npz",), False),  # FID without DRN weights
        (dict(model="cyclegan"), (), False),
        (dict(model="srgan"), (), True)]
    for kw, files, want in cases:
        for f in files:
            f.write_bytes(b"x")
        cfg = Config(dataroot=str(root), **kw)
        assert maximize_metric(cfg) is want, kw
        best = BestInfo(cfg)
        assert best.update(1.0, 1) and best.update(2.0 if want else 0.5, 2)
        if want:  # the two falling cases are gcc_tpu's fault
            assert jmaximize(JConfig(dataroot=str(root), **kw))
        for f in files:
            f.unlink()


class _Log:
    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(msg)


class _Engine:
    """Stands in for an engine: the orchestrators need only generate."""
    device = torch.device("cpu")

    def generate(self, state, x, direction=None):
        return torch.zeros(x.shape[0], 3, 8, 8)


@pytest.mark.parametrize("model", ["sagan", "cyclegan"])
def test_fid_branch_of_each_family(model, tmp_path, monkeypatch):
    """SAGAN's FID (real_stat_B) and CycleGAN's per direction (AtoB against
    real_stat_B, BtoA against real_stat_A), as gcc_tpu's orchestrators
    choose them, with no [proxy] line. The network and the 2048-d sqrtm
    are stood in for (the branches, not the numbers, are under test)."""
    from gcc_tpu_torch.config import Config
    from gcc_tpu_torch.eval import orchestrators
    from gcc_tpu_torch.metrics import inception as port_inc

    class Extractor:
        def activations(self, images):
            return np.zeros((len(images), 2048))

    monkeypatch.setattr(port_inc.InceptionExtractor, "get",
                        classmethod(lambda cls, path, device: Extractor()))
    monkeypatch.setattr(orchestrators, "fid_from_activations",
                        lambda acts, mu, sigma: float(mu[0]))
    weights = tmp_path / "inception.npz"
    weights.write_bytes(b"x")
    for side, marker in (("B", 1.0), ("A", 2.0)):
        np.savez(tmp_path / f"real_stat_{side}.npz",
                 mu=np.full(2048, marker), sigma=np.eye(2048))
    cfg = Config(model=model, dataset_mode="synthetic", dataroot=str(tmp_path),
                 crop_size=8, load_size=8, max_dataset_size=20,
                 inception_path=str(weights))
    log = _Log()
    perf = orchestrators.evaluate_engine(cfg, _Engine(), None, log, 1)
    assert not any("[proxy]" in x for x in log.lines)
    if model == "sagan":
        assert perf == 1.0 and log.lines == ["FID: 1.00"]
    else:
        assert perf == {"AtoB": 1.0, "BtoA": 2.0}
        assert log.lines == ["AtoB FID: 1.00", "BtoA FID: 2.00"]
