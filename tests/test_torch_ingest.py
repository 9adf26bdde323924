"""Evaluator ingestion and real statistics in the port
(gcc_tpu_torch/metrics/ingest.py, cli/convert.py --evaluator,
cli/get_real_stat.py) against the JAX package's.

Fixtures are gcc_tpu's from-spec torch evaluators with random weights
(tests/test_ingest.py's): the port strict-loads them, checks its network
against float64 on the CPU (1e-4 relative), and writes an .npz that
gcc_tpu's loaders read as the same tree, bit for bit. The five error cases
are tests/test_ingest.py:69-112's. Without a card, the entry points raise
unless the CPU is asked for.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from PIL import Image  # noqa: E402

from gcc_tpu.metrics import ingest as jingest  # noqa: E402
from gcc_tpu.metrics.inception import load_torch_fid_inception  # noqa: E402
from gcc_tpu.metrics.miou import load_torch_drnseg  # noqa: E402
from gcc_tpu.metrics.vgg import load_torch_vgg19  # noqa: E402
from gcc_tpu.utils import torch_ref_evaluators as tre  # noqa: E402
from gcc_tpu_torch.metrics import inception as port_inception  # noqa: E402
from gcc_tpu_torch.metrics import miou as port_miou  # noqa: E402
from gcc_tpu_torch.metrics import vgg as port_vgg  # noqa: E402
from gcc_tpu_torch.metrics.ingest import (IngestError,  # noqa: E402
                                          ingest_evaluator)

THIN_DRN = (1, 1, 2, 2, 2, 2, 1, 1)
JAX_LOADERS = {"inception": load_torch_fid_inception,
               "drn": lambda p: load_torch_drnseg(p, layers=THIN_DRN),
               "vgg": load_torch_vgg19}
# the port's readers, each to a state dict of tensors
PORT_LOADERS = {
    "inception": lambda p: port_inception.load_torch_fid_inception(
        p).state_dict(),
    "drn": lambda p: port_miou.load_torch_drnseg(p).state_dict(),
    "vgg": lambda p: {f"{conv}.{leaf}": torch.from_numpy(v)
                      for conv, node in port_vgg.load_torch_vgg19(p).items()
                      for leaf, v in node.items()}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fixture(kind, tmp_path, seed=0):
    if kind == "inception":
        tm = tre.TFIDInception()
    elif kind == "drn":
        tm = tre.TDRNSeg(layers=THIN_DRN)
    else:
        tm = tre.TVGG19Features()
    tre.randomize(tm, seed=seed)
    if kind == "drn":
        tm.restore_fixed_up()
    path = str(tmp_path / f"{kind}.pth")
    sd = tm.state_dict()
    if kind == "drn":  # reference checkpoints carry DataParallel prefixes
        sd = {"module." + k: v for k, v in sd.items()}
    torch.save(sd, path)
    return path


def _same_tree(a, b) -> bool:
    a = jax.tree_util.tree_map(np.asarray, a)
    b = jax.tree_util.tree_map(np.asarray, b)
    return (jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
            and all(np.array_equal(x, y) for x, y in zip(
                jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b))))


@pytest.mark.parametrize("kind", ["inception", "drn", "vgg"])
def test_ingest_happy_path(kind, tmp_path):
    """The port's report has gcc_tpu's keys; its .npz is gcc_tpu's tree
    bit for bit; gcc_tpu's .npz loads into the port to the same tensors."""
    path = _fixture(kind, tmp_path)
    layers = THIN_DRN if kind == "drn" else None
    out = str(tmp_path / f"{kind}.npz")
    report = ingest_evaluator(kind, path, out, layers=layers, device="cpu")
    assert report["roundtrip"] == "bitwise"
    assert report["forward_rel_err_vs_torch"] < 1e-4
    theirs_out = str(tmp_path / f"{kind}_jax.npz")
    theirs = jingest.ingest_evaluator(kind, path, theirs_out, layers=layers,
                                      parity=False)
    assert set(report) == set(theirs) | {"forward_rel_err_vs_torch"}
    assert report["leaves"] == theirs["leaves"]
    assert report["keys_in_file"] == theirs["keys_in_file"]
    load = JAX_LOADERS[kind]
    assert _same_tree(load(out), load(path))
    # and back: gcc_tpu's .npz (the file's keys as they were) loads through
    # the port's reader to the same tensors
    ours, back = PORT_LOADERS[kind](out), PORT_LOADERS[kind](theirs_out)
    assert ours.keys() == back.keys()
    assert all(torch.equal(ours[k], back[k]) for k in ours)


def test_ingest_missing_keys_actionable(tmp_path):
    sd = tre.TVGG19Features().state_dict()
    sd.pop("features.28.weight")
    path = str(tmp_path / "bad.pth")
    torch.save(sd, path)
    with pytest.raises(IngestError, match="features.28.weight"):
        ingest_evaluator("vgg", path, str(tmp_path / "o.npz"), parity=False,
                         device="cpu")


def test_ingest_wrong_shapes_actionable(tmp_path):
    sd = tre.TVGG19Features().state_dict()
    sd["features.0.weight"] = torch.zeros(8, 3, 3, 3)  # wrong out-channels
    path = str(tmp_path / "bad.pth")
    torch.save(sd, path)
    with pytest.raises(IngestError, match="shape mismatch"):
        ingest_evaluator("vgg", path, str(tmp_path / "o.npz"), parity=False,
                         device="cpu")


def test_ingest_wrong_family_actionable(tmp_path):
    """The vgg file handed to the inception ingester names the expected
    source."""
    path = _fixture("vgg", tmp_path)
    with pytest.raises(IngestError, match="TF-FID"):
        ingest_evaluator("inception", path, str(tmp_path / "o.npz"),
                         parity=False, device="cpu")


def test_ingest_not_a_state_dict(tmp_path):
    path = str(tmp_path / "junk.pth")
    torch.save([1, 2, 3], path)
    with pytest.raises(IngestError, match="state_dict"):
        ingest_evaluator("vgg", path, str(tmp_path / "o.npz"), device="cpu")


def test_ingest_container_descent(tmp_path):
    tm = tre.TVGG19Features()
    tre.randomize(tm, seed=4)
    path = str(tmp_path / "ckpt.pth")
    torch.save({"epoch": 3, "state_dict": tm.state_dict()}, path)
    report = ingest_evaluator("vgg", path, str(tmp_path / "o.npz"),
                              device="cpu")
    assert report["container"] == "descended into 'state_dict'"
    assert report["forward_rel_err_vs_torch"] < 1e-4


def test_ingest_reference_extras(tmp_path):
    """The reference's own files carry keys the evaluator never reads: the
    TF-FID InceptionV3's 1008-way fc head and DRN's fixed up kernel. The
    port sets them aside and strict-loads the rest (gcc_tpu's inception
    self-check refuses the fc head: ROADMAP Queue C)."""
    sd = dict(tre.TFIDInception().state_dict(), **{
        "fc.weight": torch.zeros(1008, 2048), "fc.bias": torch.zeros(1008)})
    inc = str(tmp_path / "pt_inception.pth")
    torch.save(sd, inc)
    report = ingest_evaluator("inception", inc, str(tmp_path / "i.npz"),
                              parity=False, device="cpu")
    assert report["keys_in_file"] == len(sd) and report["leaves"] == 470
    assert "fc.weight" not in np.load(str(tmp_path / "i.npz")).files
    drn = _fixture("drn", tmp_path)
    assert "module.up.weight" in torch.load(drn, weights_only=True)
    report = ingest_evaluator("drn", drn, str(tmp_path / "d.npz"),
                              layers=THIN_DRN, parity=False, device="cpu")
    assert report["roundtrip"] == "bitwise"
    assert _same_tree(load_torch_drnseg(str(tmp_path / "d.npz"),
                                        layers=THIN_DRN),
                      load_torch_drnseg(drn, layers=THIN_DRN))


def test_convert_evaluator_cli(tmp_path, capsys):
    """python -m gcc_tpu_torch.cli.convert --evaluator: on the CPU with
    --gpu_ids -1; without it and without a card it raises."""
    from gcc_tpu_torch.cli.convert import main
    path = _fixture("drn", tmp_path)
    out = str(tmp_path / "drn.npz")
    args = ["--evaluator", "drn", "--pretrain_path", path, "--output", out,
            "--drn_layers", ",".join(map(str, THIN_DRN))]
    assert main(args + ["--gpu_ids", "-1"]) == 0
    assert '"roundtrip": "bitwise"' in capsys.readouterr().out
    assert _same_tree(JAX_LOADERS["drn"](out), JAX_LOADERS["drn"](path))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(args)


def _aligned_root(root, n=4, w=64, h=32):
    (root / "train").mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(n):
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
            root / "train" / f"img_{i:03d}.png")


def test_get_real_stat_matches_jax(tmp_path):
    """real_stat_B.npz over the same 4 images: the port's mu and sigma are
    the statistics of its activations, which are gcc_tpu's within 1e-4
    relative; mu is gcc_tpu.cli.get_real_stat's within 1e-4 relative, and
    sigma within what that activation difference allows (the covariance of
    4 nearly equal vectors cancels most of their digits). Without a card
    and without --gpu_ids -1 the port raises."""
    from gcc_tpu.cli.get_real_stat import main as jmain
    from gcc_tpu.metrics.inception import InceptionExtractor as JExtractor
    from gcc_tpu_torch.cli.get_real_stat import main
    from gcc_tpu_torch.config import parse
    from gcc_tpu_torch.data import create_dataset
    from gcc_tpu_torch.metrics.fid import activation_statistics
    from gcc_tpu_torch.metrics.inception import InceptionExtractor

    root = tmp_path / "facades"
    _aligned_root(root)
    weights = str(tmp_path / "inception.npz")
    ingest_evaluator("inception", _fixture("inception", tmp_path), weights,
                     parity=False, device="cpu")
    args = (f"--dataroot {root} --dataset_mode aligned --model pix2pix "
            f"--load_size 32 --crop_size 32 --batch_size 4 "
            f"--inception_path {weights}").split()
    stat = root / "real_stat_B.npz"
    assert jmain(args) == 0
    with np.load(stat) as z:
        mu_j, sigma_j = z["mu"], z["sigma"]
    stat.unlink()
    assert main(args + ["--gpu_ids", "-1"]) == 0
    with np.load(stat) as z:
        mu, sigma = z["mu"], z["sigma"]
    assert mu.shape == (2048,) and sigma.shape == (2048, 2048)

    cfg = parse(args).replace(serial_batches=True, no_flip=True)
    imgs = np.concatenate([b["B"] for b in create_dataset(cfg, seed=0)])
    acts = InceptionExtractor.get(weights, "cpu").activations(imgs)
    acts_j = JExtractor.get(weights).activations(imgs)
    mine = activation_statistics(acts)
    assert np.array_equal(mine[0], mu) and np.array_equal(mine[1], sigma)
    e = np.abs(acts - acts_j).max()
    assert e <= 1e-4 * np.abs(acts_j).max()
    assert np.abs(mu - mu_j).max() <= 1e-4 * np.abs(mu_j).max()
    # each centred value moves by at most 2e: bound the products' change
    n, d = len(acts), np.abs(acts_j - mu_j).max()
    assert np.abs(sigma - sigma_j).max() <= n / (n - 1) * (4 * e * d
                                                           + 4 * e * e)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(args)
