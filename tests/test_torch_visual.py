"""The port's last utilities against the JAX package's:
gcc_tpu_torch/utils/visual.py (weight-norm histograms, diagnose_network,
HTMLGallery) and gcc_tpu_torch/utils/get_data.py (the dataset downloader,
with urllib's download replaced: no network)."""

import io
import os
import tarfile
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gcc_tpu_torch.models.generators import MobileResnetGenerator  # noqa: E402
from gcc_tpu_torch.utils import get_data, visual  # noqa: E402
from gcc_tpu_torch.utils.weights import load_jax_variables  # noqa: E402
from torch_limits import one_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def carried():
    """A JAX MobileResnet's variables and the port's net that holds them."""
    import jax
    import jax.numpy as jnp

    from gcc_tpu.models.generators import MobileResnetGenerator as JaxG
    v = JaxG(ngf=4, n_blocks=1).init({"params": jax.random.PRNGKey(3)},
                                     jnp.zeros((1, 32, 32, 3)), train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    net = MobileResnetGenerator(ngf=4, n_blocks=1)
    load_jax_variables(net, v)
    return v, net


def test_weight_distribution_matches_gcc_tpu(carried, tmp_path):
    from gcc_tpu.compress.prune import l1_out
    from gcc_tpu.utils.visual import plot_weight_distribution
    v, net = carried
    ref = {}

    def walk(node, prefix=""):
        for k, x in node.items():
            if isinstance(x, dict):
                walk(x, f"{prefix}{k}/")
            elif k == "kernel" and x.ndim == 4:
                ref[f"{prefix}{k}"] = l1_out(x)

    walk(v["params"])
    for source in (net, v, v["params"]):
        norms = visual.weight_norms(source)
        assert list(norms) == list(ref)
        for k in ref:  # transposed convs by their out channels too
            np.testing.assert_allclose(norms[k], ref[k], rtol=1e-12)
    ours = visual.plot_weight_distribution(net, str(tmp_path / "port"))
    theirs = plot_weight_distribution(v["params"], str(tmp_path / "jax"))
    assert len(ours) == len(ref) == len(theirs)
    assert [os.path.basename(f) for f in ours] == \
        [os.path.basename(f) for f in theirs]
    assert all(os.path.getsize(f) > 0 for f in ours)


def test_diagnose_network_matches_gcc_tpu(carried, capsys):
    from gcc_tpu.utils.visual import diagnose_network
    v, net = carried
    ref = diagnose_network(v["params"], "g")
    assert abs(visual.diagnose_network(net, "g") - ref) < 1e-6
    grads = {"a": torch.full((3, 2), -2.0), "b": [torch.ones(4), None]}
    assert abs(visual.diagnose_network(grads) - diagnose_network(
        {"a": np.full((3, 2), -2.0), "b": [np.ones(4), None]})) < 1e-6
    assert visual.diagnose_network({}) == 0.0
    assert "g: mean abs = " in capsys.readouterr().out


def test_html_gallery_matches_gcc_tpu(tmp_path):
    from PIL import Image

    from gcc_tpu.utils.visual import HTMLGallery
    rng = np.random.RandomState(0)
    rows = [("sample<0>", {"real": rng.rand(8, 12, 3) * 2 - 1,
                           "fake & co": rng.rand(1, 8, 12, 3) * 2 - 1}),
            ("sample1", {"gray": rng.rand(8, 12, 1) * 2 - 1})]
    pages = {}
    for who, cls in (("port", visual.HTMLGallery), ("jax", HTMLGallery)):
        g = cls(str(tmp_path / who), title="t <1>")
        for name, images in rows:
            g.add_images({k: a.astype(np.float32) for k, a in images.items()},
                         name, width=128)
        pages[who] = open(g.save()).read()
    assert pages["port"] == pages["jax"]
    names = sorted(os.listdir(tmp_path / "jax" / "images"))
    assert sorted(os.listdir(tmp_path / "port" / "images")) == names
    assert len(names) == 3
    for f in names:
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "port" / "images" / f)),
            np.asarray(Image.open(tmp_path / "jax" / "images" / f)))


def test_get_data_tables_match_gcc_tpu():
    from gcc_tpu.utils import get_data as ref
    for name in ("PIX2PIX_URL", "CYCLEGAN_URL", "PIX2PIX_DATASETS",
                 "CYCLEGAN_DATASETS", "SR_URLS", "SR_DATASETS"):
        assert getattr(get_data, name) == getattr(ref, name), name
    for technique in ("pix2pix", "cyclegan", "sr", "CycleGAN"):
        ours = get_data.GetData(technique, "unused")
        theirs = ref.GetData(technique, "unused")
        assert ours.available() == theirs.available()
        for d in ours.available():
            assert ours._url_for(d) == theirs._url_for(d)


def _zip_bytes(name):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr(f"{name}/trainA/a.txt", "a")
    return buf.getvalue()


def _tar_gz_bytes(name):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as t:
        data = b"b"
        info = tarfile.TarInfo(f"{name}/train/b.txt")
        info.size = len(data)
        t.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def test_get_data_without_network(tmp_path, monkeypatch):
    import urllib.request
    fetched = []

    def offline(url, path):
        fetched.append(url)
        raise OSError("no route to host")

    monkeypatch.setattr(urllib.request, "urlretrieve", offline)
    gd = get_data.GetData("sr", str(tmp_path / "sr"))
    with pytest.raises(ValueError, match="unknown dataset"):
        gd.get("not_a_dataset")
    with pytest.raises(RuntimeError, match="Flickr2K.tar"):
        gd.get("flickr2k")
    # an existing target: no download
    (tmp_path / "sr" / "coco_val2014").mkdir(parents=True)
    assert gd.get("coco_val2014") == str(tmp_path / "sr" / "coco_val2014")
    assert fetched == [get_data.SR_URLS["flickr2k"]]

    def archive(url, path):
        fetched.append(url)
        name = os.path.basename(path).split(".")[0]
        with open(path, "wb") as f:
            f.write(_zip_bytes(name) if path.endswith(".zip")
                    else _tar_gz_bytes(name))

    monkeypatch.setattr(urllib.request, "urlretrieve", archive)
    for technique, dataset, inner in (("cyclegan", "horse2zebra", "trainA"),
                                      ("pix2pix", "facades", "train")):
        root = tmp_path / technique
        target = get_data.GetData(technique, str(root)).get(dataset)
        assert target == str(root / dataset)
        assert os.path.isdir(os.path.join(target, inner))
        assert os.listdir(root) == [dataset]  # the archive removed
    assert fetched[-2:] == [
        get_data.CYCLEGAN_URL + "horse2zebra.zip",
        get_data.PIX2PIX_URL + "facades.tar.gz"]


def test_the_boundary_test_covers_the_new_modules():
    """tests/test_torch_boundary.py checks every .py of the port, these
    two and parallel/spatial.py among them."""
    import test_torch_boundary as tb
    names = {str(p.relative_to(tb.ROOT)) for p in tb.PORT_FILES}
    assert {"gcc_tpu_torch/utils/visual.py", "gcc_tpu_torch/utils/get_data.py",
            "gcc_tpu_torch/parallel/spatial.py"} <= names
