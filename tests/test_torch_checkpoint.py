"""The port's checkpoints against flax's, and its full-state resume.

* ``utils/msgpack_lite`` writes the bytes ``flax.serialization`` writes for
  the same tree, and reads flax's bytes back to the same tree (ints of
  every width, strings, bytes, None, bools, floats, arrays incl. 0-d,
  numpy scalars, chunked arrays).
* ``save_checkpoint``/``load_checkpoint`` of ``gcc_tpu.utils.checkpoint``
  and of the port read each other's files: equal trees, exact arrays, a
  ``None`` metric, a list cfg and 0-d cfg entries.
* Empty, torn and newer-schema files raise ``CheckpointError``.
* ``save_state``/``load_state`` carry an engine's full state (nets, every
  Adam and DupAdam moment and count, EMA, step, dropout generator,
  CycleGAN's replay pools and their generator) bit for bit: a restored
  state's next iteration equals the saved run's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flax import serialization  # noqa: E402

from gcc_tpu.utils import checkpoint as jckpt  # noqa: E402
from gcc_tpu_torch.config import Config  # noqa: E402
from gcc_tpu_torch.engines.cyclegan import CycleGANEngine  # noqa: E402
from gcc_tpu_torch.engines.pix2pix import Pix2PixEngine  # noqa: E402
from gcc_tpu_torch.engines.sagan import SAGANEngine  # noqa: E402
from gcc_tpu_torch.engines.srgan import SRGANEngine  # noqa: E402
from gcc_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from gcc_tpu_torch.utils import msgpack_lite  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny nets run best on one intra-op thread, and the test workers that
    share the host's cores then do not oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree():
    rng = np.random.RandomState(0)
    return {
        "G": {"params": {"conv": {"kernel": rng.rand(3, 3, 2, 4)
                                  .astype(np.float32),
                                  "bias": np.zeros(4, np.float32)},
                         "gamma": np.array(0.5, np.float32)},
              "batch_stats": {"bn": {"mean": rng.rand(4),
                                     "var": np.ones(4, np.float32)}}},
        "epoch": 3, "fid": None, "ok": True, "no": False, "x": -2.25,
        "cfg": [[4, 200, 70000, 2 ** 33], [np.int64(7), np.array(9)]],
        "ints": [-1, -33, -200, -40000, -2 ** 40, 127, 128],
        "name": "é" * 40, "long": "a" * 300, "blob": b"\x00\xff" * 200,
        "flags": np.array([True, False]), "u8": np.arange(300, dtype=np.uint8),
        "scalar": np.float64(1.5), "many": {f"k{i}": i for i in range(20)},
    }


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and np.array_equal(a, b))
    return type(a) is type(b) and a == b


def test_codec_writes_and_reads_flax_bytes():
    tree = _tree()
    ours = msgpack_lite.packb(tree)
    assert ours == serialization.msgpack_serialize(dict(tree))
    assert _equal(msgpack_lite.restore(ours),
                  serialization.msgpack_restore(ours))


def test_codec_reads_chunked_arrays(monkeypatch):
    """flax's chunked maps (arrays over its chunk size) read back as
    arrays; the writer refuses such an array rather than write another
    layout."""
    from flax import serialization as ser
    monkeypatch.setattr(ser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack_lite, "MAX_CHUNK_SIZE", 64)
    tree = {"w": np.arange(50, dtype=np.float32).reshape(5, 10),
            "b": np.ones(3, np.float32)}
    assert _equal(msgpack_lite.restore(ser.msgpack_serialize(dict(tree))),
                  tree)
    with pytest.raises(ValueError, match="chunk"):
        msgpack_lite.packb(tree)


def test_checkpoints_cross_read(tmp_path):
    payload = {"G": _tree()["G"], "D": None, "epoch": 2,
               "cfg": ([4, 6, 14], None), "fid": None}
    j_path, t_path = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    jckpt.save_checkpoint(j_path, payload)
    ckpt.save_checkpoint(t_path, payload)
    assert open(j_path, "rb").read() == open(t_path, "rb").read()
    ours, theirs = ckpt.load_checkpoint(j_path), jckpt.load_checkpoint(t_path)
    assert _equal(ours, theirs)
    assert ours["fid"] is None and ours["cfg"] == [[4, 6, 14], None]
    assert ckpt.restore_cfg(ours) == ([4, 6, 14], None)
    # a cfg of 0-d arrays and numpy ints, as JAX may write it
    jckpt.save_checkpoint(j_path, {"cfg": ([np.array(3), np.int32(5)],
                                           np.array([7, 8]))})
    assert ckpt.restore_cfg(ckpt.load_checkpoint(j_path)) == ([3, 5], [7, 8])


@pytest.mark.parametrize("damage", ["empty", "torn", "newer", "garbage"])
def test_bad_files_raise_checkpoint_error(tmp_path, damage):
    path = str(tmp_path / "m.ckpt")
    ckpt.save_checkpoint(path, {"G": _tree()["G"], "epoch": 1})
    raw = open(path, "rb").read()
    if damage == "empty":
        raw = b""
    elif damage == "torn":
        raw = raw[:len(raw) // 2]
    elif damage == "garbage":
        raw = b"\xc1" + raw
    else:
        raw = serialization.msgpack_serialize(
            {"epoch": 1, "__gcc_tpu_schema__": ckpt.SCHEMA_VERSION + 1})
    with open(path, "wb") as f:
        f.write(raw)
    with pytest.raises(ckpt.CheckpointError):
        ckpt.load_checkpoint(path)
    with pytest.raises(ckpt.CheckpointError, match="not found"):
        ckpt.load_checkpoint(str(tmp_path / "missing.ckpt"))


def _batches(n, shape_a, shape_b, seed, keys=("A", "B")):
    rng = np.random.RandomState(seed)
    return [{keys[0]: torch.from_numpy(rng.randn(*shape_a).astype(np.float32)),
             keys[1]: torch.from_numpy(np.tanh(rng.randn(*shape_b))
                                       .astype(np.float32))}
            for _ in range(n)]


def _engine(kind):
    if kind == "unet":
        cfg = Config(model="pix2pix", ngf=4, ndf=4, teacher_ngf=8,
                     teacher_ndf=8, num_downs=5, crop_size=32,
                     online_distillation=True, darts_discriminator=True,
                     lambda_L1=100.0, lambda_content=50.0, lambda_gram=1e4)
        return Pix2PixEngine(cfg, device="cpu"), \
            _batches(4, (2, 3, 32, 32), (2, 3, 32, 32), 0)
    if kind == "cyclegan":
        # a pool of 3 fills in the first iteration and swaps in the second
        cfg = Config(model="cyclegan", ngf=4, ndf=4, teacher_ngf=4,
                     teacher_ndf=4, crop_size=24, pool_size=3,
                     online_distillation=True, darts_discriminator=True,
                     lambda_content=0.01, lambda_gram=10.0)
        return CycleGANEngine(cfg, device="cpu"), \
            _batches(4, (2, 3, 24, 24), (2, 3, 24, 24), 2)
    if kind == "srgan":
        cfg = Config(model="srgan", ngf=4, ndf=4, teacher_ngf=4,
                     teacher_ndf=4, image_size=16, gan_mode="vanilla",
                     online_distillation=True, darts_discriminator=True,
                     lambda_content=1.0, lambda_gram=1.0)
        return SRGANEngine(cfg, device="cpu"), \
            _batches(4, (2, 3, 4, 4), (2, 3, 16, 16), 3, keys=("lr", "hr"))
    cfg = Config(model="sagan", ngf=4, ndf=4, teacher_ngf=4, teacher_ndf=4,
                 crop_size=64, z_dim=8, online_distillation=True,
                 darts_discriminator=True, lambda_content=1.0,
                 lambda_gram=1.0, lambda_L1=1.0)
    return SAGANEngine(cfg, device="cpu"), \
        _batches(4, (2, 8), (2, 3, 64, 64), 1, keys=("z", "real_img"))


def _step(engine, state, batches):
    return engine.train_arch_step(state, batches[0], batches[1], 2e-4, 0.9)


@pytest.mark.parametrize("kind", ["unet", "sagan", "cyclegan", "srgan"])
def test_save_state_round_trip(tmp_path, kind):
    engine, batches = _engine(kind)
    state = engine.init_state(seed=0)
    state, _ = _step(engine, state, batches[:2])
    path = str(tmp_path / "train_state.ckpt")
    ckpt.save_state(path, state)
    saved = state.state_dict()
    restored = ckpt.load_state(path, engine.init_state(seed=9))
    assert _equal(restored.state_dict(), saved)
    # the next iteration from the restored state is the saved run's
    state, m = _step(engine, state, batches[2:])
    restored, m2 = _step(engine, restored, batches[2:])
    assert all(torch.equal(m[k], m2[k]) for k in m)
    assert _equal(restored.state_dict(), state.state_dict())
    with pytest.raises(ckpt.CheckpointError, match="not a full-state"):
        model = str(tmp_path / "model.ckpt")
        ckpt.save_checkpoint(model, engine.checkpoint_payload(state, 1))
        ckpt.load_state(model, state)
