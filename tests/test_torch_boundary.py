"""The port's boundaries: it imports nothing of JAX or the JAX package, its
entry points refuse to fall back to the CPU silently, and chip_smoke.py
fails where there is no card or no repository around it."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from gcc_tpu_torch.config import Config  # noqa: E402
from gcc_tpu_torch.engines.pix2pix import Pix2PixEngine  # noqa: E402
from gcc_tpu_torch.engines.sagan import SAGANEngine  # noqa: E402
from torch_limits import child_env, one_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "gcc_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gcc_tpu", "msgpack")
# imported only inside the function that decodes an image file
LAZY = {"PIL": ("gcc_tpu_torch/data/datasets.py", "read_rgb")}


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_statement(path):
    """Every import statement, at any depth of any function, of the port's
    modules and of chip_smoke.py."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not any(_forbidden(n) for n in names), \
            f"{path.name}:{node.lineno} imports {names}"


def test_importing_the_port_loads_no_jax():
    """A fresh interpreter imports every gcc_tpu_torch module and chip_smoke
    with jax, flax, optax and gcc_tpu made unimportable; none is loaded."""
    code = textwrap.dedent(f"""
        import importlib, importlib.abc, pkgutil, sys
        FORBIDDEN = {FORBIDDEN + tuple(LAZY)!r}
        for name in list(sys.modules):
            if name.split(".")[0] in FORBIDDEN:
                del sys.modules[name]

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in FORBIDDEN:
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, Block())
        import gcc_tpu_torch
        mods = [m.name for m in pkgutil.walk_packages(
            gcc_tpu_torch.__path__, "gcc_tpu_torch.")]
        for m in mods + ["chip_smoke"]:
            importlib.import_module(m)
        bad = [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]
        assert not bad, bad
        print(len(mods))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=child_env(PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 12


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_lazy_imports_only_where_used(path):
    """Pillow is imported by the function that decodes an image file and
    nowhere else: the port runs where Pillow is missing."""
    rel = str(path.relative_to(ROOT))

    def walk(node, func):
        for child in ast.iter_child_nodes(node):
            name = child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func
            if isinstance(child, ast.Import):
                mods = [a.name for a in child.names]
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                mods = [child.module]
            else:
                mods = []
            for m in mods:
                top = m.split(".")[0]
                assert top not in LAZY or LAZY[top] == (rel, func), \
                    f"{rel}:{child.lineno} imports {m} in {func}"
            walk(child, name)

    walk(ast.parse(path.read_text()), None)


def test_engine_without_device_needs_cuda():
    cfg = Config(backbone="resnet", online_distillation=True,
                 darts_discriminator=True)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Pix2PixEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Pix2PixEngine(cfg, device="cuda")
    assert Pix2PixEngine(cfg, device="cpu").device.type == "cpu"


def test_sagan_engine_without_device_needs_cuda():
    cfg = Config(model="sagan", crop_size=64, online_distillation=True,
                 darts_discriminator=True)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SAGANEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        SAGANEngine(cfg, device="cuda")
    assert SAGANEngine(cfg, device="cpu").device.type == "cpu"
    normal = SAGANEngine(cfg.replace(online_distillation=False,
                                     normal_distillation=True), device="cpu")
    assert normal.distill and not normal.online


def test_export_cli_device_from_run_device(tmp_path, monkeypatch):
    """cli.export takes its device from cli.train's run_device, as the
    other entry points do: --gpu_ids 0 without a card raises (no silent
    CPU path), and the device it traces on is run_device's."""
    from gcc_tpu_torch.cli import export, train
    argv = ["--platforms", "cpu", "--model", "pix2pix", "--dataroot",
            str(tmp_path), "--checkpoints_dir", str(tmp_path), "--name", "e"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            export.main(argv + ["--gpu_ids", "0"])
    seen = []

    def spy(cfg, device=None):
        seen.append(cfg.gpu_ids)
        raise KeyboardInterrupt  # stop before the checkpoint is read
    monkeypatch.setattr(train, "run_device", spy)
    with pytest.raises(KeyboardInterrupt):
        export.main(argv + ["--gpu_ids", "-1"])
    assert seen == ["-1"]


def test_unet_backbone_not_in_this_slice():
    """The U-Net backbone (the default) came with a later slice: the engine
    builds it on the CPU, student and teacher."""
    eng = Pix2PixEngine(Config(backbone="unet", online_distillation=True),
                        device="cpu")
    nets = eng.build_nets()
    assert type(nets["g"]).__name__ == type(nets["tg"]).__name__ == \
        "UnetGenerator"


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_card_or_repo(tmp_path, where):
    """Without a card (here), and in a directory holding chip_smoke.py and
    nothing else of the repository, the script exits non-zero and prints no
    result."""
    if where == "repo":
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        cwd = ROOT
    else:
        (tmp_path / "chip_smoke.py").write_text(
            (ROOT / "chip_smoke.py").read_text())
        cwd = tmp_path
    env = {k: v for k, v in child_env().items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
