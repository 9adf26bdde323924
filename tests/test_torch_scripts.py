"""The port's three-stage scripts, ``scripts/torch/<family>/*.sh``, against
the JAX package's ``scripts/<family>/*.sh``: each runs the same ``cli.<x>``
module under ``gcc_tpu_torch``, and its flags give the port's ``Config``
every value that the JAX script's flags give ``gcc_tpu``'s, ``gpu_ids``
aside (a field only the port has). A flag that either package renames, or
that one script drops, fails here. Nothing is trained or read."""

import dataclasses
import os
import shlex
from pathlib import Path

import pytest

from gcc_tpu.config import parse as jparse
from gcc_tpu_torch.config import parse as tparse

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ("pix2pix", "cyclegan", "sagan", "srgan")
STAGES = ("pretrain_for_pruning", "train", "test")


def _command(path: Path):
    """The script's one command as (module, flags)."""
    text = path.read_text()
    assert text.startswith("#!/usr/bin/env bash\n"), path
    words = shlex.split(text.replace("\\\n", " "), comments=True)
    assert words[:2] == ["python", "-m"], words[:3]
    return words[2], words[3:]


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("family", FAMILIES)
def test_script_matches_jax(family, stage):
    jmod, jflags = _command(ROOT / "scripts" / family / f"{stage}.sh")
    tpath = ROOT / "scripts" / "torch" / family / f"{stage}.sh"
    tmod, tflags = _command(tpath)
    assert os.access(tpath, os.X_OK), tpath
    assert jmod.startswith("gcc_tpu.cli."), jmod
    assert tmod == "gcc_tpu_torch." + jmod[len("gcc_tpu."):]
    assert tmod.endswith(".train" if stage != "test" else ".test")
    jcfg = dataclasses.asdict(jparse(jflags))
    tcfg = dataclasses.asdict(tparse(tflags))
    assert tcfg.pop("gpu_ids") == "0"
    assert set(tcfg) == set(jcfg)
    assert tcfg == jcfg
