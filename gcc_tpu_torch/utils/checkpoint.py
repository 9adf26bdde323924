"""Checkpoints: nets + epoch + cfg + metric in one msgpack file (port of
gcc_tpu/utils/checkpoint.py:24-142).

The JAX package's contract (models/Pix2Pix.py:636-658): a mapping with the
network entries ('G', 'D'), 'epoch', 'cfg' = (filter_cfgs, channel_cfgs)
and the best-metric value, so eval rebuilds the pruned topology from the
checkpoint alone (test.py:140-151). The nets are stored in the JAX layout
(``utils/weights.export_jax_variables``) and the file is the bytes flax
writes (``utils/msgpack_lite``), so a ``model_*.ckpt`` written by either
package loads in the other. The full train state for ``--continue_train``
(``save_state``) is the port's own payload in the same container.

Filenames follow the reference: model_<epoch>.ckpt / model_best_<dir>.ckpt.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from gcc_tpu_torch.utils import msgpack_lite

# Bumped whenever the on-disk layout changes incompatibly; files without the
# marker load as version 0 (the same layout). The JAX package's number.
SCHEMA_VERSION = 1
_SCHEMA_KEY = "__gcc_tpu_schema__"


class CheckpointError(RuntimeError):
    """Actionable checkpoint failure (corrupt/truncated/version-mismatched)."""


def _to_numpy(tree):
    """numpy-ify leaves; tuples become lists (msgpack has no tuple type)."""
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if tree is None or isinstance(tree, (int, float, str, bool, bytes)):
        return tree
    return np.asarray(tree)


def save_checkpoint(path: str, payload: dict) -> None:
    """Atomic, versioned save: write to a temp file, fsync, then rename, so
    a kill mid-write leaves the old file or none, never a torn one under
    the final name (the preemption handler in cli/train.py relies on it)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    body = dict(_to_numpy(payload))
    body[_SCHEMA_KEY] = SCHEMA_VERSION
    data = msgpack_lite.packb(body)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict:
    """Load + validate. Raises CheckpointError on missing, empty, truncated
    or corrupt files and on a schema newer than this build understands."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except FileNotFoundError:
        raise CheckpointError(f"checkpoint not found: {path}") from None
    if not raw:
        raise CheckpointError(
            f"checkpoint {path} is empty (0 bytes) — likely a torn write from "
            "an interrupted save; fall back to the previous epoch's checkpoint.")
    try:
        ckpt = msgpack_lite.restore(raw)
    except (ValueError, TypeError, UnicodeDecodeError) as e:
        raise CheckpointError(
            f"checkpoint {path} is corrupt or truncated "
            f"({type(e).__name__}: {e}). If this was written during a "
            f"preemption/crash, use the previous epoch's model_<N>.ckpt "
            f"instead.") from e
    if not isinstance(ckpt, dict):
        raise CheckpointError(
            f"checkpoint {path} does not contain a mapping "
            f"(got {type(ckpt).__name__}) — not a GCC-TPU checkpoint.")
    version = ckpt.pop(_SCHEMA_KEY, 0)
    if version > SCHEMA_VERSION:
        raise CheckpointError(
            f"checkpoint {path} has schema version {version}, but this build "
            f"only understands <= {SCHEMA_VERSION}; upgrade gcc_tpu_torch.")
    return ckpt


def ckpt_name(save_dir: str, epoch: Optional[int] = None,
              isbest: bool = False, direction: str = "AtoB") -> str:
    if isbest:
        return os.path.join(save_dir, f"model_best_{direction}.ckpt")
    return os.path.join(save_dir, f"model_{epoch}.ckpt")


def save_state(path: str, state) -> None:
    """The full training state (``GANState.state_dict``: nets, every Adam
    moment and step, EMA, step, dropout generator) for true resume."""
    save_checkpoint(path, {"state": state.state_dict()})


def load_state(path: str, state):
    """Restore a full state saved by ``save_state`` into ``state`` (built by
    the same engine), in place; returns it."""
    payload = load_checkpoint(path)
    if "state" not in payload:
        raise CheckpointError(
            f"{path} is a model checkpoint (G/D/cfg), not a full-state "
            f"resume checkpoint (train_state.ckpt).")
    state.load_state_dict(payload["state"])
    return state


def combine_best_models(best_AtoB: dict, best_BtoA: dict) -> dict:
    """CycleGAN per-direction best merge (utils/util.py:305-332): G_A/D_A
    from the best-AtoB checkpoint, G_B/D_B from the best-BtoA one."""
    out = dict(best_AtoB)
    out["G_B"] = best_BtoA["G_B"]
    out["D_B"] = best_BtoA["D_B"]
    return out


def restore_cfg(ckpt: dict):
    """cfg tuple from a checkpoint; lists of ints, whatever the writer stored
    (lists, tuples, 0-d arrays or numpy ints)."""
    cfg = ckpt.get("cfg")
    if cfg is None:
        return (None, None)
    a, b = cfg
    to_list = lambda v: None if v is None else [int(x) for x in v]
    return (to_list(a), to_list(b))
