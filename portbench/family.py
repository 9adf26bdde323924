"""How the harness drives a GCC family of the program (gcc_tpu_torch):
its Config from the configuration file's flags, its engine, the nets the
serving cells export, and which optimizer holds which parameters (the
engine's groups, in the program's own parameter order). The program is
imported inside these functions, never when the module is imported.

A configuration file names its family (``"family": "cyclegan"``); the
family is the module ``portbench/families/<family>.py``, which binds
``FAMILY`` to an instance of a ``Family`` subclass with the plain
reference beside it. A new family is a new file there.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

import torch


class Family:
    reference = None
    serve_nets: Tuple[str, ...] = ()
    pool_names: Tuple[str, ...] = ()
    """The program's replay pools (nets with ``buffer`` and ``count``),
    named as the reference's ``Iteration.pools``."""

    def flags(self, cfgj: dict, batch: int, size: int) -> List[str]:
        """The configuration's flags, then one flag a hyperparameter (a
        later flag wins) and the cell's batch and image size."""
        out = list(cfgj["flags"])
        for k, v in cfgj["hyper"].items():
            if k == "dropout":
                out += [] if v else ["--no_dropout"]
            elif isinstance(v, bool):
                out += [f"--{k}"] if v else []
            else:
                out += [f"--{k}", str(v)]
        return out + ["--batch_size", str(batch), "--crop_size", str(size),
                      "--load_size", str(size),
                      "--compute_dtype", cfgj["compute_dtype"]]

    def config(self, cfgj: dict, batch: int, size: int):
        """The program's Config, parsed from the flags as its CLI parses
        them; raises where it departs from what the file states."""
        from gcc_tpu_torch.config import parse
        cfg = parse(self.flags(cfgj, batch, size))
        want = dict(cfgj["hyper"], **cfgj.get("expect", {}))
        for k, v in want.items():
            have = (not cfg.no_dropout) if k == "dropout" else getattr(cfg, k)
            if have != v:
                raise RuntimeError(f"the program's {k} is {have!r}, the "
                                   f"configuration states {v!r}")
        return cfg

    def program_leaves(self, nets: Dict[str, torch.nn.Module]):
        """Each optimizer's (net, name) leaves in the program's order."""
        named = {k: dict(m.named_parameters()) for k, m in nets.items()}
        return self.reference.optimizer_leaves(named)

    def b2_calls(self, cfgj: dict, batch: int, size: int):
        return None


def load(name: str) -> Family:
    """The family of ``portbench/families/<name>.py``."""
    return importlib.import_module(f"portbench.families.{name}").FAMILY
