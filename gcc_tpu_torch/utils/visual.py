"""Debug and observability utilities (port of gcc_tpu/utils/visual.py).

  * plot_weight_distribution: histograms of the per-out-channel L1 norms of
    a generator's conv weights, for choosing prune thresholds
    (utils/plot_weight_distribute.py:11-37);
  * diagnose_network: the mean absolute value over a net's tensors
    (utils/util.py:134-150);
  * HTMLGallery: a static HTML result browser in place of the reference's
    dominate-based one (utils/html.py:6-86), its PNGs written by the port's
    own writer (utils/image.py), not Pillow.
"""

from __future__ import annotations

import html
import os
from typing import Dict, List

import numpy as np
import torch
import torch.nn as nn

from gcc_tpu_torch.compress.prune import l1_out
from gcc_tpu_torch.utils.image import png_bytes, tensor2im
from gcc_tpu_torch.utils.weights import export_jax_variables


def plot_weight_distribution(net_or_variables, out_dir: str,
                             bins: int = 100) -> List[str]:
    """One histogram PNG of per-out-channel L1 norms for every 4-D conv
    kernel, named by its path in the JAX layout (``down_0_kernel.png``);
    returns the paths written. ``net_or_variables``: a generator module,
    or a checkpoint's net (its ``{"params": ...}`` variables, the JAX
    layout), or its params tree. Transposed convs count their out channels
    as the JAX kernel's last axis does. matplotlib is imported here, where
    it is used."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    written = []
    for name, norms in weight_norms(net_or_variables).items():
        fig, ax = plt.subplots(figsize=(4, 3))
        ax.hist(norms, bins=min(bins, max(10, len(norms) // 2)))
        ax.set_title(name, fontsize=8)
        ax.set_xlabel("per-filter L1 norm")
        fname = os.path.join(out_dir, name.replace("/", "_") + ".png")
        fig.tight_layout()
        fig.savefig(fname, dpi=80)
        plt.close(fig)
        written.append(fname)
    return written


def weight_norms(net_or_variables) -> Dict[str, np.ndarray]:
    """{JAX path of a 4-D conv kernel ('down_0/kernel'): its per-out-channel
    L1 norms}, keys sorted at every level (flax's order of the JAX
    package's trees); ``plot_weight_distribution``'s argument."""
    if isinstance(net_or_variables, nn.Module):
        tree = export_jax_variables(net_or_variables)["params"]
    else:
        tree = net_or_variables.get("params", net_or_variables)
    out = {}

    def walk(node, prefix=""):
        for k in sorted(node):
            v, name = node[k], f"{prefix}{k}"
            if isinstance(v, dict):
                walk(v, name + "/")
            elif k == "kernel" and np.ndim(v) == 4:
                out[name] = l1_out(v)

    walk(tree)
    return out


def _leaves(x):
    """The tensors and arrays of a module (its parameters, in order), a
    dict (sorted keys, as jax's tree leaves), a list or a tuple; None is
    no leaf."""
    if isinstance(x, nn.Module):
        yield from (p.detach() for p in x.parameters())
    elif isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k])
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    elif x is not None:
        yield x


def diagnose_network(grads_or_params, name: str = "network") -> float:
    """Mean over the leaves of each leaf's mean absolute value (printed)."""
    means = []
    for leaf in _leaves(grads_or_params):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        means.append(np.abs(np.asarray(leaf)).mean())
    mean = float(np.mean(means)) if means else 0.0
    print(f"{name}: mean abs = {mean:.6f}")
    return mean


class HTMLGallery:
    """A static HTML image gallery, one row per sample."""

    def __init__(self, web_dir: str, title: str = "results"):
        self.web_dir = web_dir
        self.img_dir = os.path.join(web_dir, "images")
        self.title = title
        self.rows: List = []
        os.makedirs(self.img_dir, exist_ok=True)

    def add_images(self, images: Dict[str, np.ndarray], name: str,
                   width: int = 256) -> None:
        """One row: each [-1, 1] image (HWC or NHWC, the first) written as
        <name>_<label>.png."""
        cells = []
        for label, arr in images.items():
            fname = f"{name}_{label}.png"
            with open(os.path.join(self.img_dir, fname), "wb") as f:
                f.write(png_bytes(tensor2im(arr)))
            cells.append((label, fname, width))
        self.rows.append((name, cells))

    def save(self) -> str:
        """Write index.html; returns its path."""
        parts = [f"<html><head><title>{html.escape(self.title)}</title>"
                 "</head><body>"]
        for name, cells in self.rows:
            parts.append(f"<h3>{html.escape(name)}</h3><table><tr>")
            for label, fname, width in cells:
                parts.append(
                    f"<td style='text-align:center'>"
                    f"<img src='images/{fname}' width='{width}'/><br>"
                    f"{html.escape(label)}</td>")
            parts.append("</tr></table>")
        parts.append("</body></html>")
        path = os.path.join(self.web_dir, "index.html")
        with open(path, "w") as f:
            f.write("".join(parts))
        return path
