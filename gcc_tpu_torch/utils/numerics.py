"""Post-step numerics check (--check_numerics; port of
gcc_tpu/utils/numerics.py).

Checks the named-loss dict an engine's step returns: one host sync per
iteration, and an abort that names every non-finite loss, so the user knows
which term (G gan loss, distill, D real/fake, arch...) diverged and when.
``--debug_nans`` (autograd anomaly mode) localizes the operation instead, at
a much higher cost.
"""

from __future__ import annotations

import numpy as np
import torch


def assert_finite_losses(losses, *, epoch=None, iters=None):
    """Raise FloatingPointError naming every non-finite loss in the dict.

    ``losses`` maps names to torch scalars or small tensors on any device
    (or numbers). Returns the dict unchanged when everything is finite.
    """
    host = {k: (v.detach().float().cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v)) for k, v in losses.items()}
    bad = {}
    for name, a in host.items():
        if not np.all(np.isfinite(a)):
            flat = a.ravel()
            bad[name] = float(flat[0]) if flat.size == 1 else \
                f"{int(np.sum(~np.isfinite(a)))}/{a.size} non-finite"
    if bad:
        where = ""
        if epoch is not None:
            where = f" at epoch {epoch}" + (
                f", iters {iters}" if iters is not None else "")
        names = ", ".join(f"{k}={v}" for k, v in sorted(bad.items()))
        raise FloatingPointError(
            f"--check_numerics: non-finite loss{where}: {names}. The train "
            f"state after this step is poisoned; restart from the last "
            f"checkpoint with a lower --lr / different --gan_mode, or rerun "
            f"with --debug_nans to localize the operation that produced it.")
    return losses
