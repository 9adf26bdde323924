"""The numbers that decide ``correct``, each held to its limit.

Training, over the first iterations that set-up drives through the
window's own call (the mix's ``check_steps``):
  loss_gap      the widest gap of a loss, |program - reference|, over those
                iterations and every loss the step reports, against
                the larger of that loss's reference value and the median
                of the iteration's reference losses;
  loss1_gap     the same over the first iteration alone;
  grad_gap      the widest gap between the norms of a leaf's first
                gradient (the program's from its Adam's first moments,
                m / (1 - b1)), |norm_p - norm_r|, against the larger of the
                leaf's reference norm and the median over its optimizer's
                leaves;
  grad_median   the median leaf's gap of the same;
  change_gap    the widest such gap of the norm of each parameter's change
                over those iterations;
  change_median the median leaf's gap of the same;
  pool_gap      where the configuration has replay pools, the widest
                rms(program - reference) / rms(reference) of a pool slot
                after those iterations (a slot filled on one side only
                reads 1 or more);
  pool_slots    the pool slots, over every pool, whose program image is
                not nearest to the image the reference holds there among
                all the images the reference's pool was offered, or that
                are filled on one side only: whether each slot holds the
                image that the pools' semantics put there (exact: 0).
The leaf numbers leave out the leaves whose reference first gradient is
under a thousandth of their optimizer's median leaf (a bias before a
normalisation: zero but for rounding, moved by round-off alone).
Serving, over a sample of the window's requests drawn from the seed:
  image_gap     the widest rms(served - reference) / rms(reference) of an
                image.
A cell's limits file names the numbers it compares; a number that is not
finite fails its limit.
"""

from __future__ import annotations

import math
from statistics import median
from typing import Dict, Iterable, List, Tuple

import torch

Leaf = Tuple[str, str]


def _gap(p: float, r: float, scale: float) -> float:
    return abs(p - r) / max(abs(r), scale, 1e-30)


def loss_gap(prog: List[Dict[str, float]], ref: List[Dict[str, float]]
             ) -> float:
    worst = 0.0
    for p, r in zip(prog, ref):
        if set(p) != set(r):
            return math.inf
        scale = median(abs(v) for v in r.values())
        for k in r:
            worst = max(worst, _gap(p[k], r[k], scale))
    return worst if len(prog) == len(ref) else math.inf


def leaf_gaps(prog: Dict[str, Dict[Leaf, float]],
              ref: Dict[str, Dict[Leaf, float]],
              keep: Dict[str, Iterable[Leaf]] = None) -> List[float]:
    """Every leaf's gap over every optimizer's leaves (or ``keep``); one
    infinite gap where the program's leaves are not the reference's."""
    gaps = []
    for opt, r in ref.items():
        p = prog.get(opt, {})
        if set(p) != set(r):
            return [math.inf]
        scale = median(r.values()) if r else 0.0
        gaps += [_gap(p[leaf], r[leaf], scale)
                 for leaf in (r if keep is None else keep[opt])]
    return gaps


def leaf_gap(prog, ref, keep=None) -> float:
    """The widest leaf gap."""
    return max(leaf_gaps(prog, ref, keep), default=0.0)


def leaf_median(prog, ref, keep=None) -> float:
    """The median leaf's gap."""
    gaps = leaf_gaps(prog, ref, keep)
    return math.inf if math.inf in gaps else median(gaps)


def moved_leaves(ref_grads: Dict[str, Dict[Leaf, float]]):
    """Each optimizer's leaves whose reference first gradient is at least
    a thousandth of its median leaf's."""
    out = {}
    for opt, r in ref_grads.items():
        floor = 1e-3 * median(r.values()) if r else 0.0
        out[opt] = [leaf for leaf, v in r.items() if v >= floor]
    return out


def pool_gap(prog: Dict[str, dict], ref: Dict[str, dict]) -> float:
    """The widest rms gap of a pool slot, over every pool."""
    if set(prog) != set(ref):
        return math.inf
    worst = 0.0
    for k, r in ref.items():
        p, r = prog[k]["slots"].float(), r["slots"].float()
        if p.shape != r.shape:
            return math.inf
        d = (p - r).flatten(1).square().mean(1).sqrt()
        s = r.flatten(1).square().mean(1).sqrt()
        worst = max(worst, float((d / s.clamp_min(1e-30)).max()))
    return worst


def pool_slots(prog: Dict[str, dict], ref: Dict[str, dict]) -> float:
    """The slots that do not hold the image the reference's pool holds
    there (the nearest of every image it was offered), over every pool."""
    if set(prog) != set(ref):
        return math.inf
    wrong = 0
    for k, r in ref.items():
        p = prog[k]["slots"].float().flatten(1)
        if p.shape[0] != len(r["ids"]):
            return math.inf
        filled = p.abs().amax(1) > 0
        ids = torch.tensor(r["ids"], device=p.device)
        seen = r["seen"].float().flatten(1)
        near = torch.cdist(p, seen).argmin(1) if seen.shape[0] else ids
        wrong += int(((ids < 0) & filled).sum())
        wrong += int(((ids >= 0) & (~filled | (near != ids))).sum())
    return float(wrong)


def image_gap(served: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest per-image rms(served - ref) / rms(ref)."""
    d = (served.float() - ref.float()).flatten(1)
    r = ref.float().flatten(1)
    rel = d.square().mean(1).sqrt() / r.square().mean(1).sqrt().clamp_min(
        1e-30)
    return float(rel.max())


def judge(values: Dict[str, float], limits: Dict[str, dict]) -> bool:
    """Every limit's number is there, finite and within it."""
    return all(k in values and math.isfinite(values[k])
               and values[k] <= lim["limit"] for k, lim in limits.items())


def lines(values: Dict[str, float], limits: Dict[str, dict]) -> List[str]:
    return [f"check {k} {values.get(k, math.nan)!r} limit "
            f"{limits[k]['limit']!r}" for k in limits]


def block(values: Dict[str, float], limits: Dict[str, dict]) -> dict:
    """The result line's last key: each number beside its limit."""
    return {k: {"value": values.get(k, math.nan), "limit": lim["limit"]}
            for k, lim in limits.items()}
