"""The two kinds of cell the traffic files name (``"entry"``): ``train``
drives the program's cooperative iteration (``engine.train_arch_step``),
``serve`` its exported student (``utils/serve_export.export_generator``).
Each builds what its window runs from the run's seed, and holds what the
reference needs afterwards: the seed-made weights, the input ring and the
program's readings of the first iterations.
"""

from __future__ import annotations

import types
from typing import Dict, List

import torch

from portbench import weights as W
from portbench.reference import precision


def _dtype(cfg) -> torch.dtype:
    from gcc_tpu_torch.device import compute_dtype
    return compute_dtype(cfg)


class TrainCell:
    """The program's training state, built once; set-up drives its first
    ``check_steps`` iterations through ``step``, the window the rest."""

    def __init__(self, fam, cfgj: dict, traffic: dict, seed: int, device):
        self.fam, self.cfgj, self.seed = fam, cfgj, seed
        self.device = torch.device(device)
        self.batch, self.size = traffic["batch"], cfgj["image_size"]
        self.cfg = fam.config(cfgj, self.batch, self.size)
        self.engine = fam.engine(self.cfg, cfgj, self.device)
        nets = {k: v.to(self.device).train()
                for k, v in self.engine.build_nets().items()}
        self.weights = W.make(fam.reference.specs(cfgj), seed, self.device)
        W.load(nets, self.weights)
        self.state = self.engine.state_for(nets, seed)
        n = traffic["ring"]
        self.ring = W.ring(4 * n, (self.batch, 3, self.size, self.size), seed,
                           self.device, _dtype(self.cfg)).view(
            n, 4, self.batch, 3, self.size, self.size)
        self.lr, self.ema_beta = self.cfg.lr, self.cfg.ema_beta
        self.arch_lr = self.cfg.arch_lr

    def step(self, i: int) -> Dict[str, torch.Tensor]:
        """Iteration i: train batch i of the ring, its validation batch."""
        r = self.ring[i % self.ring.shape[0]]
        self.state, m = self.engine.train_arch_step(
            self.state, {"A": r[0], "B": r[1]}, {"A": r[2], "B": r[3]},
            self.lr, self.ema_beta, self.arch_lr)
        return m

    def first_steps(self, n: int) -> dict:
        """Iterations 0..n-1 with the readings the reference is held to:
        each iteration's losses, each leaf's first gradient (from the
        first moments after one step), its change after n, and the
        replay pools' images after n."""
        rec = {"losses": []}
        for i in range(n):
            rec["losses"].append(self.step(i))
            if i == 0:
                rec["grads"] = self._first_grads()
        rec["change"] = self._change()
        rec["pools"] = {k: {"slots": self.state.nets[k].buffer.detach()
                            .float().clone()} for k in self.fam.pool_names}
        return rec

    def _first_grads(self):
        out = {}
        for opt, leaves in self.fam.program_leaves(self.state.nets).items():
            mu = self.state.opts[opt].mu
            if len(mu) != len(leaves):
                raise RuntimeError(f"optimizer {opt}: {len(mu)} moments for "
                                   f"{len(leaves)} leaves")
            b1 = self.fam.reference.ARCH_BETA1 if opt == "arch" \
                else self.fam.reference.BETA1
            out[opt] = (leaves, torch.stack([m.float().norm() for m in mu])
                        / (1.0 - b1))
        return out

    def _change(self):
        named = {k: dict(m.named_parameters())
                 for k, m in self.state.nets.items()}
        return {opt: (leaves, torch.stack(
            [(named[n][k].detach().float() - self.weights[n][k]).norm()
             for n, k in leaves]))
            for opt, leaves in self.fam.program_leaves(
                self.state.nets).items()}

    def free(self) -> None:
        """Drop the program's state (the reference runs after it)."""
        self.state = self.engine = None

    def reference(self, prec, n: int) -> dict:
        """The plain reference's readings over the same n iterations, from
        the same weights and inputs, in ``prec``."""
        it = self.fam.reference.Iteration(self.cfgj, self.weights, self.seed,
                                          prec, self.device)
        rec = {"losses": []}
        for i in range(n):
            r = self.ring[i].float()
            rec["losses"].append(it(r[0], r[1], r[2], r[3], self.lr,
                                    self.ema_beta, self.arch_lr))
        rec["grads"] = {opt: (o.leaves, o.first_grad_norms)
                        for opt, o in it.opts.items()}
        rec["change"] = {opt: (o.leaves, torch.stack(
            [(it.nets[net][k].detach() - self.weights[net][k]).norm()
             for net, k in o.leaves])) for opt, o in it.opts.items()}
        rec["pools"] = {k: it.pools[k].record((3, self.size, self.size),
                                              self.device)
                        for k in self.fam.pool_names}
        return rec


def to_host(rec: dict) -> dict:
    """A readings record as Python floats: losses a list of dicts, grads
    and change {optimizer: {(net, name): norm}}; the pools' images stay
    on the device."""
    return {"losses": [{k: float(v) for k, v in m.items()}
                       for m in rec["losses"]],
            "pools": rec["pools"],
            **{key: {opt: dict(zip(leaves, norms.tolist()))
                     for opt, (leaves, norms) in rec[key].items()}
               for key in ("grads", "change")}}


class ServeCell:
    """The pruned student exported as the program ships it (bf16 by the
    configuration's compute dtype, a symbolic batch), held in memory."""

    def __init__(self, fam, cfgj: dict, traffic: dict, seed: int, device,
                 weight_quant=None):
        from gcc_tpu_torch.utils.serve_export import export_generator
        self.fam, self.cfgj = fam, cfgj
        self.device = torch.device(device)
        self.batch, self.size = traffic["batch"], cfgj["image_size"]
        cfg = fam.config(cfgj, self.batch, self.size)
        engine = fam.engine(cfg, cfgj, self.device)
        built = engine.build_nets()
        nets = {k: built[k].to(self.device) for k in fam.serve_nets}
        specs = fam.reference.specs(cfgj)
        self.weights = W.make({k: specs[k] for k in fam.serve_nets}, seed,
                              self.device)
        W.load(nets, self.weights)
        dtype = _dtype(cfg)
        ep = export_generator(engine, types.SimpleNamespace(nets=nets),
                              (1, 3, self.size, self.size), direction="AtoB",
                              dtype=dtype, weight_quant=weight_quant)
        self.module = ep.module()
        self.ring = W.ring(traffic["ring"],
                           (self.batch, 3, self.size, self.size), seed,
                           self.device, dtype)

    def request(self, i: int) -> torch.Tensor:
        return self.module(self.ring[i % self.ring.shape[0]])

    def reference(self, i: int, prec=None, rows: int = 32) -> torch.Tensor:
        """The plain student's fp32 output for request i's images, in
        blocks of ``rows``."""
        prec = prec or precision.Exact()
        P = self.weights[self.fam.serve_nets[0]]
        x = self.ring[i % self.ring.shape[0]].float()
        with torch.no_grad():
            return torch.cat([self.fam.reference.student(self.cfgj, P, b, prec)
                              for b in x.split(rows)])


def check_steps(traffic: dict) -> int:
    return traffic.get("check_steps", 3)


def listed(items: List[dict], cell: str, reported: set) -> List[dict]:
    """The metrics of ``items`` that cell reports: those that list it, and
    those with no list that move a metric it reports (or, end to end,
    that every cell reports)."""
    out = []
    for m in items:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif "moves" not in m or m["moves"] in reported:
            out.append(m)
    return out
