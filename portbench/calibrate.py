"""The readings that a cell's limits are set from, many seeds in one
process (the benchmark's own runs never run this):

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3
        [--control 1,2,3] [--fault 1,2,3] [--fault_name half_batch]
        [--int8 1,2,3] [--mix '{"batch": 8}'] [--fused_resblock on|off]
        [--out file.jsonl] [--dump file.jsonl] [--repeat n]

For each seed of ``--seeds``, the program's numbers against the plain
reference at the cell's own sizes (the lower readings). For each seed of
``--control``, the control's: the reference put in the program's place,
computed in the precision below the configuration's (fp8 for bf16; the
program's own int8 path for serving is weight-only and computes in bf16).
For each seed of ``--fault`` (train cells), the program with the fault
``--fault_name`` of portbench/faults.py planted (half of each batch left
out by default); of ``--int8`` (serve cells), the program's int8
weight-only export. One JSON line a reading, a train reading with its
widest leaves and each iteration's loss gap; ``--dump`` writes every
leaf's and every image's readings of ``--seeds`` instead. ``--mix`` (keys
laid over the cell's mix) and ``--fused_resblock`` run the cell at
another batch or through the other route of the residual blocks (a
witness).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench import cells as C, check, faults  # noqa: E402
from portbench import family  # noqa: E402
from portbench.harness import Cell  # noqa: E402
from portbench.reference import precision  # noqa: E402
from portbench.run_cells import (_exact_fp32, train_numbers,  # noqa: E402
                                 worst_leaves)


def _free(device):
    if device.type == "cuda":
        torch.cuda.empty_cache()


def train_readings(cell, seed, device, what):
    """The numbers of one seed: the program's ("program", or a fault's
    name of portbench/faults.py) or the fp8 control's ("control") against
    the fp32 reference."""
    fam = family.load(cell.cfg["family"])
    n = C.check_steps(cell.traffic)
    with faults.planted(None if what in ("program", "control") else what):
        tc = C.TrainCell(fam, cell.cfg, cell.traffic, seed, device)
        prog = C.to_host(tc.first_steps(n)) if what != "control" else None
    tc.free()
    _free(device)
    _exact_fp32()
    ref = C.to_host(tc.reference(precision.Exact(), n))
    if what == "control":
        prog = C.to_host(tc.reference(precision.FP8(), n))
    return {**train_numbers(prog, ref),
            "step_loss_gaps": [check.loss_gap([p], [r]) for p, r in
                               zip(prog["losses"], ref["losses"])],
            "widest": worst_leaves(prog, ref)}


def _named(rec):
    """A host readings record with its leaves as "net/name" strings."""
    return {"losses": rec["losses"],
            **{k: {opt: {f"{n}/{p}": v for (n, p), v in r.items()}
                   for opt, r in rec[k].items()}
               for k in ("grads", "change")}}


def train_dump(cell, seed, device):
    """The raw readings of one seed: the program's, the fp32 reference's
    and the fp8 control's, leaf by leaf."""
    fam = family.load(cell.cfg["family"])
    n = C.check_steps(cell.traffic)
    with faults.planted("half_batch"):
        tc = C.TrainCell(fam, cell.cfg, cell.traffic, seed, device)
        half = C.to_host(tc.first_steps(n))
    tc.free()
    _free(device)
    tc = C.TrainCell(fam, cell.cfg, cell.traffic, seed, device)
    prog = C.to_host(tc.first_steps(n))
    tc.free()
    _free(device)
    _exact_fp32()
    ref = C.to_host(tc.reference(precision.Exact(), n))
    fp8 = C.to_host(tc.reference(precision.FP8(), n))
    return {"program": _named(prog), "reference": _named(ref),
            "fp8": _named(fp8), "half_batch": _named(half)}


def train_repeat(cell, seed, device, times):
    """The program's numbers on one seed ``times`` over against one
    reference, with each run's widest gradient leaves: whether a reading
    repeats."""
    fam = family.load(cell.cfg["family"])
    n = C.check_steps(cell.traffic)
    progs = []
    for _ in range(times):
        tc = C.TrainCell(fam, cell.cfg, cell.traffic, seed, device)
        progs.append(C.to_host(tc.first_steps(n)))
        tc.free()
        _free(device)
    _exact_fp32()
    ref = C.to_host(tc.reference(precision.Exact(), n))
    moved = check.moved_leaves(ref["grads"])
    for prog in progs:
        worst = sorted(((check._gap(prog["grads"][o][leaf], r[leaf],
                                    statistics.median(r.values())),
                         o, "/".join(leaf), prog["grads"][o][leaf], r[leaf])
                        for o, r in ref["grads"].items()
                        for leaf in moved[o]), reverse=True)[:3]
        yield {**train_numbers(prog, ref), "worst_grads": worst}


def serve_dump(cell, seed, device):
    """Per image of the sampled requests: rms gap and widest gap of the
    program, its int8 weight-only export and the fp8 reference."""
    fam = family.load(cell.cfg["family"])
    out = {}
    for what, quant in (("program", None), ("int8", "int8")):
        sc = C.ServeCell(fam, cell.cfg, cell.traffic, seed, device,
                         weight_quant=quant)
        ys = [sc.request(i) for i in range(cell.traffic["sample"])]
        sc.module = None
        _exact_fp32()
        refs = [sc.reference(i) for i in range(len(ys))]
        out[what] = _per_image(ys, refs)
    out["fp8"] = _per_image([sc.reference(i, precision.FP8())
                             for i in range(len(refs))], refs)
    return out


def _per_image(ys, refs):
    rms, top = [], []
    for y, r in zip(ys, refs):
        d = (y.float() - r).flatten(1)
        rms += (d.square().mean(1).sqrt()
                / r.flatten(1).square().mean(1).sqrt()).tolist()
        top += d.abs().amax(1).tolist()
    return {"rms": rms, "max_abs": top}


def serve_readings(cell, seed, device, what):
    """The image gap of one seed: the program's ("program"), its own int8
    weight-only export's ("int8"), or the control's ("control"): the
    reference computed in fp8."""
    fam = family.load(cell.cfg["family"])
    sc = C.ServeCell(fam, cell.cfg, cell.traffic, seed, device,
                     weight_quant="int8" if what == "int8" else None)
    n = cell.traffic["sample"]
    outs = [sc.request(i) for i in range(n)]
    sc.module = None
    _exact_fp32()
    if what == "control":
        outs = [sc.reference(i, precision.FP8()) for i in range(n)]
    return {"image_gap": max(check.image_gap(y, sc.reference(i))
                             for i, y in enumerate(outs))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser("portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default="")
    p.add_argument("--fault", default="")
    p.add_argument("--fault_name", default="half_batch")
    p.add_argument("--mix", default="")
    p.add_argument("--fused_resblock", choices=("on", "off"), default=None)
    p.add_argument("--int8", default="")
    p.add_argument("--smoke", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--dump", default=None)
    p.add_argument("--repeat", type=int, default=0)
    a = p.parse_args(argv)
    cell = Cell(a.workload, bool(a.smoke))
    if a.mix:
        cell.traffic = dict(cell.traffic, **json.loads(a.mix))
    if a.fused_resblock:
        flags = cell.cfg["flags"]
        i = flags.index("--fused_resblock")
        cell.cfg = dict(cell.cfg, flags=flags[:i + 1] + [a.fused_resblock]
                        + flags[i + 2:],
                        expect=dict(cell.cfg["expect"],
                                    fused_resblock=a.fused_resblock))
    device = torch.device("cpu") if a.smoke else torch.device("cuda", 0)
    kind = cell.traffic["entry"]
    read = {"train": train_readings, "serve": serve_readings}[kind]
    jobs = [("program", s) for s in a.seeds.split(",") if s] \
        + [("control", s) for s in a.control.split(",") if s] \
        + [(a.fault_name, s) for s in a.fault.split(",") if s] \
        + [("int8", s) for s in a.int8.split(",") if s]
    if a.repeat:
        for s in a.seeds.split(","):
            for values in train_repeat(cell, int(s), device, a.repeat):
                print(json.dumps({"seed": int(s), **values}), flush=True)
        return 0
    if a.dump:
        dump = {"train": train_dump, "serve": serve_dump}[kind]
        with open(a.dump, "a") as f:
            for s in a.seeds.split(","):
                t0 = time.perf_counter()
                f.write(json.dumps({"seed": int(s), **dump(cell, int(s),
                                                           device)}) + "\n")
                f.flush()
                print(f"seed {s}: {time.perf_counter() - t0:.1f} s",
                      flush=True)
        return 0
    out = open(a.out, "a") if a.out else None
    for what, s in jobs:
        t0 = time.perf_counter()
        values = read(cell, int(s), device, what)
        line = json.dumps({"workload": a.workload, "what": what,
                           "seed": int(s), **values,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
