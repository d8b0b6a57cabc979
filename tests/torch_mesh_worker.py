"""The cases of tests/test_torch_distributed.py, run on a mesh.

``run_case(spec, mesh)`` runs one case on the port's sharded engine over
`mesh`: the test process runs it on a one-process mesh (LocalTransport),
and each worker of a process mesh runs it on its share of the world mesh
(ProcessTransport), started as

    python tests/torch_mesh_worker.py --rank R --world W --shards S --dir DIR

which joins a gloo group through DIR/store, builds the world mesh of W x S
CPU shards, runs every case of DIR/cases.pkl (written by the test process)
and writes each of its shards to DIR/<case>/shard<k>.npy and its results
to DIR/rank<R>.json.  jax-free: it runs in a fresh interpreter.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pickle
import sys

import numpy as np
import torch

from quantumcomputer_tpu_torch import interop
from quantumcomputer_tpu_torch.parallel.sharded import ShardedStateVectorEngine
from quantumcomputer_tpu_torch.parallel.sharded_semiclassical import run_semiclassical_sharded
from quantumcomputer_tpu_torch.sim.engine import Register
from quantumcomputer_tpu_torch.utils.profiling import mesh_collective_report

DTYPES = {"complex128": torch.complex128, "complex64": torch.complex64, "complex32": "complex32"}


def _plan_hash(plan) -> str:
    return hashlib.sha256(repr(plan).encode()).hexdigest()


def _stats(comm) -> dict:
    out = {kind: {"count": v["count"], "bytes": v["bytes"]} for kind, v in comm.stats.items()}
    out["crossing"] = sum(v.get("crossing", 0) for v in comm.stats.values())
    return out


def _transport_case(mesh) -> dict:
    """The transport's four collectives called directly: tuple operands in
    a rotation, an all_to_all, an all_gather and a psum of float64 values;
    on a mesh over processes, also a ppermute whose operands' shapes differ
    from shard to shard, which the receivers across processes refuse."""
    from quantumcomputer_tpu_torch.parallel.comm import transport_for

    comm = transport_for(mesh)
    D, local = mesh.size, mesh.local
    xs = [(torch.full((2, 3), float(k)), torch.full((3,), 10.0 + k, dtype=torch.float64)) if k in local else None
          for k in range(D)]
    got = comm.ppermute(xs, [(k, (k + 1) % D) for k in range(D)])
    values = {"ppermute": {k: [got[k][0].tolist(), got[k][1].tolist()] for k in local}}
    blocks = [[torch.tensor([10.0 * e + k]) for k in range(D)] if e in local else None for e in range(D)]
    recv = comm.all_to_all(blocks)
    values["all_to_all"] = {k: [float(t) for t in recv[k]] for k in local}
    values["all_gather"] = comm.all_gather([torch.tensor(k + 0.5) if k in local else None for k in range(D)]).tolist()
    values["psum"] = float(comm.psum([torch.tensor(1.0 / (k + 3), dtype=torch.float64) if k in local else None
                                      for k in range(D)]))
    refused = None
    if mesh.spans_processes:
        try:
            comm.ppermute([torch.zeros(k + 1) if k in local else None for k in range(D)],
                          [(k, (k + 1) % D) for k in range(D)])
            refused = False
        except ValueError as err:
            refused = "must share their shapes" in str(err)
    return {"shards": [None] * D, "values": {str(k): v for k, v in values.items()}, "stats": _stats(comm),
            "plan": None, "refused": refused}


def run_case(spec: dict, mesh) -> dict:
    """One case on `mesh`: {"shards": D entries (numpy planar, bf16 as
    uint16 bits; None for another process's shard or a case with no
    state; an adjoint case's are the gradient), "values": JSON values,
    "stats": this process's transport counters, "plan": a hash of the
    engine's plan}."""
    kind = spec["kind"]
    if kind == "transport":
        return _transport_case(mesh)
    if kind == "semiclassical":
        rec = run_semiclassical_sharded(*spec["args"], spec["rs"], mesh, dtype=DTYPES[spec["dtype"]])
        values = {"bits": rec.bits, "probs": [float(p) for p in rec.branch_probs], "capacity": rec.capacity,
                  "overflow": rec.overflow}
        return {"shards": [None] * mesh.size, "values": values, "stats": {"exchange_bytes": rec.exchange_bytes},
                "plan": None}
    eng = ShardedStateVectorEngine(Register(spec["L"], spec["M"]), DTYPES[spec["dtype"]], mesh=mesh,
                                   backend=spec.get("backend", "auto"), layout=spec.get("layout", "standard"))
    circuit = spec["circuit"]
    plan = _plan_hash(eng.plan(circuit))
    values = {}
    if spec.get("report"):
        values["report"] = mesh_collective_report(eng, circuit)
    eng.comm.reset()
    if kind == "circuit":
        state = eng.run(circuit)
        values["norm"] = eng.norm(state)
    elif kind == "measure":
        values["indices"] = []
        for r in spec["rs"]:
            idx, state = eng.measure(eng.run(circuit), r)
            values["indices"].append(idx)
    elif kind == "adjoint":  # the gradient of sum(out * w) in the input shards: the run's backward
        w = eng.from_planar(torch.from_numpy(spec["w"]))
        inputs = [None if x is None else x.requires_grad_() for x in eng.initial_state()]
        out = eng.run(circuit, inputs)
        sum(torch.sum(out[k] * w[k]) for k in mesh.local).backward()
        state = [None if x is None else x.grad for x in inputs]
    elif kind == "sample":
        state = eng.run(circuit)
        values["indices"] = eng.sample(state, spec["rs"]).tolist()
        values["norm"] = eng.norm(state)
    else:
        raise ValueError(f"unknown case kind {kind!r}")
    shards = [None if x is None else interop.state_to_numpy(x) for x in state]
    return {"shards": shards, "values": values, "stats": _stats(eng.comm), "plan": plan}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--shards", type=int, required=True)
    ap.add_argument("--dir", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    from quantumcomputer_tpu_torch.parallel import launch
    from quantumcomputer_tpu_torch.parallel.mesh import build_mesh

    launch.join(os.path.join(args.dir, "store"), args.rank, args.world, timeout_s=240)
    mesh = build_mesh(devices=[torch.device("cpu")] * args.shards)
    with open(os.path.join(args.dir, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    results = {"local": list(mesh.local), "owners": [s.process_index for s in mesh.slots], "cases": {}}
    for name, spec in cases.items():
        got = run_case(spec, mesh)
        os.makedirs(os.path.join(args.dir, name), exist_ok=True)
        for k, shard in enumerate(got["shards"]):
            if shard is not None:
                np.save(os.path.join(args.dir, name, f"shard{k}.npy"), shard)
        results["cases"][name] = {key: got.get(key) for key in ("values", "stats", "plan", "refused")}
    with open(os.path.join(args.dir, f"rank{args.rank}.json"), "w") as f:
        json.dump(results, f)
    launch.leave()
    print("ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
