"""Multi-process dryrun of the process mesh: 2 CPU processes x 4 shards each.

The counterpart of the JAX package's ``scripts/dcn_dryrun.py``, the same
check with torch.distributed in place of ``jax.distributed.initialize``:

  * build_mesh() over 2 processes x 4 local CPU shards (each process offers
    ``devices=[cpu] * 4``; a gloo group joined through a file store) orders
    the 8 slots process-major: ici_degree == 2 (mesh bits 0-1 stay inside
    a process), mesh_degree == 3;
  * a sharded circuit whose global-qubit butterflies include the TOP mesh
    bit (an exchange between the processes) runs and matches the port's
    single-device engine: the same measured index under the same draw in
    both processes, the same norm, and each process's shards equal to the
    single-device state's slices;
  * the sharded measurement (totals gathered across the processes, the
    owner's pick shared by a psum) agrees in both processes.

Usage:
  python -m quantumcomputer_tpu_torch.scripts.dcn_dryrun     # parent: runs the 2 workers
  python -m quantumcomputer_tpu_torch.scripts.dcn_dryrun --worker --rank K --store PATH

The parent prints one JSON line {"ok": true, ...} and exits 0 on success.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

NUM_PROCESSES = 2
DEVICES_PER_PROCESS = 4
DRAW = 0.6180339887498949  # the measurement's uniform draw, shared by both engines
TIMEOUT_S = 300


def circuit(n: int):
    """Entanglement and phases touching the TOP global qubit (n - 1): its
    butterfly is an exchange between the processes (JAX dryrun's circuit)."""
    from quantumcomputer_tpu_torch.models import circuit as cir

    return (
        (cir.H(n - 1), cir.H(n - 2), cir.H(0))
        + (cir.CNOT(n - 1, 1), cir.CNOT(n - 2, 2), cir.CPHASE(n - 1, 0, 0.7))
        + (cir.H(n - 1), cir.T(2), cir.CZ(n - 1, n - 2), cir.H(n - 2))
    )


def worker(rank: int, store: str) -> None:
    import torch

    torch.set_num_threads(1)
    from quantumcomputer_tpu_torch.parallel import launch
    from quantumcomputer_tpu_torch.parallel.mesh import build_mesh, ici_degree, mesh_degree
    from quantumcomputer_tpu_torch.parallel.sharded import ShardedStateVectorEngine
    from quantumcomputer_tpu_torch.sim.engine import Register, StateVectorEngine

    launch.join(store, rank, NUM_PROCESSES, timeout_s=TIMEOUT_S)
    mesh = build_mesh(devices=[torch.device("cpu")] * DEVICES_PER_PROCESS)
    md, icid = mesh_degree(mesh), ici_degree(mesh)
    procs = [s.process_index for s in mesh.slots]
    assert procs == sorted(procs), f"mesh not process-major: {procs}"
    assert len(mesh.local) == DEVICES_PER_PROCESS, mesh.local

    L, M = 3, 4
    n = L + M
    circ = circuit(n)
    single = StateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, backend="torch")
    s_state = single.run(circ, single.initial_state())
    s_idx, _ = single.measure(s_state.clone(), DRAW)

    multi = ShardedStateVectorEngine(Register(L=L, M=M), dtype=torch.complex128, mesh=mesh)
    m_state = multi.run(circ)
    m_norm = multi.norm(m_state)
    shards_equal = all(
        torch.equal(m_state[k], s_state[:, k * multi.shard_len : (k + 1) * multi.shard_len]) for k in mesh.local
    )
    shards_close = max(
        float((m_state[k] - s_state[:, k * multi.shard_len : (k + 1) * multi.shard_len]).abs().max())
        for k in mesh.local
    )
    m_idx, _ = multi.measure(m_state, DRAW)
    out = {
        "process_id": rank,
        "mesh_degree": md,
        "ici_degree": icid,
        "local_shards": list(mesh.local),
        "single_idx": int(s_idx),
        "multi_idx": int(m_idx),
        "multi_norm": m_norm,
        "shards_max_abs": shards_close,
        "shards_equal": shards_equal,
        "crossing_bytes": sum(v["crossing"] for v in multi.comm.stats.values()),
        "match": bool(int(s_idx) == int(m_idx)),
    }
    launch.leave()
    print("DCN_RESULT " + json.dumps(out), flush=True)
    assert out["match"], out
    assert abs(m_norm - 1.0) < 1e-12, m_norm
    assert shards_close < 1e-12, shards_close
    assert icid == 2 and md == 3, (icid, md)
    assert out["crossing_bytes"] > 0, "no byte left a process"


def parent() -> int:
    from quantumcomputer_tpu_torch.parallel import launch

    with tempfile.TemporaryDirectory(prefix="dcn_dryrun_") as tmp:
        store = os.path.join(tmp, "store")
        commands = [
            [sys.executable, "-m", "quantumcomputer_tpu_torch.scripts.dcn_dryrun", "--worker",
             "--rank", str(i), "--store", store]
            for i in range(NUM_PROCESSES)
        ]
        logs = [os.path.join(tmp, f"worker{i}.log") for i in range(NUM_PROCESSES)]
        ran = launch.run(commands, logs, timeout_s=TIMEOUT_S + 60)
    results = []
    for _, out in ran:
        for line in out.splitlines():
            if line.startswith("DCN_RESULT "):
                results.append(json.loads(line[len("DCN_RESULT "):]))
    ok = all(rc == 0 for rc, _ in ran) and len(results) == NUM_PROCESSES
    if ok:
        # Both processes must see the SAME measurement.
        ok = all(r["multi_idx"] == results[0]["multi_idx"] for r in results)
        ok = ok and all(r["match"] and r["ici_degree"] == 2 and r["mesh_degree"] == 3 for r in results)
    summary = {
        "ok": ok,
        "num_processes": NUM_PROCESSES,
        "devices_per_process": DEVICES_PER_PROCESS,
        "results": results,
    }
    print(json.dumps(summary))
    if not ok:
        for i, (rc, out) in enumerate(ran):
            sys.stderr.write(f"--- worker {i} (exit {rc}) output ---\n{out}\n")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--store", type=str, default="")
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.rank, args.store)
        return 0
    return parent()


if __name__ == "__main__":
    sys.exit(main())
