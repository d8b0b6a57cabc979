"""The port's multi-process dryrun (quantumcomputer_tpu_torch/scripts/dcn_dryrun.py),
the counterpart of tests/test_dcn_multiprocess.py: 2 CPU processes x 4
shards each, joined in a gloo group, one sharded circuit and measurement
across the process boundary; the same assertions as the JAX test's, the
measurement taken on one shared uniform draw in place of the JAX key."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dcn_two_process_dryrun():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "quantumcomputer_tpu_torch.scripts.dcn_dryrun"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=440,
    )
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["ok"] is True
    assert summary["num_processes"] == 2
    res = summary["results"]
    assert len(res) == 2
    for r in res:
        assert r["mesh_degree"] == 3
        assert r["ici_degree"] == 2  # 4-shard process blocks stay inside a process
        assert r["match"] is True    # sharded == single-device measurement
        assert abs(r["multi_norm"] - 1.0) < 1e-12
        assert r["shards_max_abs"] < 1e-12 and r["crossing_bytes"] > 0
    assert [r["local_shards"] for r in res] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    # the measurement is the SAME index in both processes
    assert res[0]["multi_idx"] == res[1]["multi_idx"]
