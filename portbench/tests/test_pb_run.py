"""The runner on the CPU at a small size: the result line's keys, the
metrics of each kind of run, card-only metrics left out rather than
faked, and cells, configurations and metrics found by name."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from portbench import run as bench
from portbench.tests.small import run_small

ROOT = pathlib.Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_cpu_rehearsal_write_end_to_end():
    result, run = run_small("rados_ec84.write")
    assert list(result) == KEYS
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"client_gib_s", "op_p50_ms",
                                      "op_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["device"]["platform"] == "cpu"
    assert "busy_s" not in result["device"]
    assert list(result["checks"])[-1] == "failed_ops"
    json.dumps(result)


def test_cpu_rehearsal_write_traced():
    result, run = run_small("rados_ec84.write", trace=True)
    assert list(result) == KEYS[:5] + ["breakdown", "checks"]
    assert result["correct"], result["checks"]
    got = set(result["metrics"])
    assert {"osd_op_self_ms", "coalesce_ops_per_launch",
            "resident_h2d_bytes_per_byte", "host_cpu_ms_per_mib"} <= got
    # measured on the card only: absent here, never zero or estimated
    assert not got & {"b1_roofline_pct", "device_idle_pct"}
    assert "busy_s" not in result["device"]
    assert result["checks"]["span_ring_evictions"]["value"] == 0
    assert result["breakdown"]["idle_gaps"]


def test_every_metric_has_a_reader():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(bench.reader(m["name"]))
    for w in b["workloads"]:
        spec = bench.load_cell(w["name"])
        assert bench.traffic_module(spec["workload"]["kind"])
        assert spec["per_layer"] and len(spec["end_to_end"]) >= 2


def test_an_added_cell_and_metric_are_found_without_edits(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench" / "configs",
                    tmp_path / "portbench" / "configs")
    shutil.copytree(ROOT / "portbench" / "workloads",
                    tmp_path / "portbench" / "workloads")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "rados_ec84.write_64k",
                           "config": "rados_ec84", "traffic": "write_64k",
                           "chips": 1, "why": "64 KiB writes"})
    b["per_layer"].append({"name": "pb_added_metric", "unit": "ms",
                           "better": "lower", "source": "program_span",
                           "layer": "OSD daemon (osd/daemon.py)",
                           "moves": "op_p50_ms",
                           "workloads": ["rados_ec84.write_64k"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    w = json.loads((ROOT / "portbench" / "workloads" /
                    "rados_ec84.write.json").read_text())
    w.update(name="rados_ec84.write_64k", traffic="write_64k")
    w["params"]["object_bytes"] = 65536
    (tmp_path / "portbench" / "workloads" /
     "rados_ec84.write_64k.json").write_text(json.dumps(w))
    spec = bench.load_cell("rados_ec84.write_64k", root=tmp_path)
    assert spec["workload"]["params"]["object_bytes"] == 65536
    assert spec["config"]["name"] == "rados_ec84"
    assert "pb_added_metric" in [m["name"] for m in spec["per_layer"]]
    assert "b1_roofline_pct" not in [m["name"] for m in spec["per_layer"]]
    reader = ROOT / "portbench" / "metrics" / "pb_added_metric.py"
    reader.write_text("def read(run):\n    return 1.5\n")
    try:
        assert bench.reader("pb_added_metric")(None) == 1.5
    finally:
        reader.unlink()


def _cli(cwd, env_extra=None):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env_extra or {})}
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "rados_ec84.write", "--seed", "3", "--seconds", "1", "--trace",
         "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_no_card_no_result():
    out = _cli(ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path, {"PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_write_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = bench.load_cell("rados_ec84.write")
    result, _ = bench.run_cell(spec, 2**31 + 5, 3.0, True)
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0
    assert "device_idle_pct" in result["metrics"]

