"""check_line.py against the real BENCHMARK.json."""

import copy
import json
import os

import pytest

from perfbench import check_line

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def good(manifest, cell, trace):
    ms = check_line.cell_metrics(manifest, cell, trace)
    line = {"correct": True, "attempted": 40, "failed": 0,
            "metrics": {m["name"]: {"value": 12.5, "unit": m["unit"]}
                        for m in ms},
            "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                       "count": 1, "memory_peak_bytes": 5_000_000_000}}
    if trace:
        line["device"].update(busy_s=2.0, window_s=2.1)
        line["breakdown"] = {"device_ops": [["k", 1.0]],
                             "idle_gaps": [["h", 0.1]]}
    return line


def test_manifest_meets_the_rules(manifest):
    assert check_line.check_manifest(manifest) == []


@pytest.mark.parametrize("trace", [0, 1])
def test_every_cell_accepts_a_good_line(manifest, trace):
    for cell in manifest["workloads"]:
        line = good(manifest, cell["name"], trace)
        assert check_line.check_line(json.dumps(line), manifest,
                                     cell["name"], trace) == []


@pytest.mark.parametrize("fault", [
    "missing_metric", "wrong_unit", "share_over_100", "roofline_zero",
    "busy_over_window", "extra_metric", "cpu_platform", "no_device_key",
    "not_json", "nan_value"])
def test_a_faulty_line_is_refused(manifest, fault):
    cell = "yi-6b.serve_long"
    line = good(manifest, cell, 1)
    m = line["metrics"]
    if fault == "missing_metric":
        del m["int4_gemv_roofline"]
    elif fault == "wrong_unit":
        m["step_mfu"]["unit"] = "percent"
    elif fault == "share_over_100":
        m["device_idle_share"]["value"] = 100.5
    elif fault == "roofline_zero":
        m["int4_gemm_roofline"]["value"] = 0.0
    elif fault == "busy_over_window":
        line["device"]["busy_s"] = 3.0
    elif fault == "extra_metric":
        m["ttft_p95_ms"] = {"value": 1.0, "unit": "ms"}
    elif fault == "cpu_platform":
        line["device"]["platform"] = "cpu"
    elif fault == "no_device_key":
        del line["device"]["memory_peak_bytes"]
    elif fault == "nan_value":
        m["step_mfu"]["value"] = float("nan")
    text = "{not json" if fault == "not_json" else json.dumps(line)
    assert check_line.check_line(text, manifest, cell, 1)


def test_manifest_faults_are_found(manifest):
    m = copy.deepcopy(manifest)
    m["per_layer"][0]["why"] = "a key the contract does not have"
    m["end_to_end"][0]["unit"] = "tokens per second"
    m["workloads"][1]["config"] = "nowhere"
    bad = check_line.check_manifest(m)
    assert len(bad) >= 3
