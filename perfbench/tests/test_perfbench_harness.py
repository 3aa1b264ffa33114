"""The harness is driven by data: a cell, a configuration and a per-layer
metric added as new files (and entries of ``BENCHMARK.json``) are found by
name with no file of the benchmark edited; the result line holds the
contract's keys, ``breakdown`` only in a traced run; a machine without a
card gets no result."""

import hashlib
import json
import os
import shutil
import time

import pytest
import torch

from perfbench import harness, run
from perfbench.tests import small

END_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


class StandInTrace:
    """Stands for ``harness.DeviceTrace`` on the CPU: two kernels over the
    window's host clock."""

    def start(self):
        self.t0 = time.perf_counter()

    def stop(self):
        self.t1 = time.perf_counter()

    def kernels(self):
        d = self.t1 - self.t0
        return [("rollout2d_kernel<16, 0>", self.t0 + 0.1 * d,
                 self.t0 + 0.4 * d),
                ("gemm", self.t0 + 0.5 * d, self.t0 + 0.6 * d)]


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" in d:
                continue
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha1(
                    fh.read()).hexdigest()
    return out


def test_new_cell_config_and_metric_are_found_by_name(tmp_path):
    src = os.path.join(harness.ROOT, "perfbench")
    bench_dir = tmp_path / "perfbench"
    shutil.copytree(src, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    before = _digests(bench_dir)

    cfg = json.loads((bench_dir / "configs" / "dgdm-2d.json").read_text())
    cfg.update(name="dgdm-2d-tiny", grid_size=4, num_pos=1,
               verify_steps=40, verify_regrasp=20, sub_bs=2,
               objects=cfg["objects"][:2])
    cfg["classifier"].update(width=32, num_trunk=2)
    cfg["unet"].update(down_dims=[16, 32], n_groups=4)
    (bench_dir / "configs" / "dgdm-2d-tiny.json").write_text(json.dumps(cfg))
    work = json.loads((bench_dir / "workloads" /
                       "dgdm-2d.design.json").read_text())
    work.update(config="dgdm-2d-tiny", traffic="design-tiny")
    work["params"].update(batch=2, check_requests=1)
    (bench_dir / "workloads" / "dgdm-2d-tiny.design.json").write_text(
        json.dumps(work))
    (bench_dir / "metrics" / "requests.tiny.py").write_text(
        "def read(window):\n"
        "    return float(len(window.records['requests']))\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dgdm-2d-tiny", "source": "a test",
                             "file": "perfbench/configs/dgdm-2d-tiny.json",
                             "reduced": ["grid_size"], "why": "a test"})
    bench["workloads"].append({"name": "dgdm-2d-tiny.design",
                               "config": "dgdm-2d-tiny",
                               "traffic": "design-tiny", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if "dgdm-2d.design" in m.get("workloads", []):
            m["workloads"].append("dgdm-2d-tiny.design")
    bench["per_layer"].append({"name": "requests.tiny", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "guidance", "moves": "design_s",
                               "workloads": ["dgdm-2d-tiny.design"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell("dgdm-2d-tiny.design", root=str(tmp_path),
                             bench_dir=str(bench_dir))
    assert cell.config["grid_size"] == 4
    assert [m["name"] for m in cell.per_layer] == ["requests.tiny"]
    assert {m["name"] for m in cell.end_to_end} == {
        "design_s", "design_p90_s", "setup_s"}
    out = run.run_cell(cell, 2 ** 31 + 17, 1.0, True, small.CPU,
                       tracer=StandInTrace())
    assert out["metrics"]["requests.tiny"]["value"] >= 1.0
    after = _digests(bench_dir)
    assert {k: after[k] for k in before} == before


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(traced):
    cell = small.design_cell()
    out = run.run_cell(cell, 2 ** 31 + 5, 1.0, traced, small.CPU,
                       tracer=StandInTrace() if traced else None)
    keys = list(out)
    assert keys[:5] == END_KEYS and keys[-1] == "compared"
    assert ("breakdown" in out) == traced
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for v in out["compared"].values():
        assert set(v) == {"value", "limit"}
    if traced:
        assert set(out["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert out["device"]["busy_s"] > 0 and out["device"]["window_s"] > 0
        b = out["breakdown"]
        assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
        assert b["device_ops"][0][0].startswith("rollout2d_kernel")
        assert "rollout_roofline.verify" in out["metrics"]
    else:
        assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    json.dumps(out)


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the check is of one without")
    rc = run.main(["--workload", "dgdm-2d.design", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
