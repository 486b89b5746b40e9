"""A configuration, a traffic mix and a per-layer metric are added as new
files, found by the names in BENCHMARK.json, with no edit to a file the
benchmark already has."""
import importlib.util
import json
import os
import shutil

import run


def test_new_config_traffic_and_metric_need_no_edit(tmp_path, tiny):
    bench = tmp_path / "benchmark"
    shutil.copytree(run.HERE, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))

    cfg = json.load(open(bench / "configs" / "rendezvous_h50.json"))
    cfg.update(name="dummy_cfg", N=6, n=54, m=60)
    (bench / "configs" / "dummy_cfg.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "dummy.mix.json").write_text(json.dumps({
        "entry": "batch", "batch": 4, "pool": 2, "warmup": 1, "check": 2,
        "trace_seconds": 1,
        "draw": {"kind": "uniform", "low": [-1.0] * 6, "high": [1.0] * 6}}))
    (bench / "metrics" / "lanes_per_call.py").write_text(
        '"""Lanes per call."""\n\n\ndef read(run):\n'
        '    return run.calls[0]["lanes"]\n')
    (bench / "limits" / "dummy_cfg.dummy.mix.json").write_text(json.dumps(
        {"numbers": {"kkt_ratio": {"limit": 3.0}}}))
    spec["configs"].append({"name": "dummy_cfg", "source": "test",
                            "file": "benchmark/configs/dummy_cfg.json",
                            "reduced": ["N"], "why": "test"})
    spec["workloads"].append({"name": "dummy_cfg.dummy.mix",
                              "config": "dummy_cfg", "traffic": "dummy.mix",
                              "chips": 1, "why": "test"})
    spec["per_layer"].append({
        "name": "lanes_per_call", "unit": "lanes", "better": "higher",
        "source": "program_counter", "layer": "solver",
        "moves": "scenarios_per_s", "workloads": ["dummy_cfg.dummy.mix"]})
    spec["end_to_end"][0]["workloads"].append("dummy_cfg.dummy.mix")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    mod_spec = importlib.util.spec_from_file_location(
        "run_copy", bench / "run.py")
    copy = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(copy)
    cell = copy.load_cell("dummy_cfg.dummy.mix", root=str(tmp_path))
    assert cell["cfg"]["N"] == 6 and cell["traffic"]["batch"] == 4
    assert [m["name"] for m in cell["per_layer"]] == ["lanes_per_call"]

    import jax
    prob, pool, items, fn = copy.prepare(cell, 1, jax.devices()[:1])
    window = copy.run_window(fn, items, pool["order"], 0.2, 2, 1)
    r = copy.Run(cell, window, 1.0, 1)
    assert copy.read_metrics(r, cell["per_layer"]) == {
        "lanes_per_call": {"value": 4.0, "unit": "lanes"}}
    assert set(copy.read_metrics(r, cell["end_to_end"])) == {
        "scenarios_per_s", "setup_s"}
    worst = copy.check_answers(prob, pool, window["kept"], cell["cfg"])
    assert copy.decide(worst, cell["limits"])[0]
