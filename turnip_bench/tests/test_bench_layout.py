"""BENCHMARK.json against the contract's shape, and every piece of every
cell found by its name."""
from __future__ import annotations

import json
import re

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
HERE = ROOT / "turnip_bench"


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["turnip_bench"]
    assert BENCH["command"] == ["python3", "turnip_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 \
        + 1200 <= 43200
    assert cells <= 24 and len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("turnip_bench/")
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    moves = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in moves


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        def has(m):
            return w["name"] in m.get("workloads", [w["name"]])
        e2e = [m["name"] for m in BENCH["end_to_end"] if has(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(has(m) for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_pieces_found_by_name(cell):
    from turnip_bench import harness
    c = harness.load_cell(cell, 1, 1.0, False)
    assert c.traffic["kind"] == "train"
    harness.driver(c.traffic["kind"])
    harness.reference(c.arch["family"])
    assert c.limits and all(v > 0 for v in c.limits.values())
    from repro_torch.configs.base import ArchConfig
    ArchConfig(**c.arch)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_files_found_by_name(metric):
    from turnip_bench import harness
    assert callable(harness.metric_module(metric).read)


def test_config_files_hold_the_published_numbers():
    for c in BENCH["configs"]:
        doc = json.loads((ROOT / c["file"]).read_text())
        assert doc["source"] == c["source"] and doc["reduced"] == c["reduced"]
        assert {"as_run", "departures", "assumed"} <= set(doc)
    r = json.loads((HERE / "configs" / "rwkv6-7b.json").read_text())
    assert (r["num_hidden_layers"], r["hidden_size"], r["head_size"],
            r["intermediate_size"], r["vocab_size"]) == \
        (32, 4096, 64, 14336, 65536)
    a = r["as_run"]
    assert (a["n_layers"], a["d_model"], a["rwkv_headdim"], a["d_ff"],
            a["vocab_size"]) == (32, 4096, 64, 14336, 65536)


def test_the_weights_take_the_published_lora_sizes():
    """The benchmark makes rwkv6-7b's token-shift and decay LoRAs at the
    configuration file's sizes, not the port's default."""
    from turnip_bench.reference import rwkv
    config = json.loads((HERE / "configs" / "rwkv6-7b.json").read_text())
    shapes = {path: shape for path, shape, *_ in rwkv.weight_specs(config)}
    assert shapes["layers/mix_lora_A"] == (32, 4096, 5 * 64)
    assert shapes["layers/mix_lora_B"] == (32, 5, 64, 4096)
    assert shapes["layers/w_lora_A"] == (32, 4096, 128)
    assert shapes["layers/w_lora_B"] == (32, 128, 4096)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_counters_resolve(metric):
    """Each counter a metric file names is found in the program, by its
    module and the names under it, and counts in whole numbers."""
    from turnip_bench import harness
    for where in getattr(harness.metric_module(metric), "COUNTERS",
                         {}).values():
        assert isinstance(harness._counter(where), int), where
