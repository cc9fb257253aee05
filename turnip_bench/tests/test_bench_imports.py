"""What the benchmark's process may load, and what it refuses: no module
whose top-level name is ``jax``, ``jaxlib``, ``flax`` or ``repro`` (names
compared whole, so ``repro_torch`` passes), no result without a card."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT

_PROBE = r"""
import json, sys, time, torch
sys.path[:0] = [{tests!r}, {root!r}, {src!r}]
from conftest import tiny_cell
from turnip_bench import harness
cell = tiny_cell(seconds=0.05, trace=True)
harness.driver(cell.traffic["kind"]).run(cell, torch.device("cpu"),
                                         time.perf_counter())
for m in json.load(open({bench!r}))["per_layer"]:
    harness.metric_module(m["name"])
print(json.dumps({{"banned": harness.banned_modules(),
                  "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def _probe() -> dict:
    code = _PROBE.format(tests=str(ROOT / "turnip_bench" / "tests"),
                         root=str(ROOT), src=str(ROOT / "src"),
                         bench=str(ROOT / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=_env())
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _env() -> dict:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_a_run_loads_no_jax_and_no_jax_package():
    got = _probe()
    assert got["banned"] == []
    assert "repro_torch" in got["top"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(got["top"])


def test_banned_names_are_compared_whole(monkeypatch):
    from turnip_bench import harness
    monkeypatch.setitem(sys.modules, "repro_torchx", sys)
    monkeypatch.setitem(sys.modules, "jax_like.sub", sys)
    assert "repro" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert harness.banned_modules() == ["repro"]


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "turnip_bench" / "reference").glob("*.py"):
        text = path.read_text()
        assert "repro_torch" not in text.replace("``repro_torch/", "")
        assert "import jax" not in text and "from repro" not in text


def test_no_result_without_a_card(tmp_path):
    """Here there is no card: the command fails and prints no result, in
    the checkout and in a directory holding only BENCHMARK.json and the
    benchmark's folder."""
    only = tmp_path / "only"
    only.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", only)
    shutil.copytree(ROOT / "turnip_bench", only / "turnip_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for where in (ROOT, only):
        out = subprocess.run(
            [sys.executable, "turnip_bench/run.py", "--workload",
             "rwkv6-7b.lora-offload.2x8192", "--seed", str(2**31 + 12345),
             "--seconds", "1", "--trace", "0"], cwd=where,
            capture_output=True, text=True, timeout=300, env=_env())
        assert out.returncode != 0
        assert out.stdout.strip() == ""
