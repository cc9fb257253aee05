"""The examples' twins (``examples/torch_*.py``) on the CPU, each at its
own small size: every oracle check it prints is True. On the card they run
at their defaults (``chip_smoke.py`` phase 13)."""
from __future__ import annotations

import importlib.util
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

RUNS = {
    "torch_quickstart": ["--device", "cpu"],
    "torch_offload_inference": ["--device", "cpu", "--layers", "2",
                                "--seq", "128"],
    "torch_continuous_batching": ["--device", "cpu", "--requests", "3"],
    "torch_lora_training": ["--device", "cpu", "--steps", "6",
                            "--save-every", "2", "--layers", "1",
                            "--d-model", "64"],
}


def _main(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def oracle_checks(out: str) -> list[bool]:
    """Every oracle check an example prints: ``... oracle: True|False`` and
    the offload example's ``close`` column."""
    checks = [m == "True" for m in re.findall(r"oracle: (True|False)", out)]
    checks += [m == "True" for m in re.findall(
        r"^\s*[\d.]+\s+\d+\s+\d+\s+[\d.]+\s+(True|False)$", out, re.M)]
    return checks


@pytest.mark.parametrize("name", list(RUNS))
def test_example_twin(name, capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    _main(name)(RUNS[name])
    out = capsys.readouterr().out
    checks = oracle_checks(out)
    if name == "torch_lora_training":
        m = re.search(r"finished at step (\d+) with (\d+) restart", out)
        assert m and m.groups() == ("6", "1"), out
    else:
        assert checks and all(checks), out
