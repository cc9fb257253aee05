"""Import ban: the port never imports JAX, ml_dtypes or the reference
package — not even a module of it that does not import JAX. Only the
tests import both."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "ml_dtypes", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _banned_imports(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:            # relative: stays inside repro_torch
                continue
            names = [node.module or ""]
        else:
            continue
        for name in names:
            if name.split(".")[0] in BANNED:
                bad.append(f"{path.relative_to(ROOT)}:{node.lineno} {name}")
    return bad


def test_port_sources_exist():
    files = _port_files()
    assert len(files) >= 20
    assert (ROOT / "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu").exists()
    assert (ROOT / "src/repro_torch/kernels/flash_attention/csrc/"
            "flash_attention.cu").exists()
    assert (ROOT / "src/repro_torch/kernels/moe_gmm/csrc/moe_gmm.cu").exists()
    assert (ROOT / "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu").exists()
    assert (ROOT / "src/repro_torch/kernels/rwkv6/csrc/wkv6.cu").exists()
    assert (ROOT / "src/repro_torch/kernels/flash_attention/csrc/"
            "flash_attention_bwd.cu").exists()
    for mod in ("models/lora.py", "models/offload.py", "train/optim.py",
                "train/step.py", "data/pipeline.py", "ckpt/store.py",
                "ft/supervisor.py", "launch/train.py", "launch/mesh.py",
                "serve/router.py", "kernels/plain_grad.py"):
        assert (ROOT / "src/repro_torch" / mod).exists(), mod


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_banned_import(path):
    assert _banned_imports(path) == []


def test_package_imports_without_jax():
    """The port imports with JAX made unimportable, and pulls in no module
    of the reference package."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import repro_torch.core, repro_torch.core.runtime, "
        "repro_torch.core.trace, repro_torch.core.bridge, "
        "repro_torch.configs, repro_torch.kernels.build, "
        "repro_torch.kernels.rmsnorm.ops, repro_torch.models, "
        "repro_torch.serve, repro_torch.kernels.flash_attention.ops, "
        "repro_torch.kernels.moe_gmm.ops, repro_torch.kernels.ssd_scan.ops, "
        "repro_torch.kernels.rwkv6.ops, repro_torch.models.ssm, "
        "repro_torch.models.rwkv, repro_torch.models.lora, "
        "repro_torch.models.offload, repro_torch.train.optim, "
        "repro_torch.train.step, repro_torch.train.tree, "
        "repro_torch.data.pipeline, repro_torch.ckpt.store, "
        "repro_torch.ft.supervisor, repro_torch.launch.train, "
        "repro_torch.launch.mesh, repro_torch.serve.router, "
        "repro_torch.kernels.plain_grad\n"
        "bad = [m for m in sys.modules if m == 'repro' or "
        "m.startswith('repro.') or m.startswith('jax.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
