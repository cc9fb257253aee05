"""The dry run on meta tensors (``repro_torch.launch.dryrun``).

Reduced cells run in a subprocess: a fake process group is process-wide,
and none may outlive a test under xdist's workers. The record's keys are
the reference's (its own dry run, on four placeholder devices, of a
reduced cell); the FLOPs of a reduced dense cell equal a closed form
exactly; ``comm_analysis`` counts the result bytes of a hand-built DTensor
program; the kernels' op counts (moved out of ``chip_smoke.py``) keep
their values; a meshed MoE block's peak falls with the ranks that split
its tokens. The meshed step holds only its own share: a dense cell whose
logits dominate halves its temporaries from (2, 2) to (2, 2, 2) and stays
within 2x of the reference's own peak; a recurrent decode cell never
holds its whole embedding table; a meshed Mamba block's peak falls with
the ranks that split its heads.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import get_arch, reduced
from repro_torch.kernels.flash_attention.ops import (flash_bwd_ops,
                                                     flash_ops, visible_keys)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
B, S = 4, 32

_CELLS = """
import json, sys
from repro_torch.configs import get_arch, reduced, ShapeConfig
from repro_torch.launch.dryrun import lower_cell
cells = json.loads(sys.argv[1])
out = {}
for key, (arch, kind, mesh, remat) in cells.items():
    out[key] = lower_cell(reduced(get_arch(arch)),
                          ShapeConfig(kind, %d, %d, kind),
                          mesh_shape=tuple(mesh[-2:]), remat=remat,
                          multi_pod=len(mesh) == 3)
print(json.dumps(out))
""" % (S, B)

CELLS = {
    "dense-prefill-1x1": ("llama-7b", "prefill", (1, 1), "full"),
    "dense-train-1x1": ("llama-7b", "train", (1, 1), "full"),
    "dense-train-2x2": ("llama-7b", "train", (2, 2), "full"),
    "dense-decode-2x2": ("llama-7b", "decode", (2, 2), "full"),
    "moe-train-2x2": ("granite-moe-1b-a400m", "train", (2, 2), "full"),
    "zamba-train-2x2": ("zamba2-7b", "train", (2, 2), "full"),
    "rwkv-train-2x2": ("rwkv6-7b", "train", (2, 2), "full"),
    "rwkv-decode-2x2": ("rwkv6-7b", "decode", (2, 2), "full"),
    "encdec-prefill-2x2": ("seamless-m4t-large-v2", "prefill", (2, 2),
                           "full"),
    "multipod-train": ("qwen2.5-3b", "train", (2, 2, 2), "dots"),
}


def _run(code: str, *args: str, env_extra=None) -> str:
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), **(env_extra or {}))
    res = subprocess.run([sys.executable, "-c", code, *args], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout.strip().splitlines()[-1]


@pytest.fixture(scope="module")
def records() -> dict:
    return json.loads(_run(_CELLS, json.dumps(CELLS)))


@pytest.fixture(scope="module")
def reference_record() -> dict:
    """The reference's own record of the reduced dense train cell on a
    2 x 2 mesh of placeholder devices."""
    code = """
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import repro.launch.dryrun as D
from repro.configs import get_arch, reduced, ShapeConfig
cfg = reduced(get_arch("llama-7b"))
D.get_arch = lambda name: cfg
D.SHAPES = {"train": ShapeConfig("train", %d, %d, "train")}
print(json.dumps(D.lower_cell("llama-7b", "train", mesh_shape=(2, 2))))
""" % (S, B)
    return json.loads(_run(code, env_extra={"JAX_PLATFORMS": "cpu"}))


@pytest.mark.parametrize("cell", list(CELLS))
def test_cells_lower(records, cell):
    rec = records[cell]
    mem = rec["memory"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
    assert mem["peak_bytes_per_device"] == (mem["argument_bytes"]
                                            + mem["temp_bytes"])
    assert rec["cost"]["flops"] > rec["cost"]["aten_flops"] > 0
    n = 1
    for d in CELLS[cell][2]:
        n *= d
    assert rec["n_devices"] == n
    if n > 1 and CELLS[cell][1] == "train":
        assert rec["collectives"]["total_bytes"] > 0


def test_record_keys_are_the_reference(records, reference_record):
    """The port's record has the reference's keys, but for XLA's own raw
    counts, which the aten ops' counts and the kernels' replace."""
    rec, ref = records["dense-train-2x2"], reference_record
    assert set(rec) == set(ref)
    assert set(rec["memory"]) == set(ref["memory"])
    assert set(rec["collectives"]) == set(ref["collectives"])
    assert set(rec["model"]) == set(ref["model"])
    assert set(ref["cost"]) - set(rec["cost"]) == {"xla_raw_flops",
                                                  "xla_raw_bytes"}
    assert set(rec["cost"]) - set(ref["cost"]) == {"aten_flops",
                                                  "aten_bytes", "kernels"}
    # the same rules shard the same state: the same argument bytes
    assert rec["memory"]["argument_bytes"] == \
        ref["memory"]["argument_bytes"]


def _products(cfg) -> tuple[int, int]:
    """(weights in one layer's products, in the unembedding)."""
    D, H, K, Dh, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                      cfg.d_ff)
    return (D * H * Dh + 2 * D * K * Dh + H * Dh * D + 3 * D * F,
            D * cfg.padded_vocab)


def test_dense_flops_closed_form(records):
    """apply: 2 T x (products) + L x flash_ops + (2L + 1) rmsnorms of 4
    operations an element. The training step with remat='full': 6 T x
    (products) + 2 T x (the layers' products, recomputed, but for the MLP's
    down projection: the checkpoint stops its recompute once the last
    saved tensor is rebuilt) + 2L flash forwards (one recomputed) + L
    backwards + the rmsnorms: 4L + 1 forward calls (2L recomputed), 2L + 1
    backward calls with dγ."""
    cfg = reduced(get_arch("llama-7b"))
    L, T, D = cfg.n_layers, B * S, cfg.d_model
    layer, unembed = _products(cfg)
    fa = flash_ops(B, S, S, cfg.n_heads, cfg.d_head, True, 0)
    fb = flash_bwd_ops(B, S, S, cfg.n_heads, cfg.d_head, True, 0)
    prefill = 2 * T * (L * layer + unembed) + L * fa + (2 * L + 1) * 4 * T * D
    assert records["dense-prefill-1x1"]["cost"]["flops"] == prefill
    train = (6 * T * (L * layer + unembed)
             + 2 * T * L * (layer - cfg.d_ff * D)
             + 2 * L * fa + L * fb
             + (4 * L + 1) * 4 * T * D + (2 * L + 1) * 11 * T * D)
    assert records["dense-train-1x1"]["cost"]["flops"] == train
    k = records["dense-train-1x1"]["cost"]["kernels"]
    assert k["flash_attention"]["calls"] == 2 * L
    assert k["flash_attention_bwd"]["calls"] == L
    assert k["rmsnorm"]["calls"] == 4 * L + 1
    assert k["rmsnorm_bwd"]["calls"] == 2 * L + 1


@pytest.mark.parametrize("cell,arch,kernel,per_layer", [
    ("moe-train-2x2", "granite-moe-1b-a400m", "moe_gmm", 3),
    ("zamba-train-2x2", "zamba2-7b", "ssd_scan", 1),
    ("rwkv-train-2x2", "rwkv6-7b", "wkv6", 1)])
def test_backward_kernels_recorded_per_layer(records, cell, arch, kernel,
                                             per_layer):
    """A training step under remat='full' records its family's kernel
    twice a layer (the forward and the recompute: three grouped products a
    MoE layer) and its backward kernel (``moe_gmm_bwd``, ``ssd_scan_bwd``,
    ``wkv6_bwd``) once, as ``flash_attention_bwd`` is recorded once a
    dense layer; no plain backward is recorded."""
    L = reduced(get_arch(arch)).n_layers
    k = records[cell]["cost"]["kernels"]
    assert k[kernel]["calls"] == 2 * per_layer * L
    assert k[f"{kernel}_bwd"]["calls"] == per_layer * L
    assert not [n for n in k if "plain" in n]


def test_visible_keys_closed_form():
    """flash_ops' closed form equals the row-by-row sum it replaced."""
    for Sq, Skv, off in [(1, 1, 0), (7, 7, 0), (5, 9, 4), (9, 5, 0),
                         (4, 4, 10), (130, 300, 170), (3, 8, 2)]:
        want = sum(min(Skv, i + off + 1) for i in range(Sq))
        assert visible_keys(Sq, Skv, True, off) == want
        assert visible_keys(Sq, Skv, False, off) == Sq * Skv


_COMM = """
import json
import torch, torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from repro_torch.launch.comm_analysis import CommCounter, asked_collectives
from repro_torch.launch.dryrun import fake_mesh
with fake_mesh((4,), ("data",)) as mesh:
    def dt(pl, shape):
        return DTensor.from_local(torch.empty(shape, device="meta"), mesh,
                                  (pl,), run_check=False,
                                  shape=torch.Size([8, 16]),
                                  stride=(16, 1))
    with CommCounter() as c, asked_collectives():
        dt(Shard(0), (2, 16)).redistribute(mesh, (Replicate(),))
        dt(Partial(), (8, 16)).redistribute(mesh, (Replicate(),))
        dt(Partial(), (8, 16)).redistribute(mesh, (Shard(0),))
        dt(Shard(0), (2, 16)).redistribute(mesh, (Shard(1),))
    print(json.dumps(c.record()))
"""


def test_comm_analysis_result_bytes():
    """On a 4-way mesh, a [8, 16] f32 tensor: Shard(0) -> Replicate is an
    all-gather of 512 B, Partial -> Replicate an all-reduce of 512 B,
    Partial -> Shard(0) a reduce-scatter of 128 B, Shard(0) -> Shard(1) an
    all-to-all of 128 B (the one DTensor asks for, not the CPU group's
    all-gather fallback)."""
    rec = json.loads(_run(_COMM))
    assert rec == {"by_kind": {"all-gather": 512, "all-reduce": 512,
                               "all-to-all": 128, "reduce-scatter": 128},
                   "counts": {"all-gather": 1, "all-reduce": 1,
                              "all-to-all": 1, "reduce-scatter": 1},
                   "total_bytes": 1280}


def test_fake_cuda_tensors_take_the_shape_only_branch():
    """Under ``FakeTensorMode`` a fake CUDA tensor reports
    ``device.type == "cuda"``: every kernel wrapper must still return
    empty outputs and record its cost, never reach a launcher (without a
    card a launch would raise)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_bwd)
    from repro_torch.kernels.moe_gmm.ops import grouped_matmul
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_bwd
    from repro_torch.kernels.rwkv6.ops import wkv6
    from repro_torch.kernels.shape_only import recording
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    seen = []
    with FakeTensorMode(), recording(lambda *a: seen.append(a[0])):
        def t(*shape, dtype=torch.bfloat16):
            return torch.empty(shape, dtype=dtype, device="cuda")
        q = t(2, 16, 4, 32)
        lse = t(2, 4, 16, dtype=torch.float32)
        assert flash_attention(q, q, q).shape == q.shape
        assert flash_attention_bwd(q, q, q, q, q, lse)[0].shape == q.shape
        x, g = t(8, 32), t(32)
        assert rmsnorm(x, g).shape == x.shape
        assert rmsnorm_bwd(x, g, x)[0].shape == x.shape
        off = t(2, dtype=torch.int32)
        assert grouped_matmul(x, t(2, 32, 16), off, off).shape == (8, 16)
        xh = t(2, 16, 4, 8, dtype=torch.float32)
        bm = t(2, 16, 4, dtype=torch.float32)
        assert ssd_scan(xh, t(2, 16, 4, dtype=torch.float32),
                        t(4, dtype=torch.float32), bm, bm).shape == xh.shape
        assert wkv6(xh, xh, xh, xh, t(4, 8, dtype=torch.float32)).shape \
            == xh.shape
    assert seen == ["flash_attention", "flash_attention_bwd", "rmsnorm",
                    "rmsnorm_bwd", "moe_gmm", "ssd_scan", "wkv6"]


_MOE_PEAK = """
import json, torch
from repro_torch.launch.dryrun import fake_mesh, trace_step
from repro_torch.models.layers import moe_block
from repro_torch.sharding.rules import param_spec, shard_tree, use_mesh
B, S, D, F, E, K = 4, 1024, 256, 128, 16, 8
out = {}
for shape in ((4, 2), (1, 2)):
    with fake_mesh(shape, ("data", "model")) as mesh:
        p = {"router": torch.empty(D, E, device="meta"),
             "wi_gate": torch.empty(E, D, F, device="meta"),
             "wi_up": torch.empty(E, D, F, device="meta"),
             "wo": torch.empty(E, F, D, device="meta")}
        p = shard_tree(p, param_spec(p, mesh), mesh)
        x = shard_tree({"x": torch.empty(B, S, D, device="meta")},
                       {"x": ("data", None, None)}, mesh)["x"]
        leaves = [x, *p.values()]
        for t in leaves:
            t.requires_grad_(True)

        def step(p, x):
            y, aux = moe_block(p, x, n_experts=E, top_k=K)
            return torch.autograd.grad(y.sum() + aux, leaves)
        with use_mesh(mesh):
            rec, _ = trace_step(step, (p, x))
        out["x".join(map(str, shape))] = rec
print(json.dumps(out))
"""


def test_meshed_moe_block_peak_falls_with_its_token_ranks():
    """One meshed ``moe_block``, forward and backward, on meta tensors:
    4 x 1024 tokens of 256, 16 experts of 128, top-8, where the routed rows
    dominate. On (4, 2) each rank routes its quarter of the tokens, so its
    peak live bytes beyond the arguments are at most 0.35 x those on
    (1, 2), where one rank routes them all (a rank that routed every token
    would hold about as much on both); the counts' all-gather is there."""
    rec = json.loads(_run(_MOE_PEAK))
    small, whole = (rec[m]["memory"]["temp_bytes"] for m in ("4x2", "1x2"))
    assert small <= 0.35 * whole, (small, whole)
    assert rec["4x2"]["collectives"]["counts"]["all-gather"] > 0


# a vocabulary large enough that the logits dominate a reduced dense cell
# (8 heads of 32, 8 x 256 tokens), and that the embedding table is a
# reduced rwkv model's largest leaf
BIG_VOCAB = 32768
VB, VS = 8, 256
# (data, model) of the 2-D mesh; the 3-D one puts 2 pods before it. On
# (2, 2, 2) DTensor's own plan of the head's product held its share too;
# on (2, 2, 4) it held the logits of the rank's tokens over the whole
# vocabulary
VOCAB_MESHES = ((2, 2), (2, 4))
_DENSE = """
import dataclasses
from {pkg}.configs import get_arch, reduced, ShapeConfig
dense = dataclasses.replace(reduced(get_arch("llama-7b")), vocab_size=%d,
                            d_model=256, d_ff=512, n_heads=8, n_kv_heads=8)
train = ShapeConfig("train", %d, %d, "train")
""" % (BIG_VOCAB, VS, VB)
_VOCAB_CELLS = _DENSE.format(pkg="repro_torch") + """
import json
from repro_torch.launch.dryrun import lower_cell
out = {}
for mesh in %r:
    for pods in (False, True):
        key = ("2x" if pods else "") + "x".join(map(str, mesh))
        out[key] = lower_cell(dense, train, mesh_shape=mesh, multi_pod=pods)
rwkv = dataclasses.replace(reduced(get_arch("rwkv6-7b")), vocab_size=%d,
                           dtype="bfloat16")
out["rwkv-decode-2x2"] = lower_cell(rwkv, ShapeConfig("decode", %d, %d,
                                                      "decode"),
                                    mesh_shape=(2, 2))
print(json.dumps(out))
""" % (VOCAB_MESHES, BIG_VOCAB, S, B)


@pytest.fixture(scope="module")
def vocab_records() -> dict:
    return json.loads(_run(_VOCAB_CELLS))


def _reference_vocab_record(mesh) -> dict:
    """The reference's own record of the big-vocabulary dense train cell
    on 2 pods of ``mesh``, on placeholder devices."""
    code = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%d"
""" % (2 * mesh[0] * mesh[1]) + _DENSE.format(pkg="repro") + """
import json
import repro.launch.dryrun as D
D.get_arch = lambda name: dense
D.SHAPES = {"train": train}
print(json.dumps(D.lower_cell("llama-7b", "train", multi_pod=True,
                              mesh_shape=%r)))
""" % (mesh,)
    return json.loads(_run(code, env_extra={"JAX_PLATFORMS": "cpu"}))


@pytest.mark.parametrize("mesh", VOCAB_MESHES,
                         ids=["x".join(map(str, m)) for m in VOCAB_MESHES])
def test_logits_shard_over_the_third_mesh_axis(vocab_records, mesh):
    """The reduced dense train cell with a 32768-entry vocabulary: on two
    pods of ``mesh`` each rank holds half the rows of one pod and the same
    share of the vocabulary, so its temporaries, which the logits
    dominate, are at most 0.6 x those on ``mesh``; its peak is within 2 x
    of the reference's own record of the same cell on as many placeholder
    devices. A rank that held the logits of its tokens over the whole
    vocabulary fails both."""
    key = "x".join(map(str, mesh))
    three = vocab_records["2x" + key]["memory"]
    two = vocab_records[key]["memory"]
    assert three["temp_bytes"] <= 0.6 * two["temp_bytes"], (three, two)
    ref = _reference_vocab_record(mesh)["memory"]["peak_bytes_per_device"]
    assert three["peak_bytes_per_device"] <= 2 * ref, (three, ref)


def test_decode_never_holds_the_whole_table(vocab_records):
    """A reduced rwkv decode cell on (2, 2) whose embedding table (32768
    rows of 128, bf16) is its largest leaf: the lookup gathers only the
    table's FSDP shard and keeps its vocabulary shard, so the step's
    temporaries stay under the whole table's bytes."""
    cfg = dataclasses.replace(reduced(get_arch("rwkv6-7b")),
                              vocab_size=BIG_VOCAB)
    table = cfg.padded_vocab * cfg.d_model * 2
    rec = vocab_records["rwkv-decode-2x2"]
    assert rec["memory"]["temp_bytes"] < table, (rec["memory"], table)


_SSD_PEAK = """
import json, torch
from repro_torch.launch.dryrun import fake_mesh, trace_step
from repro_torch.models.ssm import ssd_block, ssd_init
from repro_torch.sharding.rules import param_spec, shard_tree, use_mesh
B, S, D, P, N = 2, 2048, 256, 32, 16        # 16 heads of 32, state 16
out = {}
for shape in ((1, 4), (1, 1)):
    with fake_mesh(shape, ("data", "model")) as mesh:
        p = ssd_init(torch.Generator(), D, d_state=N, headdim=P, expand=2,
                     dtype=torch.bfloat16, device="meta")
        p = shard_tree(p, param_spec(p, mesh), mesh)
        x = shard_tree({"x": torch.empty(B, S, D, dtype=torch.bfloat16,
                                         device="meta")},
                       {"x": ("data", None, None)}, mesh)["x"]

        def step(p, x):
            return ssd_block(p, x, d_state=N, headdim=P, expand=2)
        with use_mesh(mesh):
            rec, _ = trace_step(step, (p, x))
        out["x".join(map(str, shape))] = rec
print(json.dumps(out))
"""


def test_meshed_ssd_block_peak_falls_with_its_head_ranks():
    """One meshed ``ssd_block`` forward on meta tensors, 2 x 2048 tokens
    of 256, 16 heads of 32: on (1, 4) z, x and Δ come out of the
    in-projection sharded by heads (B and C whole), so its peak live bytes
    beyond the arguments are at most 0.5 x those on (1, 1). A projection
    gathered before its split, as the un-aligned column shards forced
    before, holds every head on every rank."""
    rec = json.loads(_run(_SSD_PEAK))
    small, whole = (rec[m]["memory"]["temp_bytes"] for m in ("1x4", "1x1"))
    assert small <= 0.5 * whole, (small, whole)
