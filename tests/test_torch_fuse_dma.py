"""Fused DMA submissions in the port's serving engine
(``ServeConfig.fuse_dma``), on the CPU.

The port's :class:`Engine` (``device="cpu"``, the reference's parameters
through ``params_from_reference``, float32) serves with KV offload and
preemption under slow simulated links, so that transfers queue up on the
DMA streams: a swap-in submits every block of a request at once, and the
eager mirrors of cold blocks pile up behind the first one's wire time.
With ``fuse_dma`` on and off, under every reload policy and with the disk
tier, the greedy tokens must be the reference's ``naive_generate``
exactly; ``fused_dma_batches`` counts batches of more than one transfer
only when fusion is on. A stream woken with transfers pending takes up to
``max_fuse_dma`` of them in the policy's pop order, sleeps once for the
batch (latency plus every member's bytes over the bandwidth) and hands
the service the whole batch; an error in a fused batch surfaces in the
run loop, with no fallback.
"""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.models import build_model as ref_build_model
from repro.serve import naive_generate as ref_naive_generate
from repro_torch.configs import get_arch, reduced
from repro_torch.core.bridge import params_from_reference
from repro_torch.core.dispatch import H2D
from repro_torch.models import build_model
from repro_torch.serve import (Engine, PagedKVCache, RELOAD_POLICY_NAMES,
                               ServeConfig)
from repro_torch.serve.engine import (_DmaStream, _Transfer,
                                      get_reload_policy)

torch.set_num_threads(1)

PROMPTS = [list(range(1, 30)), list(range(2, 28)), list(range(3, 31))]
MAX_NEW, MAX_LEN = 8, 64
# one row, a swap every 2 decode steps, every block cold: each request is
# swapped out and back in twice, over links slow enough to queue transfers
SLOW = dict(max_len=MAX_LEN, batch_buckets=(1,), block_size=8, offload=True,
            hot_window=0, preempt_every=2, h2d_bw=40e6, d2h_bw=40e6)

_LMS: dict = {}


def lms():
    """(reference model, its params, port model, port params), float32."""
    if not _LMS:
        rm = ref_build_model(ref_reduced(ref_get_arch("olmo-1b")))
        rp = rm.init(jax.random.PRNGKey(0))
        pm = build_model(reduced(get_arch("olmo-1b")), device="cpu")
        pp = params_from_reference(jax.tree.map(np.asarray, rp),
                                   device="cpu")
        _LMS.update(ref=(rm, rp), port=(pm, pp))
    return _LMS


_ORACLE: list = []


def oracle():
    """The reference's unbatched greedy tokens, request i as rid i."""
    if not _ORACLE:
        rm, rp = lms()["ref"]
        _ORACLE.extend(ref_naive_generate(rm, rp, p, max_new=MAX_NEW,
                                          max_len=MAX_LEN, rid=i)
                       for i, p in enumerate(PROMPTS))
    return _ORACLE


def serve(**cfg):
    pm, pp = lms()["port"]
    eng = Engine(pm, pp, ServeConfig(**{**SLOW, **cfg}))
    return eng.generate(PROMPTS, max_new=MAX_NEW), eng.stats


@pytest.mark.parametrize("policy", RELOAD_POLICY_NAMES)
def test_fused_and_unfused_tokens_equal_the_reference(policy):
    fused, fs = serve(reload_policy=policy, fuse_dma=True)
    plain, ps = serve(reload_policy=policy, fuse_dma=False)
    assert fused == plain == oracle()
    assert fs.swaps >= 6 and ps.swaps >= 6      # every request swapped twice
    assert fs.fused_dma_batches > 0
    assert ps.fused_dma_batches == 0
    # the same bytes move either way
    assert fs.reload_bytes == ps.reload_bytes > 0
    assert fs.offload_bytes > 0


def test_fused_disk_tier_tokens_equal_the_reference():
    """The disk stream fuses too: a host tier of two blocks spills the
    rest of every mirror to disk and loads it back in two hops."""
    pm, _ = lms()["port"]
    blk = PagedKVCache(pm, 1, MAX_LEN, block_size=8).block_nbytes
    fused, fs = serve(host_kv_bytes=2 * blk, disk_bw=80e6, fuse_dma=True)
    assert fused == oracle()
    assert fs.disk_spill_bytes > 0 and fs.disk_load_bytes > 0
    assert fs.fused_dma_batches > 0


def test_max_fuse_one_never_fuses():
    out, stats = serve(fuse_dma=True, max_fuse_dma=1)
    assert out == oracle()
    assert stats.fused_dma_batches == 0


def test_stream_batches_in_pop_order_and_sleeps_once():
    """Five transfers pending when the stream starts, ``max_fuse=3``: the
    service sees them as batches of 3 and 2 in the fixed policy's order
    (creation order), ``on_batch`` is called for each, and the stream
    sleeps one latency plus the batch's bytes a batch."""
    lock = threading.Lock()
    seen, sizes = [], []
    stream = _DmaStream(H2D, bw=1e6, latency=0.05,
                        policy=get_reload_policy("fixed"),
                        service=lambda b: seen.append(
                            (time.monotonic(), [t.seq for t in b])),
                        lock=lock, simulate=True, fuse=True, max_fuse=3,
                        on_batch=sizes.append)
    with lock:
        for seq in (4, 2, 0, 3, 1):
            stream.submit(_Transfer(H2D, rid=0, blk=seq, seq=seq,
                                    nbytes=10_000))
    t0 = time.monotonic()
    stream.start()
    while len(seen) < 2:
        time.sleep(0.01)
    with lock:
        stream.shutdown()
    stream.join()
    assert [s for _, s in seen] == [[0, 1, 2], [3, 4]]
    assert sizes == [3, 2]
    # 0.05 + 3e4 / 1e6 = 0.08 s, then 0.05 + 2e4 / 1e6 = 0.07 s
    assert seen[0][0] - t0 >= 0.08
    assert seen[1][0] - seen[0][0] >= 0.07


def test_fused_batch_error_surfaces_without_fallback(monkeypatch):
    """A reload batch whose copy fails is raised by ``run``: the engine
    does not retry the batch unfused, and no thread leaks."""
    pm, pp = lms()["port"]
    eng = Engine(pm, pp, ServeConfig(**SLOW, fuse_dma=True))
    sizes = []

    def broken(blocks):
        sizes.append(len(blocks))
        raise OSError("fused copy fault")
    monkeypatch.setattr(eng, "_copy_to_device", broken)
    n_threads = threading.active_count()
    with pytest.raises(OSError, match="fused copy fault"):
        eng.generate(PROMPTS, max_new=MAX_NEW)
    assert len(sizes) == 1                      # no second, unfused try
    assert threading.active_count() == n_threads
