"""The port's checkpoint store (``repro_torch.ckpt.store``): case-for-case
twins of ``tests/test_ckpt_fault.py`` on trees of torch tensors, plus
cross-reads with the reference's store (each restores what the other
wrote, float32 and bfloat16 leaves) and the bfloat16 round trip."""
import json
import pathlib
import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.ckpt.store as ref_store
from repro_torch.ckpt.store import (complete_steps, latest_step,
                                    restore_checkpoint, save_checkpoint,
                                    save_checkpoint_async)


def tree_at(step: int) -> dict:
    return {
        "params": {
            "w0": torch.full((64, 64), float(step)),            # 16 KiB
            "w1": torch.full((64, 64), float(step + 1)),
            "w2": torch.full((32,), float(step + 2)),
        },
        "step": torch.tensor(step, dtype=torch.int32),
    }


def save_small_shards(tmp_path, step):
    """Force multi-shard layout: threshold below one big leaf's bytes."""
    return save_checkpoint(tmp_path, step, tree_at(step),
                           shard_bytes=8 * 1024)


class TestSharding:
    def test_leaves_split_across_shards(self, tmp_path):
        p = save_small_shards(tmp_path, 3)
        shards = sorted(f.name for f in p.glob("shard_*.npz"))
        assert len(shards) >= 3          # two 16 KiB leaves can't share one
        manifest = json.loads((p / "MANIFEST.json").read_text())
        assert set(manifest["files"]) == set(shards)
        assert {l["file"] for l in manifest["leaves"]} == set(shards)
        # per-file digests: every shard is covered
        assert all(len(d) == 64 for d in manifest["files"].values())

    def test_multi_shard_roundtrip(self, tmp_path):
        t = tree_at(5)
        save_small_shards(tmp_path, 5)
        got, step = restore_checkpoint(tmp_path, t)
        assert step == 5
        assert torch.equal(got["params"]["w1"], t["params"]["w1"])
        assert torch.equal(got["params"]["w2"], t["params"]["w2"])
        assert got["step"].dtype == torch.int32 and int(got["step"]) == 5

    def test_monolithic_default_still_single_shard(self, tmp_path):
        p = save_checkpoint(tmp_path, 1, tree_at(1))   # default threshold
        assert sorted(f.name for f in p.glob("shard_*.npz")) == \
            ["shard_0.npz"]


def _corrupt(path: pathlib.Path) -> None:
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))


class TestFallback:
    def test_corrupt_newest_shard_falls_back(self, tmp_path):
        save_small_shards(tmp_path, 3)
        p9 = save_small_shards(tmp_path, 9)
        _corrupt(next(iter(sorted(p9.glob("shard_*.npz")))))
        assert latest_step(tmp_path) == 9          # manifest still there...
        assert complete_steps(tmp_path) == [3]     # ...but step 9 is broken
        got, step = restore_checkpoint(tmp_path, tree_at(3))
        assert step == 3                           # newest COMPLETE step
        assert torch.equal(got["params"]["w0"], tree_at(3)["params"]["w0"])

    def test_corrupt_manifest_falls_back(self, tmp_path):
        save_small_shards(tmp_path, 2)
        p7 = save_small_shards(tmp_path, 7)
        (p7 / "MANIFEST.json").write_text("{ not json")
        got, step = restore_checkpoint(tmp_path, tree_at(2))
        assert step == 2

    def test_missing_shard_falls_back(self, tmp_path):
        save_small_shards(tmp_path, 4)
        p8 = save_small_shards(tmp_path, 8)
        sorted(p8.glob("shard_*.npz"))[-1].unlink()
        _, step = restore_checkpoint(tmp_path, tree_at(4))
        assert step == 4

    def test_all_corrupt_raises(self, tmp_path):
        p = save_small_shards(tmp_path, 6)
        for shard in p.glob("shard_*.npz"):
            _corrupt(shard)
        with pytest.raises(IOError, match="corruption"):
            restore_checkpoint(tmp_path, tree_at(6))

    def test_explicit_step_never_falls_back(self, tmp_path):
        save_small_shards(tmp_path, 1)
        p5 = save_small_shards(tmp_path, 5)
        _corrupt(next(iter(p5.glob("shard_*.npz"))))
        with pytest.raises(IOError, match="corruption"):
            restore_checkpoint(tmp_path, tree_at(5), step=5)

    def test_shape_mismatch_not_swallowed_by_fallback(self, tmp_path):
        """Structure errors mean the caller asked for the wrong tree —
        falling back to an older step would silently restore stale
        params."""
        save_small_shards(tmp_path, 2)
        save_small_shards(tmp_path, 9)
        bad = tree_at(9)
        bad["params"]["w0"] = torch.zeros((3, 3))
        with pytest.raises(ValueError):
            restore_checkpoint(tmp_path, bad)


class TestMidWriteCrash:
    """A crash while shards are being written (power loss, OOM-kill,
    raising filesystem) must leave the checkpoint tree exactly as it was:
    no partial step directory, no leaked tmp dir, prior steps restorable."""

    def _crashing_writer(self, monkeypatch, fail_on_call: int):
        import repro_torch.ckpt.store as store_mod
        calls = {"n": 0}
        real = store_mod._write_shard

        def boom(path, arrays):
            calls["n"] += 1
            if calls["n"] == fail_on_call:
                raise OSError("injected: disk died mid-shard-write")
            real(path, arrays)

        monkeypatch.setattr(store_mod, "_write_shard", boom)
        return calls

    def test_crash_mid_write_leaves_no_partial_step(self, tmp_path,
                                                    monkeypatch):
        save_small_shards(tmp_path, 3)
        calls = self._crashing_writer(monkeypatch, fail_on_call=2)
        with pytest.raises(OSError, match="mid-shard-write"):
            save_small_shards(tmp_path, 9)
        # really died partway; pipelined writes already in flight on the
        # disk-tier stream when shard 2 failed may still have run
        assert calls["n"] >= 2
        # nothing published, nothing leaked
        names = sorted(p.name for p in tmp_path.iterdir())
        assert names == ["step_0000000003"]
        # and the tree still restores cleanly
        got, step = restore_checkpoint(tmp_path, tree_at(3))
        assert step == 3
        assert torch.equal(got["params"]["w0"], tree_at(3)["params"]["w0"])

    def test_crash_on_first_shard_of_first_checkpoint(self, tmp_path,
                                                      monkeypatch):
        self._crashing_writer(monkeypatch, fail_on_call=1)
        with pytest.raises(OSError):
            save_small_shards(tmp_path, 1)
        assert list(tmp_path.iterdir()) == []       # pristine directory
        with pytest.raises(FileNotFoundError):
            restore_checkpoint(tmp_path, tree_at(1))

    def test_leftover_tmp_dir_is_invisible(self, tmp_path):
        """A tmp dir orphaned by a hard kill (no exception handler ran)
        must be ignored by discovery and restore."""
        save_small_shards(tmp_path, 4)
        orphan = tmp_path / ".tmp_orphaned"
        orphan.mkdir()
        (orphan / "shard_0.npz").write_bytes(b"garbage")
        assert latest_step(tmp_path) == 4
        assert complete_steps(tmp_path) == [4]
        _, step = restore_checkpoint(tmp_path, tree_at(4))
        assert step == 4


class TestAsyncOverlap:
    """Checkpointing rides the disk-tier stream: the training step loop
    must make progress *while* shard bytes are being written (ROADMAP
    item 5 tail), and the published checkpoint must be byte-identical to
    a blocking save's."""

    def test_step_loop_overlaps_shard_writes(self, tmp_path, monkeypatch):
        import repro_torch.ckpt.store as store_mod
        real = store_mod._write_shard
        windows = []                       # (t_start, t_end) per shard write

        def slow_write(path, arrays):
            t0 = time.perf_counter()
            time.sleep(0.05)               # a slow spindle
            real(path, arrays)
            windows.append((t0, time.perf_counter()))

        monkeypatch.setattr(store_mod, "_write_shard", slow_write)
        pend = save_checkpoint_async(tmp_path, 7, tree_at(7),
                                     shard_bytes=8 * 1024)
        # the "step loop": keep stepping while the save is in flight
        steps = []
        while not pend.done():
            steps.append(time.perf_counter())
            time.sleep(0.002)
        path = pend.result()
        assert path.name == "step_0000000007"
        assert len(windows) >= 3           # multi-shard layout held
        # overlap assertion: some step ran strictly inside a shard-write
        # window — checkpointing did not block the loop
        assert any(a < t < b for t in steps for (a, b) in windows), \
            "no training step overlapped a shard write"
        # and the published bytes are a real, restorable checkpoint
        got, step = restore_checkpoint(tmp_path, tree_at(7))
        assert step == 7
        assert torch.equal(got["params"]["w0"], tree_at(7)["params"]["w0"])

    def test_async_failure_surfaces_and_leaks_nothing(self, tmp_path,
                                                      monkeypatch):
        import repro_torch.ckpt.store as store_mod

        def boom(path, arrays):
            raise OSError("injected: disk died mid-shard-write")

        monkeypatch.setattr(store_mod, "_write_shard", boom)
        pend = save_checkpoint_async(tmp_path, 5, tree_at(5),
                                     shard_bytes=8 * 1024)
        with pytest.raises(OSError, match="mid-shard-write"):
            pend.result(timeout=30)
        # monkeypatch must be undone before other tests reuse the stream
        monkeypatch.undo()
        assert list(tmp_path.iterdir()) == []      # no partial tmp dir

    def test_blocking_save_pipelined_writes_stay_ordered(self, tmp_path,
                                                         monkeypatch):
        """The blocking path now routes shard writes through the same
        stream; the manifest/digest contract is unchanged."""
        import repro_torch.ckpt.store as store_mod
        seen = []
        real = store_mod._write_shard

        def record(path, arrays):
            seen.append(path.name)
            real(path, arrays)

        monkeypatch.setattr(store_mod, "_write_shard", record)
        save_small_shards(tmp_path, 2)
        assert seen == sorted(seen)        # shard_0, shard_1, ... in order
        assert len(seen) >= 3
        got, step = restore_checkpoint(tmp_path, tree_at(2))
        assert step == 2


def mixed_tree_np() -> dict:
    """A reference-style tree: float32 and bfloat16 leaves (ml_dtypes)."""
    rng = np.random.default_rng(0)
    return {"a": {"w": rng.standard_normal((8, 16)).astype(np.float32),
                  "g": rng.standard_normal(16).astype(ml_dtypes.bfloat16)},
            "count": np.int32(3)}


def mixed_tree_torch() -> dict:
    t = mixed_tree_np()
    g = torch.from_numpy(t["a"]["g"].view(np.uint16).astype(np.int32))
    return {"a": {"w": torch.from_numpy(t["a"]["w"]),
                  "g": g.to(torch.int16).view(torch.bfloat16)},
            "count": torch.tensor(3, dtype=torch.int32)}


class TestCrossRead:
    """Each store reads the other's checkpoints: the same layout, the same
    manifest keys and dtype names, bfloat16 as two raw bytes."""

    def test_bfloat16_roundtrip(self, tmp_path):
        t = mixed_tree_torch()
        save_small_shards(tmp_path, 1)
        save_checkpoint(tmp_path, 2, t)
        got, step = restore_checkpoint(tmp_path, t)
        assert step == 2
        assert got["a"]["g"].dtype == torch.bfloat16
        assert torch.equal(got["a"]["g"].view(torch.int16),
                           t["a"]["g"].view(torch.int16))
        assert torch.equal(got["a"]["w"], t["a"]["w"])

    def test_reference_reads_port(self, tmp_path):
        p = save_checkpoint(tmp_path, 4, mixed_tree_torch())
        manifest = json.loads((p / "MANIFEST.json").read_text())
        assert {l["key"]: l["dtype"] for l in manifest["leaves"]} == \
            {"a/g": "bfloat16", "a/w": "float32", "count": "int32"}
        want = mixed_tree_np()
        like = {"a": {"w": jnp.zeros((8, 16)), "g": jnp.zeros(16)},
                "count": jnp.zeros((), jnp.int32)}
        got, step = ref_store.restore_checkpoint(tmp_path, like)
        assert step == 4
        np.testing.assert_array_equal(got["a"]["w"], want["a"]["w"])
        # the reference returns bfloat16 leaves as raw 2-byte elements
        assert np.asarray(got["a"]["g"]).view(np.uint16).tobytes() == \
            want["a"]["g"].view(np.uint16).tobytes()
        assert int(got["count"]) == 3

    def test_port_reads_reference(self, tmp_path):
        ref_store.save_checkpoint(tmp_path, 6, jax_tree(mixed_tree_np()))
        got, step = restore_checkpoint(tmp_path, mixed_tree_torch())
        want = mixed_tree_torch()
        assert step == 6
        assert got["a"]["g"].dtype == torch.bfloat16
        assert torch.equal(got["a"]["g"].view(torch.int16),
                           want["a"]["g"].view(torch.int16))
        assert torch.equal(got["a"]["w"], want["a"]["w"])
        assert got["count"].dtype == torch.int32 and int(got["count"]) == 3

    def test_port_reads_reference_multi_shard(self, tmp_path):
        rt = {"params": {k: np.asarray(v) for k, v in
                         tree_at(5)["params"].items()},
              "step": np.int32(5)}
        ref_store.save_checkpoint(tmp_path, 5, rt, shard_bytes=8 * 1024)
        got, step = restore_checkpoint(tmp_path, tree_at(0))
        assert step == 5
        for k in ("w0", "w1", "w2"):
            assert torch.equal(got["params"][k], tree_at(5)["params"][k])


def jax_tree(t: dict) -> dict:
    return {k: jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in t.items()}
