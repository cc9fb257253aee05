"""The port's data pipeline (``repro_torch.data.pipeline``, a numpy-only
copy) gives the reference's batches byte for byte: every (config, step,
shard) here, and the keys and dtypes."""
import numpy as np
import pytest

from repro.data.pipeline import DataConfig as RefConfig
from repro.data.pipeline import SyntheticLMStream as RefStream
from repro_torch.data.pipeline import DataConfig, SyntheticLMStream


@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (32000, 64, 4, 0), (256, 17, 6, 3), (65536, 128, 2, 11)])
@pytest.mark.parametrize("step", [0, 1, 7, 1000])
def test_batches_equal_reference(vocab, seq, batch, seed, step):
    mine = SyntheticLMStream(DataConfig(vocab, seq, batch, seed))
    ref = RefStream(RefConfig(vocab, seq, batch, seed))
    for n_shards in (1, 2):
        if batch % n_shards:
            continue
        for shard in range(n_shards):
            got = mine.batch(step, shard, n_shards)
            want = ref.batch(step, shard, n_shards)
            assert sorted(got) == sorted(want) == ["labels", "tokens"]
            for k in want:
                assert got[k].dtype == want[k].dtype
                assert got[k].tobytes() == want[k].tobytes()


def test_shards_tile_the_global_batch():
    s = SyntheticLMStream(DataConfig(100, 9, 4, 1))
    whole = s.batch(3)["tokens"]
    parts = np.concatenate([s.batch(3, i, 2)["tokens"] for i in range(2)])
    assert whole.tobytes() == parts.tobytes()
    with pytest.raises(ValueError):
        s.batch(0, 0, 3)
