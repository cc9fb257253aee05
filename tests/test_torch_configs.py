"""The port's ``input_specs`` against the reference's, key by key: the
same keys in the same order, shape tuples and dtype names, for every
assigned architecture and each of its applicable shapes; the port's
stand-ins are meta-device tensors that hold no storage."""
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_arch as ref_get_arch
from repro.configs.base import input_specs as ref_input_specs
from repro_torch.configs import (ASSIGNED, SHAPES, applicable_shapes,
                                 get_arch, input_specs)

CASES = [(a, s) for a in ASSIGNED for s in applicable_shapes(get_arch(a))]


@pytest.mark.parametrize("arch,shape", CASES, ids=[f"{a}-{s}"
                                                   for a, s in CASES])
def test_input_specs_match_reference(arch, shape):
    want = ref_input_specs(ref_get_arch(arch), REF_SHAPES[shape])
    got = input_specs(get_arch(arch), SHAPES[shape])
    assert list(got) == list(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype), k
        assert got[k].device.type == "meta", k


def test_input_specs_frontends():
    """The stub frontends' stand-ins at train_4k: seamless takes S/2 frame
    embeddings and S/2 tokens, internvl 256 vision embeddings before
    S - 256 tokens."""
    s = input_specs(get_arch("seamless-m4t-large-v2"), SHAPES["train_4k"])
    assert s["encoder_embeds"].shape == (256, 2048, 1024)
    assert s["tokens"].shape == s["labels"].shape == (256, 2048)
    v = input_specs(get_arch("internvl2-26b"), SHAPES["prefill_32k"])
    assert list(v) == ["vision_embeds", "tokens"]
    assert v["vision_embeds"].shape == (32, 256, 6144)
    assert v["vision_embeds"].dtype == torch.bfloat16
    assert v["tokens"].shape == (32, 32768 - 256)
