"""Device milliseconds a training step of the kernels the RWKV blocks'
token shifts and mixes launch (the program's span ``turnip.rwkv.mix``): in
the forward, in the checkpoint's recompute and in their backward."""
from .. import spans

spans.install()


def read(run):
    return spans.span_ms(run, "turnip.rwkv.mix")
