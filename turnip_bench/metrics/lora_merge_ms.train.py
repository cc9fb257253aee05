"""Device milliseconds a training step of the kernels the LoRA merges
launch (the program's span ``turnip.lora.merge``, one a target and layer):
in the forward, in the checkpoint's recompute and in their backward."""
from .. import spans

spans.install()


def read(run):
    return spans.span_ms(run, "turnip.lora.merge")
