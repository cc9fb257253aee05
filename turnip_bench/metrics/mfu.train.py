"""The whole training step's share of the card's bf16 peak: the closed-form
model FLOPs of the window's steps (``costs/model_flops.py`` and the
family's ``costs/flops_<family>.py``: forward, activation gradients and
the adapters' gradients of a frozen base, no recompute) over the window's
seconds and 989 TFLOP/s, in percent."""
from ..costs import model_flops, peaks


def read(run):
    if not run.units:
        return None
    config, rank = run.cell.config, run.cell.traffic["lora"]["rank"]
    flops = sum(model_flops.lora_step_flops(config, S, rank)
                for seqs in run.lengths for S in seqs)
    return 100.0 * flops / run.window_s / peaks.BF16_FLOPS
