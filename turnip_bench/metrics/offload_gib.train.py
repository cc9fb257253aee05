"""GiB a step that the activation offload sent to host memory (the
program's own count, ``repro_torch.models.offload.moved``)."""

COUNTERS = {"offloaded_bytes": "repro_torch.models.offload:moved.offloaded"}


def read(run):
    sent = run.counters.get("offloaded_bytes", 0)
    return sent / run.units / 2**30 if sent and run.units else None
