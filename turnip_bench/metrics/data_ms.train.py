"""Host milliseconds a step to hand the step's batch to the card (pinned
host rows, copied without waiting): the data layer's cost a step."""


def read(run):
    feed = run.spans.get("feed")
    return 1e3 * sum(feed) / len(feed) if feed else None
