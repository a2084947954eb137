"""Host milliseconds of one batch's submit in the open loop (the step and
the copies of its results to pinned host memory), averaged over the
window's batches."""

UNIT = "ms"
LAYER = "host issue"
MOVES = "latency_p95_ms"


def read(r):
    if r.loop != "stream" or not r.issue_s:
        return None
    return 1e3 * sum(r.issue_s) / len(r.issue_s)
