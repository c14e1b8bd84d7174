"""launches_per_query: device kernels in the traced window over the queries
answered in it."""


def read(run):
    t = run.trace
    return t["kernels"] / run.rec.answered if t and t["kernels"] and run.rec.answered else None
