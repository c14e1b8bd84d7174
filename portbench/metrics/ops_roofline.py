"""ops_roofline: the least time of the program's kernel calls (sbmax,
boundsum_gather, doc_score_fwd), counted from each call's inputs at the
card's peaks, over their device time, in percent; over the first calls of
each in the traced window (``trace.OpCalls``)."""


def read(run):
    r = run.rooflines
    if not r:
        return None
    least = sum(v[0] for v in r.values())
    device = sum(v[1] for v in r.values())
    return 100.0 * least / device if device > 0 else None
