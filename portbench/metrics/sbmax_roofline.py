"""sbmax_roofline: the least time of the program's sbmax kernel calls,
counted from each call's inputs at the card's peaks, over their device
time, in percent; over its first calls in the traced window."""


def read(run):
    v = run.rooflines.get("sbmax")
    return 100.0 * v[0] / v[1] if v and v[1] > 0 else None
