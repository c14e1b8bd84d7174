"""device_idle: 1 - (the union of the device's kernel, copy and set
intervals) / the traced window, on the device's clock."""


def read(run):
    t = run.trace
    return 1.0 - t["busy_s"] / t["window_s"] if t and t["window_s"] > 0 else None
