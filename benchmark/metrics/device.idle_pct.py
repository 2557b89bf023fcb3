"""The share of the traced window, %, in which the device ran nothing:
100 (1 - busy / window), busy the union of its kernels, copies and fills,
the window from the first traced job's start to the last one's end."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device_ops:
        return None
    start, end = tr.window()
    return 100.0 * (1.0 - tr.busy_s() / ((end - start) / 1e9))
