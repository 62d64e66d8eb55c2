"""idle_share: the share of the traced window in which no operation ran on
the device, in %: 1 - (the union of the trace's device intervals inside the
window) / (the window)."""


def read(record: dict):
    trace = record.get("trace")
    if not trace or trace["busy_s"] <= 0 or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
