"""Helpers shared by the per-layer readers of metrics/."""


def trace_idle(rec):
    """100 less the device's busy share of the traced window, in %."""
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["device_events"] == 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
