"""idle_share.<cell kind> (``idle_share.train``, ``idle_share.live``):
the share of the traced units (steps or frames) in which no operation ran
on the device: 1 - (union of device operation intervals) / (the
stretch's wall time, sync to sync), in %. The stretch records the
device's activity alone, so the host runs at its untraced pace."""
from harness.readers import traced


def read(ctx):
    t = traced(ctx)
    return None if t is None else 100.0 * (1.0 - t.busy_s / t.wall_s)
