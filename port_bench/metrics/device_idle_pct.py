"""``device_idle_pct``: the share of the traced stretch in which no
operation (kernel, copy or fill) ran on the device, from
``torch.profiler``: 100 x (1 - the union of the device ops' intervals
over the stretch's length)."""


def read(trace):
    if not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
