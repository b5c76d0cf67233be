"""``device_ops_per_step``: the kernels the step program launches per
step, counted from the device records of ``torch.profiler`` over the
traced stretch."""


def read(trace):
    kernels = [d for d in trace.device
               if not d[0].startswith(("Memcpy", "Memset"))]
    if not kernels or not trace.steps:
        return None
    return len(kernels) / trace.steps
