"""``knn_fused_roofline``: the share of its roofline at which
``knn_fused`` (``cbf_tpu_torch/csrc/knn.cu``) runs over the traced
stretch: the sum over its launches of the least time the card could take
(``port_bench.work.knn``: the larger of operations over the float32 peak
and bytes over the memory bandwidth) over the sum of their device times.

The profiler's records of the kernel must equal the launches the program
counted in the stretch, and the launches the work was worked out for;
where they differ the reading is refused, not summed in part. Where
the stretch launched none, the kernel is off the path and there is
nothing to read."""

KERNEL = "knn_fused_kernel"


class RecordMismatch(RuntimeError):
    """The profiler saw another number of launches than were made."""


def read(trace):
    work = trace.work.get("knn_fused")
    if not work:
        return None
    records = trace.kernels(KERNEL)
    counted = trace.launches.get("knn_fused", 0)
    if not records and not counted:
        return None          # the kernel is not on this path
    if len(records) != counted or counted != len(work):
        raise RecordMismatch(
            f"knn_fused: {len(records)} profiler records, {counted} "
            f"launches counted, {len(work)} launches with work")
    from port_bench.work.knn import bound_s

    busy = sum(e - s for _, s, e in records) / 1e6
    if busy <= 0:
        return None
    return 100.0 * sum(bound_s(ops, nbytes) for ops, nbytes in work) / busy
