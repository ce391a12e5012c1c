"""K3 (``net_stats_walk``, ops/cuda_two_stream) in the traced f32 march:
its least bytes at the march's shape over the HBM rate, over its mean
device time a launch, in %."""
from core.yardstick import net_stats_walk_bytes, roofline_percent
from metrics._common import shape, trace0


def read(run):
    tr = trace0(run)
    if tr is None:
        return None
    times = tr.kernel_times('net_stats_walk')
    if not times:
        return None
    B, n = shape(run)
    return roofline_percent(net_stats_walk_bytes(B, n),
                            sum(times) / len(times))
