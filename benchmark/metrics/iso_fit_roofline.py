"""K4 (``iso_fit``, ops/cuda_convection) in the traced f32 march: its
least bytes at [members, cells] over the HBM rate, over its mean device
time a launch, in %."""
from core.yardstick import iso_fit_bytes, roofline_percent
from metrics._common import shape, trace0


def read(run):
    tr = trace0(run)
    if tr is None:
        return None
    times = tr.kernel_times('iso_fit')
    if not times:
        return None
    B, n = shape(run)
    return roofline_percent(iso_fit_bytes(B, n), sum(times) / len(times))
