"""Card-idle time in the march traced for the card whose gap began while
the host dispatched (innermost span ``march.step`` or ``blend``, outside a
sync span), over the traced window, in %: a part of
``device_idle_share``."""
from metrics._spans import DISPATCH, idle_share


def read(run):
    return idle_share(run, DISPATCH)
