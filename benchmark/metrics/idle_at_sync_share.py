"""Card-idle time in the march traced for the card whose gap began while
the host waited for the card (innermost span ``march.stop_check`` or
``blend.sync``), over the traced window, in %: a part of
``device_idle_share``."""
from metrics._spans import SYNC, idle_share


def read(run):
    return idle_share(run, SYNC)
