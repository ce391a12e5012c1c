"""The host's wait for the card at the march's stop checks (its
``march.stop_check`` spans, the reads of the stop flags every
``SYNC_EVERY`` iterations) in the march traced for the card, in ms a
lock-step iteration (as ``iteration_ms`` counts them)."""
from metrics._spans import per_iter_ms, total_ns


def read(run):
    return per_iter_ms(run, lambda s: total_ns(s, 'march.stop_check'))
