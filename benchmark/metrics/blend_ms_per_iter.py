"""The group blend (``ops/convection.reference_adjust_rows``, its
``blend`` spans, host syncs included) in the march traced for the card, in
ms a lock-step iteration (as ``iteration_ms`` counts them)."""
from metrics._spans import per_iter_ms, total_ns


def read(run):
    return per_iter_ms(run, lambda s: total_ns(s, 'blend'))
