"""The host inside the step of the march traced for the card: the self
time of its ``march.step`` spans (outside their child spans, such as the
group blend), in ms a lock-step iteration: a part of ``iteration_ms``, on
its count of iterations.  Dispatch, and where the card is the slower a
wait on a full launch queue too: the card feels only
``idle_in_dispatch_share``."""
from metrics._spans import per_iter_ms, self_ns


def read(run):
    return per_iter_ms(run, lambda s: self_ns(s, 'march.step'))
