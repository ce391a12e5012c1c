"""Simulated days over all members of every march of the window, over the
window's wall: from the first march's start to the last march's end.  A
march is the user's result: the f32 march, the f64 finish and the read-back."""


def read(run):
    return sum(m['days'] for m in run['marches']) / run['window_wall']
