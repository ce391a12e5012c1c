"""Lock-step iterations of a march's f32 call (the most steps of any
member), as the window's mean.  For one seed it repeats exactly."""


def read(run):
    ms = run['marches']
    return sum(m['iterations'] for m in ms) / len(ms)
