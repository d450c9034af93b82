"""The window's seconds ÷ circuits completed (each call is one observable
of a circuit, so a call counts 1 / observables)."""


def read(run):
    return run.window_s / run.units
