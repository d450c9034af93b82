"""Circuits labelled in the window × 60 ÷ the window's seconds."""


def read(run):
    return run.units * 60.0 / run.window_s
