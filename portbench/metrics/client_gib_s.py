"""Payload bytes of every op issued and completed inside the window
without error, over the window's length (host clock)."""


def read(run):
    return run.client_bytes() / run.window_s / 2**30
