"""The process's CPU time over the window (``os.times``: user and system,
every thread) in ms per MiB of client payload.  One event loop runs
every daemon and the clients, so this is the host's cost
of a MiB served."""


def read(run):
    nbytes = run.client_bytes()
    if not nbytes or run.cpu_s is None:
        return None
    return run.cpu_s * 1e3 / (nbytes / 2**20)
