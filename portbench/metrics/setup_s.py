"""Seconds from the harness's first line to the window's start: CUDA
initialisation, kernel builds and loads, the cluster's boot, its pools,
preloads, a marked-down OSD and the warm-up."""


def read(run):
    return run.setup_s
