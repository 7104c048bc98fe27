"""``setup_s``: process start to the window's start (host clock):
loading and building the kernel library, compiling, routing, warming."""


def read(run):
    return run.setup_s
