"""Set-up seconds: from the process's start (imports, the card's context,
the kernels' build on a checkout's first run) through making the inputs
and warming up, to the window's start."""


def read(r):
    return r.setup_s
