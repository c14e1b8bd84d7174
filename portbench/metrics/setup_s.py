"""setup_s: seconds from the process's start to the window's open: imports,
the CUDA context, drawing the corpus, the index build, the warm-up (and, in
a checkout's first run, building the CUDA kernels)."""


def read(run):
    return run.setup_s
