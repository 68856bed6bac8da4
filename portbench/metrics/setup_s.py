"""setup_s (s): from the harness's start to the window's, host clock: imports,
CUDA's start, the kernel library (built with nvcc in a checkout's first
run), the scene and the untimed first job."""


def read(rec):
    return rec.setup_s
