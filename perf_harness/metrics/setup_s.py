"""setup_s: process start to the start of the window, on rank 0's host
clock: imports, the card and process group, the kernel library's build or
load, the warm-up job and the calibration job."""


def read(summary):
    return summary["setup_s"]
