"""setup_s: seconds from the process's start to the first timed iteration
(imports, loading the kernel libraries, the mock scene, the head's warm-up)."""


def read(run):
    return run.setup_s
