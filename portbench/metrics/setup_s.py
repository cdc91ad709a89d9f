"""setup_s: seconds from the process's start to the window's first call
(imports, the port's library built or loaded, the cell built, its shapes
warmed up, a loop's graph captured). Host clock."""


def read(run):
    return run.setup_s
