"""Set-up: from the start of the process to the window's start (the frames
made on the card, the program's kernels and host library built where the
checkout has none yet, the cell's path brought up once); host clock, s."""


def read(run):
    return run.setup_s
