"""Seconds from the process's start to the window's opening: imports,
the weights' draw, the program's build and every capture and warm-up."""


def read(run):
    return run["setup_s"]
