"""files/s: every file the engine returned in the window over the whole
window, from its first batch's start to its last batch's end (host clock)."""


def read(run):
    return run.window_files / run.window_s
