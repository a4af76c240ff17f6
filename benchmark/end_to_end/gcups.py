"""gcups: billions of cells (m * n of every pair of every call completed in
the window, once however often the construction sweeps them) a second of
the whole window, on the host clock."""


def read(run):
    if not run.calls or run.window_s <= 0:
        return None
    return run.cells_done / run.window_s / 1e9
