"""images_per_s (images/s): every image of the batches the window
completed, over the window's wall time (host clock)."""


def read(run):
    return run.win["images"] / run.win["wall_s"] if run.win["images"] else None
