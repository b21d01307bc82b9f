"""pma.share: the share of the window's wall time inside the PMA sub-loop:
a CUDA-event span around ``models.droplet.loop_pma``, summed over the
window, over the window's host-clock time."""


def read(run):
    span = run.spans.get("pma")
    return span[1] / (run.window_s * 1e3) if span and span[0] and run.window_s else None
