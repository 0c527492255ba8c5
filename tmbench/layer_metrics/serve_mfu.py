"""Share of the H100's peak that the whole served path reaches: the least
time of the inference work of the rows completed in the window over the
window's length.  It bounds every kernel's share, also after a kernel
has left the path."""

from tmbench.work import inference_work


def read(run):
    if run.device.type != "cuda":
        return None
    rows = sum(r.n for r in run.done)
    return 100.0 * inference_work(run.config, rows)["seconds"] / run.seconds
