"""Share of the H100's roofline that the engine's device work reaches:
the least time of the inference work of the rows the engine served
(``work.inference_work``: from the configuration and the rows alone)
over the summed device time of the compute operations in the traced
window (copies and memsets left out)."""

from tmbench.work import inference_work


def read(run):
    if not run.events:
        return None
    compute = sum(e.end - e.start for e in run.events if not e.is_memory)
    if compute <= 0:
        return None
    return 100.0 * inference_work(run.config, run.served["rows"])["seconds"] / compute
