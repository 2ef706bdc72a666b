"""call_ms_p95: the 95th percentile of the synchronised wall time of every
call in the window, in ms (host clock); none below 20 calls, where fewer
than one call lies past it."""
import statistics


def read(run):
    if len(run.call_s) < 20:
        return None
    return 1e3 * statistics.quantiles(run.call_s, n=20,
                                      method="inclusive")[18]
