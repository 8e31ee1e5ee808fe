"""The engine's synchronised `denoise` phase per transition, in s
(last_report.phases, summed over the window)."""


def read(run):
    if not run.records:
        return None
    return sum(r.denoise_s for r in run.records) / len(run.records)
