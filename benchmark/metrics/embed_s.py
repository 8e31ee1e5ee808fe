"""Text conditioning per transition, in s: the benchmark's host span
around set_negative_prompt and set_prompt1/2 (both CLIP towers), ending in
a device synchronize."""


def read(run):
    if not run.records:
        return None
    return sum(r.embed_s for r in run.records) / len(run.records)
