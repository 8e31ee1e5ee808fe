"""The engine's `movie_write` phase per transition, in s (the writer:
J1-J3 on the card, the muxer; last_report.phases)."""


def read(run):
    movies = [r.movie_write_s for r in run.records if r.movie_write_s is not None]
    return sum(movies) / len(movies) if movies else None
