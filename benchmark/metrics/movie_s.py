"""Seconds per movie transition: the window's wall over the movie
transitions completed in it, each complete when `run_movie_transition`
returns with its MP4 closed (the one in flight at the end finishes and
counts)."""
from benchmark.metrics.transition_s import read  # noqa: F401  (the same quotient, another product)
