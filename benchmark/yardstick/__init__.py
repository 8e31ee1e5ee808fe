"""Peaks, operation counts and the work a transition needs."""
