"""Logs, metric streams and running meters of the trainers."""
