"""Command-line entry points: testing (evaluation) and inference (serving)."""
