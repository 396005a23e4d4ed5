"""Entry points: the serving driver."""
