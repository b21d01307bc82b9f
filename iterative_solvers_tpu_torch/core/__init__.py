from .grid import Grid2D, square  # noqa: F401
