"""Entry points run with ``python -m``: `serve` (``--arch suffix-array``)."""
