"""Command-line scripts of the port (run them with ``python -m``)."""
