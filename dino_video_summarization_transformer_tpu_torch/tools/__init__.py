"""Tools of the port, run as ``python -m`` modules; nothing runs at import."""
