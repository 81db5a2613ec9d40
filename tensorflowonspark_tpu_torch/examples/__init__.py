"""Runnable entry points of the port (``python -m ...examples.<name>``)."""
