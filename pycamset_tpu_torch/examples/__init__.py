"""Handlers that extend the package's own: the two-target calibrators of
``extend_param_handler``."""
