"""Structured logging for tpulmi_torch: configure once, hand out
per-component loggers."""

import logging

_FORMAT = "[%(asctime)s][%(levelname)-5.5s][%(name)-.24s] %(message)s"
_configured = False


def _configure_once(level: int = logging.INFO) -> None:
    global _configured
    if not _configured:
        logging.basicConfig(level=level, format=_FORMAT)
        _configured = True


def get_logger(name: str) -> logging.Logger:
    """Return a configured logger for a component."""
    _configure_once()
    return logging.getLogger(name)
