"""Utilities: configuration, logging, timing."""
