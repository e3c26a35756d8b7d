"""Utilities of the port: timers and nested-dict tree helpers."""
