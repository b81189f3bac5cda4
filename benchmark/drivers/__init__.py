"""Drivers by traffic kind: ``serve`` and ``train``."""
