"""Launchers: serve-step builders (``serve``)."""
