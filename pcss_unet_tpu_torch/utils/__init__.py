"""Utilities the port needs so far (logging)."""
