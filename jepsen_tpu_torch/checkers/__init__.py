"""Checkers: the device half of the Elle list-append check."""
