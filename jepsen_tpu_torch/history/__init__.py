"""History layouts (the port's copy of what the checkers need)."""
