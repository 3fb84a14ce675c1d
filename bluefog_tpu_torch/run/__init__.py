"""Launcher pieces of the port (the scale file)."""
