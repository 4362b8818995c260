"""Launchers: serving."""
