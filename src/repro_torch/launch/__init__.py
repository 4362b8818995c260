"""Launchers: serving and training."""
