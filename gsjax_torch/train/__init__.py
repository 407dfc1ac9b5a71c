"""Render helpers, budget probe and scene loading."""
