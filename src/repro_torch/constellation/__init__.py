"""Orbits, links, contact plans and scenarios (numpy only)."""
