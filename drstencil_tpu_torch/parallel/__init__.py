"""Spatial domain decomposition over several devices with halo exchange."""
