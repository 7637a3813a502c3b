"""Frozen numpy generators of the cells' inputs."""
