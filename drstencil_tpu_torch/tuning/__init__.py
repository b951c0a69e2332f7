"""The kernel experiments — ports of the repository's ``tuning/exp_*.py``."""
